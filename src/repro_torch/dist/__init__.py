"""Distribution helpers of the port: shard planning, the single-process
distribution context, fault detection and mitigation (`fault`) and
seeded fault injection (`chaos`)."""
