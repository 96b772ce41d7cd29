"""Distribution helpers of the port: shard planning and the
single-process distribution context."""
