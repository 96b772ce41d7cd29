"""Distribution helpers of the port (only the shard planner so far)."""
