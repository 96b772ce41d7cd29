"""Checkpoint I/O of the port: async writer and sharded checkpoints."""
