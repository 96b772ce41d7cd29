"""Data sources of the port: synthetic SDRBench-like fields (`scidata`)
and the synthetic LM token stream (`pipeline`)."""
