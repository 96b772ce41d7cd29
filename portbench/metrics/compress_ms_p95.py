"""95th percentile of the per-field latency over every field of the
window: what a simulation step waits for one field to be compressed."""
import statistics


def read(rec):
    if len(rec.latencies_s) < 2:
        return None
    return statistics.quantiles(rec.latencies_s, n=100)[94] * 1e3
