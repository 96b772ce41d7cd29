"""Raw float32 bytes of all fields reconstructed in the window over the
window's wall seconds (host clock, each call ending in a synchronize)."""


def read(rec):
    if not rec.latencies_s or rec.window_s <= 0:
        return None
    return sum(rec.field_bytes) / rec.window_s / 1e9
