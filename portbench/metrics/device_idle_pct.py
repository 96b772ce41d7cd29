"""Share of the traced window in which no kernel, copy or memset ran on
the card (the window less the union of the device intervals)."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or t.window_us() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us())
