"""The least time the card could take over the time it took, in %.

The least time moves each field's raw float32 bytes once and its stored
form once (in one direction or the other) at the published HBM rate;
the time taken is the summed duration of every device operation of the
window.  No implementation can move less, so no fused or rewritten
kernel pushes the share past 100%."""
from portbench import peaks


def read(rec):
    t = rec.trace
    if t is None or not t.device or None in rec.stored_bytes:
        return None
    least_s = (sum(rec.field_bytes) + sum(rec.stored_bytes)) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / (t.device_us() * 1e-6)
