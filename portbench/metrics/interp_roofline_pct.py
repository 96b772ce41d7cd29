"""The least time the interpolation levels of the window's decodes could
take over the summed device time of the program's own kernels
(`Trace.own_kernel`) launched inside a `dispatch.interp.reconstruct`
span, in %.

The levels rebuild every value of a field but its anchor grid.  The
least they can move is each such value's residual, read once, and the
value, written once: 8 B a value at the published HBM rate.  The anchor
grid has at most 4 values an axis, so at most 64 in a field of up to
three axes; counting `n - 64` of a field's `n` values therefore never
counts more than the levels rebuild, and is exact on 512^3 (a 4 x 4 x 4
anchor).  No implementation moves less, so a kernel that fuses the levels
cannot pass 100%; the per-level kernel reads the padded even row and the
residual and writes the value, about 12 B a value, so it reaches at most
about 67%."""
from portbench import launches, peaks

SPAN = "dispatch.interp.reconstruct"
#: the most anchor values a field of up to three axes keeps
ANCHOR_VALUES = 64
#: a residual read and a value written, int32 / float32
BYTES_PER_VALUE = 8


def rebuilt_values(field_bytes: int) -> int:
    """The values the levels rebuild in a float32 field of `field_bytes`,
    counted as the module's description says."""
    return field_bytes // 4 - ANCHOR_VALUES


def read(rec):
    t = rec.trace
    if t is None or not t.device:
        return None
    ops = launches.inside_span(t, SPAN)
    kernel_us = sum(e.dur for e in ops or () if t.own_kernel(e))
    if kernel_us <= 0:
        return None
    least_s = BYTES_PER_VALUE * sum(rebuilt_values(b)
                                    for b in rec.field_bytes) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / (kernel_us * 1e-6)
