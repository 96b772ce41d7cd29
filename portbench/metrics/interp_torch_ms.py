"""Device milliseconds per field of the operations that are not the
program's own kernels (`Trace.own_kernel`) and whose launch ran inside
the interpolation predictor's level loop, the `stage.interp.levels` span:
each level's move of its axis last and the copy of its even rows, the
edge pad's concatenation, the interleave of evens and odds.  None where
the trace holds no such span, as a program without it gives."""
from portbench import launches

SPAN = "stage.interp.levels"


def read(rec):
    t = rec.trace
    if t is None or not t.device or not t.n_fields:
        return None
    ops = launches.inside_span(t, SPAN)
    if ops is None:
        return None
    return sum(e.dur for e in ops if not t.own_kernel(e)) / t.n_fields / 1e3
