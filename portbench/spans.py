"""The program's own spans in a traced run, and the window's device idle
time split among the port's host layers by them.

The port marks its host layers in the profiler's trace
(`repro_torch.perf.trace`): `codec.*` around a codec's encode and the
registry's decode, `stage.*` around each stage of the compressor, and
`dispatch.<kernel>` around each kernel's dispatching wrapper.  A span is
a ``user_annotation`` event of the thread that ran the window; only those
that start inside the window count (the traced drive's untimed first call
runs before it).

`idle_split` cuts the window's idle time (the window less `Trace.busy`)
at every span boundary and gives each piece to the layer of the innermost
program span open over it, or to `OUTSIDE` where none is: the harness,
and the program's entry before its first span.  The pieces add up to the
idle time exactly; no piece is labelled by a midpoint.  A trace with no
program span, as a program without them gives, has no split (None).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from portbench.tracefile import Event, Trace

#: the port's host layers, as the prefixes of their span names
LAYERS = ("codec", "stage", "dispatch")
OUTSIDE = "outside"
PREFIXES = tuple(f"{layer}." for layer in LAYERS)


def program_spans(trace: Trace) -> List[Event]:
    """The program's spans that start inside the window, in the order of
    `Trace.host` (start, then the longer first)."""
    if trace.window is None:
        return []
    w0, w1 = trace.window
    return [e for e in trace.host
            if e.cat == "user_annotation" and e.name.startswith(PREFIXES)
            and w0 <= e.ts < w1]


def idle_intervals(trace: Trace) -> List[List[float]]:
    """The window less the union of the device intervals."""
    if trace.window is None:
        return []
    w0, w1 = trace.window
    out, t = [], w0
    for a, b in trace.busy():
        if a > t:
            out.append([t, a])
        t = max(t, b)
    if w1 > t:
        out.append([t, w1])
    return out


def idle_split(trace: Trace) -> Optional[Dict[str, float]]:
    """Device idle microseconds of the window by layer (`LAYERS` and
    `OUTSIDE`), or None where the trace holds no program span."""
    spans = program_spans(trace)
    if not spans:
        return None
    w0, w1 = trace.window
    cuts = sorted({w0, w1} | {min(max(t, w0), w1)
                              for e in spans for t in (e.ts, e.end)})
    idle = idle_intervals(trace)
    out = dict.fromkeys(LAYERS + (OUTSIDE,), 0.0)
    open_: List[Event] = []
    k = i = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(spans) and spans[k].ts <= a:
            open_.append(spans[k])
            k += 1
        open_ = [e for e in open_ if e.end > a]
        # the innermost open span started last (`open_` keeps start order)
        layer = open_[-1].name.split(".", 1)[0] if open_ else OUTSIDE
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            out[layer] += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    return out


def idle_ms_per_field(rec, layer: str) -> Optional[float]:
    """Device idle milliseconds per field under `layer`'s spans."""
    t = rec.trace
    if t is None or not t.device or not t.n_fields:
        return None
    split = idle_split(t)
    return None if split is None else split[layer] / t.n_fields / 1e3
