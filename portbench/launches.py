"""The window's device operations by the program span their launch ran
inside.

A device operation (kernel, copy, memset) and the runtime call that
launched it carry one correlation id in the trace, which is how
`Trace.own_kernel` finds a kernel's launch too.  `inside_span` keeps the
operations whose launch lies inside a span of one name: the torch work of
one stage, or the kernels of one dispatching wrapper.
"""
from __future__ import annotations

from typing import List, Optional

from portbench.tracefile import Event, Trace, _inside, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def inside_span(trace: Trace, name: str) -> Optional[List[Event]]:
    """The window's device operations whose launch ran inside a span
    `name` that started in the window; None where no such span did (a
    program that does not mark it)."""
    if trace.window is None:
        return None
    w0, w1 = trace.window
    spans = _union((e.ts, e.end) for e in trace.host
                   if e.cat == "user_annotation" and e.name == name
                   and w0 <= e.ts < w1)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    launch = {e.corr: e for e in trace.host
              if e.cat in LAUNCH_CATS and e.corr is not None}
    return [e for e in trace.device
            if e.corr in launch and _inside(starts, spans, launch[e.corr].ts)]
