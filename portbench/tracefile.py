"""What a traced run reads from the profiler: the device operations of
the window and the host calls around them.

A traced run wraps each field in two spans of its own: `FIELD_SPAN`
around the program's call and the harness's synchronize after it, and
`CALL_SPAN` around the call alone.  The window runs from the start of
the first field to the end of the last.  `Trace` takes the complete
("X") events of the Chrome trace that `torch.profiler` exports, keeps
those of the thread that ran the window and the device operations that
started inside it, and answers the questions the metric readers ask.
Times are microseconds, as the trace gives them.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

FIELD_SPAN = "portbench.field"
CALL_SPAN = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
#: the namespaces of PyTorch's own operators
TORCH_OP_PREFIXES = ("aten::", "c10d::", "prims::")
NAME_CHARS = 96


class Event:
    __slots__ = ("cat", "name", "ts", "end", "tid", "corr")

    def __init__(self, e: dict):
        self.cat = e.get("cat", "")
        self.name = e.get("name", "")
        self.ts = float(e["ts"])
        self.end = self.ts + float(e.get("dur", 0.0))
        self.tid = e.get("tid")
        args = e.get("args") or {}
        self.corr = args.get("correlation")

    @property
    def dur(self) -> float:
        return self.end - self.ts


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(starts: List[float], spans: List[List[float]], t: float
            ) -> bool:
    """Whether `t` lies in one of the sorted, disjoint `spans`."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]


class Trace:
    def __init__(self, raw_events: Iterable[dict]):
        events = [Event(e) for e in raw_events if e.get("ph") == "X"]
        fields = sorted((e for e in events if e.name == FIELD_SPAN),
                        key=lambda e: e.ts)
        self.n_fields = len(fields)
        self.window: Optional[Tuple[float, float]] = (
            (fields[0].ts, fields[-1].end) if fields else None)
        tid = fields[0].tid if fields else None
        self.host = sorted((e for e in events
                            if e.cat in HOST_CATS and e.tid == tid),
                           key=lambda e: (e.ts, -e.end))
        w0, w1 = self.window or (0.0, 0.0)
        self.device = [e for e in events
                       if e.cat in DEVICE_CATS and w0 <= e.ts < w1]
        self._launch = {e.corr: e for e in events
                        if e.cat in ("cuda_runtime", "cuda_driver")
                        and e.corr is not None}
        ops = _union((e.ts, e.end) for e in self.host
                     if e.cat == "cpu_op"
                     and e.name.startswith(TORCH_OP_PREFIXES))
        self._ops, self._op_starts = ops, [a for a, _ in ops]
        calls = _union((e.ts, e.end) for e in self.host
                       if e.name == CALL_SPAN)
        self._calls, self._call_starts = calls, [a for a, _ in calls]

    @staticmethod
    def load(path: Path) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f).get("traceEvents", []))

    # -- the device --------------------------------------------------------
    def busy(self) -> List[List[float]]:
        """The union of the device operations' intervals, cut to the
        window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        return [[max(a, w0), min(b, w1)]
                for a, b in _union((e.ts, e.end) for e in self.device)
                if min(b, w1) > max(a, w0)]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def own_kernel(self, e: Event) -> bool:
        """A kernel of the program's own: one whose launch ran outside
        every PyTorch operator (the port launches its kernels itself;
        PyTorch's and its libraries' kernels launch inside an operator)."""
        if e.cat != "kernel":
            return False
        launch = self._launch.get(e.corr)
        return launch is not None and not _inside(
            self._op_starts, self._ops, launch.ts)

    def device_us(self, own: Optional[bool] = None) -> float:
        """Summed duration of the window's device operations: all of them,
        or only the program's own kernels (`own=True`) or all the rest."""
        return sum(e.dur for e in self.device
                   if own is None or self.own_kernel(e) == own)

    # -- the host ----------------------------------------------------------
    def host_syncs(self) -> int:
        """Blocking runtime calls made inside the program's calls."""
        return sum(1 for e in self.host
                   if e.name in SYNC_CALLS
                   and _inside(self._call_starts, self._calls, e.ts))

    # -- breakdown ---------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.name[:NAME_CHARS]] += e.dur
        return [[k, v * 1e-6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time of the device inside the window, summed by the host
        call that was running at each gap's middle (the innermost; a
        runtime call is named with the operator around it)."""
        if self.window is None:
            return []
        edges = [self.window[0]]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = sorted(((edges[i] + edges[i + 1]) / 2, edges[i + 1] - edges[i])
                      for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i])
        tot: Dict[str, float] = defaultdict(float)
        stack: List[Event] = []
        k = 0
        for mid, length in gaps:
            while k < len(self.host) and self.host[k].ts <= mid:
                e = self.host[k]
                while stack and stack[-1].end <= e.ts:
                    stack.pop()
                stack.append(e)
                k += 1
            while stack and stack[-1].end <= mid:
                stack.pop()
            tot[self._label(stack)] += length
        return [[k_, v * 1e-6] for k_, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _label(stack: List[Event]) -> str:
        if not stack:
            return "harness, between fields"
        top = stack[-1]
        if top.cat in ("cuda_runtime", "cuda_driver"):
            ops = [e for e in stack[:-1] if e.cat == "cpu_op"]
            if ops:
                return f"{ops[-1].name[:NAME_CHARS]}/{top.name}"
        return top.name[:NAME_CHARS]
