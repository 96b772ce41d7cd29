"""The benchmark's harness: it finds a cell's pieces by name, makes the
inputs from the seed, drives the program over the cell's traffic for the
window, checks what the window produced against the plain reference,
and reads the metrics.

Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by the name that `BENCHMARK.json` or
the cell gives:

  workloads/<cell>.json    the cell's configuration and traffic
  configs/<config>.json    the field's sizes, generator and codec
  traffic/<mix>.json       the direction of the loop
  inputs/<generator>.py    `snapshots(config, seed, device)`
  reference/<codec>.py     the plain reference and its check limits
  metrics/<metric>.py      `read(record)`; a reader may serve every
                           metric whose name starts with its own and a dot

The program under test is the port's codec registry
(`repro_torch.codecs`); the harness takes from it only the codec's
encode and decode and its kernel launch counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import peaks, timing
from portbench.tracefile import CALL_SPAN, FIELD_SPAN, Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules a run may not hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro")
#: rounds over every snapshot before the window
WARMUP_ROUNDS = 2


class Refused(SystemExit):
    """A run that may print no result."""


# ---------------------------------------------------------------------------
# Finding the pieces by name
# ---------------------------------------------------------------------------

def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = "portbench_" + "".join(
        c if c.isalnum() else "_" for c in f"{kind}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of `metric`: metrics/<metric>.py, else the file named
    by the part before its first dot (`torch_ops_ms.compress` ->
    metrics/torch_ops_ms.py)."""
    if (HERE / "metrics" / f"{metric}.py").exists():
        return load_module("metrics", metric)
    return load_module("metrics", metric.split(".")[0])


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    generator: object
    reference: object


def resolve(name: str, config: Optional[dict] = None) -> Cell:
    """The cell `name` from its workload file; `config` overrides keys of
    its configuration (the tests run cells at small sizes)."""
    w = load_json("workloads", name)
    cfg = {**load_json("configs", w["config"]), **(config or {})}
    return Cell(name, cfg, load_json("traffic", w["traffic"]),
                load_module("inputs", cfg["generator"]),
                load_module("reference", cfg["codec"]))


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of `cell` reports: with `traced`, the per-layer
    ones, else the end-to-end ones.  A metric with a `workloads` key is
    reported in the cells it lists; a per-layer metric without one in
    every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


# ---------------------------------------------------------------------------
# The program under test, and the shape in which the check reads it
# ---------------------------------------------------------------------------

def _plain(v):
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


class Port:
    """A codec of the port's registry, as a user calls it."""

    def __init__(self, cell: Cell):
        from repro_torch import codecs
        from repro_torch.kernels import dispatch

        self._codecs, self._dispatch = codecs, dispatch
        self.codec = codecs.get(cell.config["codec"],
                                **cell.config["codec_params"])

    def encode(self, x):
        return self.codec.encode(x)

    def decode(self, c):
        return self._codecs.decode(c)

    @staticmethod
    def stored(c):
        """`c` as a read from storage hands it over: the port caches a
        decode table by the identity of the stored code lengths, and a
        read unpacks new tensors, so the lengths (4 KiB) are new on every
        call and the tables are built as on every read."""
        return c.replace(payload={**c.payload,
                                  "lengths": c.payload["lengths"].clone()})

    @staticmethod
    def container(c):
        """(header fields, payload arrays) of a container."""
        h = c.header
        header = {"shape": list(h.shape), "dtype": h.dtype,
                  **{k: _plain(v) for k, v in h.params}}
        return header, dict(c.payload)

    def counters(self) -> Dict[str, int]:
        return self._dispatch.launch_counts()

    def reset_counters(self) -> None:
        self._dispatch.reset_launches()


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers read it."""
    setup_s: float
    window_s: float
    latencies_s: List[float]
    field_bytes: List[int]
    stored_bytes: List[Optional[int]]
    snapshot_raw: List[int]
    snapshot_stored: List[Optional[int]]
    trace: Optional[Trace]


def drive(call: Callable, work: list, order: List[int], seconds: float,
          traced: bool, sync: Callable, rnd: random.Random,
          hand: Callable = lambda w: w):
    """Call the program on `work` in `order`, round robin, one call at a
    time and each ending in `sync`, until `seconds` have passed and each
    snapshot has had a call; `hand` gives each call its item, outside the
    call's time.  Keeps, for each snapshot, the output of one call drawn
    uniformly from its calls (a reservoir of one).  Returns (calls as
    (snapshot, start, end), kept outputs, failed calls, the first
    failure)."""
    span = torch.profiler.record_function if traced \
        else (lambda _name: contextlib.nullcontext())
    kept: list = [None] * len(work)
    seen = [0] * len(work)
    calls, failed, first_error = [], 0, None
    begin = time.perf_counter()
    i = 0
    while True:
        s = order[i % len(order)]
        i += 1
        item = hand(work[s])
        t0 = time.perf_counter()
        try:
            with span(FIELD_SPAN):
                with span(CALL_SPAN):
                    out = call(item)
                sync()
        except RuntimeError as e:
            failed += 1
            first_error = first_error or repr(e)
            out = None
        t1 = time.perf_counter()
        if out is not None:
            calls.append((s, t0, t1))
            seen[s] += 1
            if rnd.randrange(seen[s]) == 0:
                kept[s] = out
        del out
        del item
        if t1 - begin >= seconds and i >= len(order):
            return calls, kept, failed, first_error


class Smi:
    """nvidia-smi sampling the card once a second beside the window."""
    QUERY = ("name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu")

    def __init__(self, active: bool):
        self.proc = None
        if active:
            try:
                self.proc = subprocess.Popen(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}",
                     "--format=csv,noheader", "-lms", "1000"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True)
            except OSError:
                self.proc = None

    def stop(self) -> List[str]:
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return [ln.strip() for ln in out.splitlines() if ln.strip()]


def traced_drive(name: str, on_cuda: bool, call: Callable, work: list,
                 order: List[int], seconds: float, sync: Callable,
                 rnd: random.Random, hand: Callable):
    """`drive` under `torch.profiler` (host calls, and the card's work
    where there is a card); returns its results and the `Trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        call(hand(work[order[0]]))       # outside the window's spans
        sync()
        out = drive(call, work, order, seconds, True, sync, rnd, hand)
    path = Path(tempfile.gettempdir()) / f"portbench-{name}-trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    trace = Trace.load(path)
    path.unlink()
    return out, trace


def chips_of(bench: dict, name: str) -> Optional[int]:
    return next((w["chips"] for w in bench["workloads"]
                 if w["name"] == name), None)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype in (torch.uint32,
                                              torch.float32) else t


def payload_mismatch(got: dict, want: dict) -> int:
    """Elements of the payload arrays that differ, bit for bit; an array
    missing on one side, or of another shape or dtype, counts whole."""
    n = 0
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None:
            n += (a if a is not None else b).numel()
        elif a.shape != b.shape or a.dtype != b.dtype:
            n += max(a.numel(), b.numel())
        else:
            n += int((_bits(a) != _bits(b).to(a.device)).sum())
    return n


def header_mismatch(got: dict, want: dict) -> int:
    return sum(1 for k in set(got) | set(want)
               if _plain(got.get(k)) != _plain(want.get(k)))


def check(cell: Cell, container, inputs: list, kept: list,
          direction: str) -> Dict[str, tuple]:
    """{number: (reading, limit)} of the outputs the window kept against
    the reference's, worked out again from the same inputs."""
    ref = cell.reference
    params = cell.config["codec_params"]
    if direction == "compress":
        mismatch = gap = 0
        for x, c in zip(inputs, kept):
            h_want, p_want = ref.compress(x, params)
            if c is None:
                mismatch += x.numel()
                gap += ref.stored_nbytes(p_want)
                continue
            h_got, p_got = container(c)
            mismatch += header_mismatch(h_got, h_want) \
                + payload_mismatch(p_got, p_want)
            gap += abs(ref.stored_nbytes(p_got) - ref.stored_nbytes(p_want))
            del p_want
        readings = {"container_mismatch": mismatch, "stored_bytes_gap": gap}
    else:
        mismatch, excess = 0, 0.0
        for x, y in zip(inputs, kept):
            want = ref.reconstruct(x, params)
            if y is None or y.shape != want.shape or y.dtype != want.dtype:
                mismatch += x.numel()
                excess = math.inf
                continue
            mismatch += int((_bits(y) != _bits(want)).sum())
            tol = ref.tolerance(x, ref.resolve_eb(x, params))
            excess = max(excess, float((y - x).abs().max()) / tol)
            del want
        readings = {"recon_mismatch": mismatch, "bound_excess": excess}
    return {k: (v, ref.LIMITS[k]) for k, v in readings.items()}


def passed(checks: Dict[str, tuple]) -> bool:
    # a NaN reading compares False, and fails
    return all(v <= lim for v, lim in checks.values())


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def _finite(v):
    return v if isinstance(v, int) or math.isfinite(v) else None


def run(name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        program=Port, config: Optional[dict] = None,
        emit: Callable[[dict], None] = lambda d: print(json.dumps(d),
                                                       flush=True)
        ) -> dict:
    """One run of the cell `name`: returns the result line's object.
    `program` builds the system under test from the cell (the port's
    codec; the control and the tests put another in its place)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(name, config)
    bench = benchmark()
    chips = chips_of(bench, name) or 1
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    direction = cell.traffic["direction"]

    marks = [("start", t_start), ("imports", time.perf_counter())]
    prog = program(cell)
    marks.append(("program", time.perf_counter()))
    inputs = cell.generator.snapshots(cell.config, seed, dev)
    sync()
    marks.append(("inputs", time.perf_counter()))
    n = len(inputs)
    first = seed % n
    order = [(first + i) % n for i in range(n)]
    raw = [x.numel() * x.element_size() for x in inputs]
    if direction == "compress":
        work, call, hand = inputs, prog.encode, (lambda x: x)
    else:
        work, call = [prog.encode(x) for x in inputs], prog.decode
        hand = prog.stored
        sync()
        marks.append(("containers", time.perf_counter()))
    for _ in range(WARMUP_ROUNDS):
        for s in order:
            call(hand(work[s]))
            sync()
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    prog.reset_counters()
    smi = Smi(on_cuda)
    rnd = random.Random(seed)
    try:
        if traced:
            (calls, kept, failed, error), trace = traced_drive(
                name, on_cuda, call, work, order, seconds, sync, rnd, hand)
        else:
            calls, kept, failed, error = drive(call, work, order, seconds,
                                               False, sync, rnd, hand)
            trace = None
        peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    finally:
        samples = smi.stop()
    counters = prog.counters()

    if direction == "compress":
        snap_stored = [None if c is None else
                       cell.reference.stored_nbytes(prog.container(c)[1])
                       for c in kept]
    else:
        snap_stored = [cell.reference.stored_nbytes(prog.container(c)[1])
                       for c in work]
    del work, call, hand
    t0 = time.perf_counter()
    checks = check(cell, prog.container, inputs, kept, direction)
    sync()
    reference_s = time.perf_counter() - t0
    del kept

    window_s = calls[-1][2] - calls[0][1] if calls else 0.0
    rec = Record(setup_s=setup_s, window_s=window_s,
                 latencies_s=[t1 - t0 for _, t0, t1 in calls],
                 field_bytes=[raw[s] for s, _, _ in calls],
                 stored_bytes=[snap_stored[s] for s, _, _ in calls],
                 snapshot_raw=raw, snapshot_stored=snap_stored, trace=trace)
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        v = reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    emit({"detail": "setup_s", **{phase: t - marks[i][1] for i, (phase, t)
                                  in enumerate(marks[1:])}})
    emit({"detail": "sizes", "field_bytes": raw, "l2_bytes": peaks.L2_BYTES,
          "field_over_l2": [b / peaks.L2_BYTES for b in raw]})
    emit({"detail": "card", "kind": torch.cuda.get_device_name(dev)
          if on_cuda else "cpu", "nvidia_smi": samples})
    emit({"detail": "window", "calls": len(calls), "failed": failed,
          "first_error": error, "seconds": window_s,
          "latency_ms_median": (sorted(rec.latencies_s)[len(calls) // 2]
                                * 1e3 if calls else None)})
    emit({"detail": "launches_per_field",
          **{k: v / max(len(calls), 1) for k, v in counters.items() if v}})
    emit({"detail": "reference", "what": "the plain reference on the "
          "run's device, every kept output", "seconds": reference_s,
          "per_field_s": reference_s / n})
    if on_cuda:
        emit({"detail": "yardstick_copy", "bytes_per_s":
              timing.copy_bytes_per_s(inputs[0]),
              "peak_bytes_per_s": peaks.HBM_BYTES_PER_S})

    found = banned_modules()
    if found:
        raise Refused(f"portbench: the run holds {found} in sys.modules; "
                      "it may import neither JAX nor the JAX package")
    dev_info = {"platform": "gpu" if on_cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_cuda
                else "cpu", "count": chips, "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and passed(checks),
              "attempted": len(calls) + failed, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace is not None:
        dev_info.update(busy_s=trace.busy_us() * 1e-6,
                        window_s=trace.window_us() * 1e-6)
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": _finite(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
