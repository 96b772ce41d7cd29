"""The benchmark's pieces of the `cuszi-nyx` configuration on the CPU.

The plain reference `portbench/reference/cusz-i.py` against the port's
cusz-i codec: containers bit for bit, stored bytes, reconstructions.  The
reference one precision lower (PREQUANT and dequant in bfloat16, the
benchmark's control) fails the cell's check.  The two readers of the
interpolation levels (`interp_roofline_pct`, `interp_torch_ms`) on traces
built by hand, and the count of values the roofline's reader takes a
field's levels to rebuild.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, harness, peaks
from portbench.tracefile import CALL_SPAN, FIELD_SPAN, Trace
from repro_torch import codecs
from repro_torch.core import interp
from repro_torch.data import scidata

R = harness.load_module("reference", "cusz-i")
PARAMS = harness.load_json("configs", "cuszi-nyx")["codec_params"]
CELL = "cuszi-nyx.decompress"


def fields():
    yield "cube", scidata.nyx_like((32, 32, 32), seed=3, device="cpu")
    yield "ragged", scidata.nyx_like((21, 33, 47), seed=5, device="cpu")
    yield "ragged-thin", scidata.nyx_like((9, 5, 13), seed=6, device="cpu")
    yield "2d", scidata.nyx_like((1, 37, 53), seed=7, device="cpu")[0]
    yield "1d", torch.from_numpy(scidata.hacc_like(n=30001, seed=1))


CASES = [(name, x, eb) for name, x in fields() for eb in (1e-4, 1e-5)]


@pytest.mark.parametrize("name,x,eb", CASES,
                         ids=[f"{n}-{eb:g}" for n, _, eb in CASES])
def test_reference_matches_the_port(name, x, eb):
    params = {**PARAMS, "eb": eb}
    port = harness.Port(harness.Cell("t", {"codec": "cusz-i",
                                           "codec_params": params},
                                     {}, None, R))
    c = port.encode(x)
    h_got, p_got = port.container(c)
    h_want, p_want = R.compress(x, params)
    assert h_want["predictor"] == "interp"
    assert harness.header_mismatch(h_got, h_want) == 0
    assert harness.payload_mismatch(p_got, p_want) == 0
    assert R.stored_nbytes(p_want) == codecs.get("cusz-i").pack(c).nbytes
    y = port.decode(c)
    want = R.reconstruct(x, params)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    tol = R.tolerance(x, R.resolve_eb(x, params))
    assert float((y - x).abs().max()) <= tol


def test_the_reference_covers_what_it_describes():
    """The plan halves each axis longer than 4 in turn; a field with no
    such axis is refused rather than planned another way."""
    for shape in [(32, 32, 32), (21, 33, 47), (9, 5, 13), (37, 53),
                  (30001,)]:
        steps, anchor = R.level_plan(shape)
        assert (tuple(steps), anchor) == interp.interp_plan(shape)
    with pytest.raises(ValueError):
        R.level_plan((4, 3, 2))


def small_cell():
    """The cell at a small size, its snapshots and the check of each
    direction, as `harness.run` makes them (without the timed loop, whose
    run refuses to report in a process that holds the JAX package)."""
    cell = harness.resolve(CELL, {"shape": [24, 40, 48]})
    inputs = cell.generator.snapshots(cell.config, 2 ** 31 + 11, "cpu")

    def checks(program):
        made = [program.encode(x) for x in inputs]
        kept = [program.decode(program.stored(c)) for c in made]
        return (harness.check(cell, program.container, inputs, made,
                              "compress"),
                harness.check(cell, program.container, inputs, kept,
                              "decompress"))
    return cell, checks


def test_the_bfloat16_control_fails_the_check():
    cell, checks = small_cell()
    compress, decompress = checks(control.Control(cell))
    assert not harness.passed(decompress)
    assert decompress["recon_mismatch"][0] > 0
    assert decompress["bound_excess"][0] > 1
    assert compress["container_mismatch"][0] > 0
    assert compress["stored_bytes_gap"][0] > 0


def test_the_cells_check_passes_the_port_at_a_small_size():
    cell, checks = small_cell()
    for got in checks(harness.Port(cell)):
        assert harness.passed(got)
        assert all(v == 0 for k, (v, _) in got.items()
                   if k != "bound_excess")


# ---------------------------------------------------------------------------
# The readers of the interpolation levels
# ---------------------------------------------------------------------------

ROOFLINE = harness.reader("interp_roofline_pct.decompress")
TORCH_MS = harness.reader("interp_torch_ms.decompress")


@pytest.mark.parametrize("shape", [(512, 512, 512), (21, 33, 47),
                                   (37, 53), (280953867,), (1800, 3600)])
def test_the_roofline_never_counts_more_than_the_levels_rebuild(shape):
    """Exact on the cell's 512^3; a lower bound on any field of up to
    three axes, so the share cannot pass 100% by the count."""
    n = int(np.prod(shape))
    steps, anchor = interp.interp_plan(shape)
    rebuilt = n - int(np.prod(anchor))
    got = ROOFLINE.rebuilt_values(4 * n)
    if shape == (512, 512, 512):
        assert len(steps) == 21 and anchor == (4, 4, 4)
        assert got == rebuilt
    assert got <= rebuilt


def X(cat, name, ts, end, corr=None, tid=1, pid=100):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def U(name, ts, end):
    return X("user_annotation", name, ts, end)


def L(ts, corr):
    return X("cuda_runtime", "cudaLaunchKernel", ts, ts + 1, corr)


def D(cat, ts, end, corr):
    return X(cat, "op", ts, end, corr, tid=7, pid=0)


LEVELS, DISPATCH = "stage.interp.levels", "dispatch.interp.reconstruct"
# two fields, microseconds: in each, a torch kernel before the level loop
# (codes to deltas), then in the loop a torch copy, the port's interp
# kernel and a torch interleave; after the loop a torch kernel (dequant)
EVENTS = [
    U(LEVELS, -40, -20), U(DISPATCH, -35, -30), L(-34, 90),   # untimed
    D("kernel", -33, -25, 90),
    U(FIELD_SPAN, 0, 100), U(CALL_SPAN, 0, 90),
    X("cpu_op", "aten::where", 2, 6), L(3, 1), D("kernel", 5, 9, 1),
    U("stage.reconstruct", 10, 80),
    U(LEVELS, 12, 70),
    X("cpu_op", "aten::reshape", 13, 17), L(14, 2),
    D("kernel", 15, 20, 2),
    U(DISPATCH, 20, 30), L(25, 3), D("kernel", 26, 36, 3),
    X("cpu_op", "aten::copy_", 40, 48), L(41, 4),
    D("gpu_memcpy", 42, 49, 4),
    X("cpu_op", "aten::mul", 72, 76), L(73, 5), D("kernel", 74, 79, 5),
    U(FIELD_SPAN, 100, 200), U(CALL_SPAN, 100, 190),
    U("stage.reconstruct", 110, 180),
    U(LEVELS, 112, 170),
    X("cpu_op", "aten::cat", 113, 117), L(114, 6),
    D("kernel", 115, 118, 6),
    U(DISPATCH, 120, 130), L(125, 7), D("kernel", 126, 150, 7),
]
#: the torch work in the loop: (20 - 15) + (49 - 42) + (118 - 115) us
TORCH_US = 5 + 7 + 3
#: the port's kernels in a dispatch span inside the window: 10 + 24 us
KERNEL_US = 10 + 24


def record(events, field_bytes=(4 * 512 ** 3, 4 * 512 ** 3)):
    return harness.Record(
        setup_s=1.0, window_s=2e-4, latencies_s=[1e-4, 1e-4],
        field_bytes=list(field_bytes), stored_bytes=[1000, 1000],
        snapshot_raw=[4000], snapshot_stored=[1000], trace=Trace(events))


def test_interp_torch_ms_on_a_hand_built_trace():
    assert TORCH_MS.read(record(EVENTS)) == pytest.approx(TORCH_US / 2 / 1e3)


def test_interp_roofline_on_a_hand_built_trace():
    least_s = 8 * 2 * (512 ** 3 - 64) / peaks.HBM_BYTES_PER_S
    assert ROOFLINE.read(record(EVENTS)) == pytest.approx(
        100 * least_s / (KERNEL_US * 1e-6))


def test_the_readers_return_none_without_their_spans():
    without = [e for e in EVENTS if e["name"] not in (LEVELS, DISPATCH)]
    before_only = [e for e in EVENTS if e["name"] not in (LEVELS, DISPATCH)
                   or e["ts"] < 0]
    no_device = [e for e in EVENTS if e["pid"] != 0]
    for events in (without, before_only, no_device, []):
        for reader in (ROOFLINE, TORCH_MS):
            assert reader.read(record(events)) is None
    rec = record(EVENTS)
    rec.trace = None
    assert ROOFLINE.read(rec) is None and TORCH_MS.read(rec) is None
