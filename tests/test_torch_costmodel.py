"""The port's analytic cost model (`repro_torch.perf.costmodel`) against
the reference's (`repro.perf.costmodel`), on the CPU.

Every total and breakdown entry must equal the reference's exactly (the
same float operations in the same order), and `CellCost.terms` under the
reference's own constants must give the reference's terms.  The port's
source holds only the H100's constants; the reference's are read from
its module at run time.
"""
from __future__ import annotations

import importlib

import pytest

from repro_torch import configs as tconfigs
from repro_torch.perf import costmodel as TC

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: the knobs, each on the cells it changes
KNOBS = ([{"grad_compress": g} for g in ("none", "int16", "int8")]
         + [{"weight_compress": "int8"}, {"kv_compress": True},
            {"a2a_compress": "int8"}]
         + [{"microbatches": m} for m in (1, 4, 8)])
KNOB_ARCHS = ("qwen3-32b", "deepseek-v2-236b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def ref():
    """`repro.perf.costmodel`, imported on first use.  `repro.perf`
    reaches `repro.dist`, whose `chaos` module the checkout lacks: the
    first import fails and leaves the partly initialised modules behind,
    and the second succeeds.  Hence one retry."""
    try:
        return importlib.import_module("repro.perf.costmodel")
    except ImportError:
        return importlib.import_module("repro.perf.costmodel")


def _same(port, want):
    assert port.flops == want.flops
    assert port.hbm_bytes == want.hbm_bytes
    assert port.coll_bytes == want.coll_bytes
    assert port.breakdown == want.breakdown
    assert list(port.breakdown) == list(want.breakdown)


def _ref_hw(ref):
    return TC.Hardware(ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_cell_cost_equals_reference(ref, arch, shape, multi_pod):
    port = TC.cell_cost(arch, shape, multi_pod)
    want = ref.cell_cost(arch, shape, multi_pod)
    _same(port, want)
    assert port.terms(_ref_hw(ref)) == want.terms()


@pytest.mark.parametrize("knobs", KNOBS,
                         ids=lambda k: "-".join(f"{a}={b}"
                                                for a, b in k.items()))
@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k",
                                   "decode_32k"))
@pytest.mark.parametrize("arch", KNOB_ARCHS)
def test_knobs_equal_reference(ref, arch, shape, knobs):
    port = TC.cell_cost(arch, shape, True, **knobs)
    want = ref.cell_cost(arch, shape, True, **knobs)
    _same(port, want)
    assert port.terms(_ref_hw(ref)) == want.terms()
    got = TC.summarize(arch, shape, True, hw=_ref_hw(ref), **knobs)
    assert got == ref.summarize(arch, shape, True, **knobs)


def test_terms_default_to_the_h100():
    c = TC.cell_cost("qwen3-4b", "decode_32k", False)
    t = c.terms()
    assert t["compute_s"] == c.flops / 989e12
    assert t["memory_s"] == c.hbm_bytes / 3.35e12
    assert t["collective_s"] == c.coll_bytes / 450e9
    assert t["bound_s"] == t[t["dominant"]] == max(
        t["compute_s"], t["memory_s"], t["collective_s"])


def test_one_source_of_the_card_constants():
    """The dry run and chip_smoke's bounds take the cost model's
    constants."""
    from repro_torch.launch import dryrun

    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW) == \
        (TC.PEAK_FLOPS, TC.HBM_BW, TC.NVLINK_BW) == tuple(TC.H100)


# the reference's two properties (tests/test_dist_and_io.py::TestCostModel)
# on the port

def test_terms_positive_and_shapes():
    for arch in ("qwen3-32b", "deepseek-v2-236b", "mamba2-1.3b",
                 "jamba-1.5-large-398b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            c = TC.cell_cost(arch, shape, multi_pod=False, microbatches=4)
            assert c.flops > 0 and c.hbm_bytes > 0 and c.coll_bytes >= 0


def test_int8_pod_sync_cheaper():
    a = TC.cell_cost("qwen3-32b", "train_4k", True, 8, "none")
    b = TC.cell_cost("qwen3-32b", "train_4k", True, 8, "int8")
    assert b.breakdown["coll_pod"] < a.breakdown["coll_pod"] / 3.5
