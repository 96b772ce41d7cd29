"""The `cuszi-nyx.decompress` cell: found by name with the pieces a cell
needs, sound and control runs at a small size, and, on the card, a traced
run that reports the interpolation levels' metrics."""
import json

import pytest

from conftest import DEVICES, ROOT
from portbench import harness
from portbench.control import Control

CELL = "cuszi-nyx.decompress"
SMALL = {"shape": [40, 48, 56]}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LEVEL_METRICS = ("interp_roofline_pct.decompress",
                 "interp_torch_ms.decompress")


def run(device, traced=False, program=harness.Port, seed=2 ** 31 + 29):
    return harness.run(CELL, seed, 0.3, traced, device=device,
                       program=program, config=SMALL, emit=lambda d: None)


def test_the_cell_resolves_and_reports():
    c = harness.resolve(CELL)
    assert c.config["codec"] == "cusz-i" and c.traffic["direction"] == \
        "decompress"
    assert c.reference.LIMITS == harness.load_module("reference",
                                                     "cusz").LIMITS
    nyx = harness.load_json("configs", "cusz-nyx")
    for key in ("shape", "dtype", "generator", "generator_params",
                "codec_params", "guarantee"):
        assert c.config[key] == nyx[key], key
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, CELL, False)}
    assert {"decompress_GBps", "setup_s"} <= e2e
    per_layer = [m["name"] for m in harness.cell_metrics(BENCH, CELL, True)]
    nyx_layer = {m["name"] for m in
                 harness.cell_metrics(BENCH, "cusz-nyx.decompress", True)}
    assert nyx_layer | set(LEVEL_METRICS) <= set(per_layer)
    for name in per_layer:
        assert callable(harness.reader(name).read)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_sound_runs_are_correct_and_the_control_is_not(device):
    r = run(device)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["recon_mismatch"]["value"] == 0
    r = run(device, program=Control)
    assert r["correct"] is False
    for c in r["checks"].values():
        assert c["value"] > c["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda"], indirect=True)
def test_a_traced_run_reports_the_levels(device):
    r = run(device, traced=True)
    assert r["correct"] is True
    got = r["metrics"]
    for name in [m["name"] for m in harness.cell_metrics(BENCH, CELL, True)]:
        assert name in got, name
    assert 0 < got["interp_roofline_pct.decompress"]["value"] <= 100
    assert got["interp_torch_ms.decompress"]["value"] > 0
