"""`BENCHMARK.json` against the benchmark contract's static rules, and
every cell's pieces found by name, a new cell's without an edit."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import CELLS, ROOT
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits in 12 hours
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            # every cell listed reports the end-to-end metric it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and "_roofline" in m["name"]
    every = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in every]
    assert len(set(names)) == len(names)
    for m in every:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = harness.load_json("workloads", cell)
    assert (w["config"], w["traffic"]) == (entry["config"],
                                           entry["traffic"])
    c = harness.resolve(cell)
    assert c.traffic["direction"] in ("compress", "decompress")
    assert callable(c.generator.snapshots)
    for fn in ("compress", "reconstruct", "stored_nbytes", "resolve_eb",
               "tolerance"):
        assert callable(getattr(c.reference, fn))
    for traced in (False, True):
        for m in harness.cell_metrics(BENCH, cell, traced):
            assert callable(harness.reader(m["name"]).read)


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric,
    added as files only, run in a copy of the benchmark."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "cusz-nyx.json").read_text())
    cfg.update(name="cusz-nyx-tight", shape=[16, 24, 40])
    cfg["codec_params"]["eb"] = 1e-5
    (pb / "configs" / "cusz-nyx-tight.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "traffic" / "compress.json",
                pb / "traffic" / "compress-copy.json")
    (pb / "workloads" / "cusz-nyx-tight.compress.json").write_text(
        json.dumps({"config": "cusz-nyx-tight", "traffic": "compress-copy"}))
    (pb / "metrics" / "fields_per_s.py").write_text(
        "def read(rec):\n    return len(rec.latencies_s) / rec.window_s\n")
    bench["configs"].append({**bench["configs"][0], "name": "cusz-nyx-tight",
                             "file": "portbench/configs/cusz-nyx-tight.json"})
    bench["workloads"].append({"name": "cusz-nyx-tight.compress",
                               "config": "cusz-nyx-tight",
                               "traffic": "compress-copy", "chips": 1,
                               "why": "tight"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cusz-nyx.compress" in m["workloads"]:
            m["workloads"].append("cusz-nyx-tight.compress")
    bench["end_to_end"].append({"name": "fields_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["cusz-nyx-tight.compress"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\n"
            f"sys.path[0:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
            "from portbench import harness\n"
            "r = harness.run('cusz-nyx-tight.compress', 5, 0.2, False, "
            "device='cpu', emit=lambda d: None)\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert {"fields_per_s", "compress_GBps", "ratio",
            "setup_s"} <= set(r["metrics"])
