"""The port's production dry run (`repro_torch.launch.dryrun`) against
the reference's (`repro.launch.dryrun`, 512 fake XLA devices).

Contract, for every arch x shape x single/multi-pod cell: the same skip
decisions; the same `TrainConfig` (dtype names compared); the same
shape, dtype and spec of every parameter, optimizer-state, token,
modality and cache input and of every output, and the same donated
inputs; the same ``model_flops``.  One deliberate difference: an int8
AdamW moment (deepseek-v2-236b and jamba-1.5-large-398b train cells)
sits at `sharding.quantized_moment_spec` of the reference's spec of its
codes, for ``q`` and ``scale`` alike, so that each rank's shard is a
whole number of 128-value blocks.

Then one reduced cell of each family is built on a fake group of 256
ranks in a subprocess (dense decode, MoE + MLA train, Mamba2 train, the
jamba hybrid's long context, phi-3-vision's and musicgen's train with
their modality inputs; train cells at one microbatch to bound the time),
with `status` ok, records in the reference's keys and placed outputs as
the contract says; one train layer of deepseek-v2-236b and of
mamba2-1.3b at their published widths; and the cache of records: a second call returns the
cached record, ``force`` rebuilds, an inapplicable cell writes the
reference's skip record.
"""
import json
import os
import re
import subprocess
import sys
import types

import pytest

from torch_spmd import ROOT, run_reference

_REF = """
from jax.sharding import NamedSharding
from repro import configs
from repro.configs.shapes import SHAPES, applicable
from repro.launch import dryrun as D

def norm(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)

def flat(tree, shard):
    xs = jax.tree.leaves(tree)
    ss = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    assert len(xs) == len(ss)
    return [(tuple(x.shape), str(x.dtype), norm(s.spec))
            for x, s in zip(xs, ss)]

for multi in (False, True):
    mesh = D.make_production_mesh(multi_pod=multi)
    for arch in sorted(configs.ARCHS):
        for s in SHAPES:
            key = (arch, s, multi)
            OUT[key, "flops"] = D.model_flops(arch, s)
            if not applicable(SHAPES[s], configs.get(arch)):
                OUT[key] = "skipped"
                continue
            fn, args, in_sh, donate, meta, out_sh = D.input_specs(
                arch, s, mesh)
            OUT[key] = {
                "meta": meta, "donate": tuple(donate),
                "in": [flat(a, sh) for a, sh in zip(args, in_sh)],
                "out": [[norm(s.spec) for s in jax.tree.leaves(
                    o, is_leaf=lambda x: isinstance(x, NamedSharding))]
                    for o in out_sh]}
OUT["skip_record"] = D.run_cell("qwen3-4b", "long_500k", False,
                                out_dir=sys.argv[1] + ".d")
"""

IN_NAMES = {"train": ("params", "opt_state", "tokens", "extra"),
            "prefill": ("params", "tokens", "extra"),
            "decode": ("params", "token", "caches", "cache_len")}
OUT_NAMES = {"train": ("loss", "params", "opt_state"),
             "prefill": ("logits", "caches"),
             "decode": ("logits", "caches")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_REF, tmp_path_factory.mktemp("dryrun_ref"),
                         devices=512)


def _norm(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _tcfg(s: str) -> str:
    """A TrainConfig string with its dtypes by name."""
    s = re.sub(r"<class 'jax\.numpy\.(\w+)'>", r"\1", s)
    return s.replace("torch.", "")


def _port_cells():
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, applicable
    from repro_torch.launch import dryrun as D

    for multi in (False, True):
        mesh = types.SimpleNamespace(shape=(
            {"pod": 2, "data": 16, "model": 16} if multi
            else {"data": 16, "model": 16}))
        for arch in sorted(configs.ARCHS):
            for s in SHAPES:
                skip = not applicable(SHAPES[s], configs.get(arch))
                yield (arch, s, multi), mesh, skip, D


def test_cells_and_flops_are_the_references(ref):
    n = 0
    for key, mesh, skip, D in _port_cells():
        assert D.model_flops(key[0], key[1]) == ref[key, "flops"], key
        assert (ref[key] == "skipped") == skip, key
        n += 1
    assert n == 80


def _moment_fixed(want_leaves, port_paths, port_shapes, mesh_shape):
    """The reference's spec list with each int8 moment's ``q`` and
    ``scale`` at the port's placement."""
    from repro_torch.dist import sharding as SH

    want = list(want_leaves)
    for i, path in enumerate(port_paths):
        if str(path[-1]) == ".q":
            q = _norm(SH.quantized_moment_spec(SH.P(*want[i]),
                                               port_shapes[i], mesh_shape))
            want[i] = want[i + 1] = q
    return want


def test_input_and_output_specs_are_the_references(ref):
    from repro_torch.tree import leaves, leaves_with_path

    moved = 0
    for key, mesh, skip, D in _port_cells():
        if skip:
            continue
        want = ref[key]
        cell = D.input_specs(key[0], key[1], mesh)
        assert _tcfg(cell.meta.get("tcfg", "")) == \
            _tcfg(want["meta"].get("tcfg", "")), key
        assert cell.meta.get("long_ctx") == want["meta"].get("long_ctx")
        names = [n for n in IN_NAMES[cell.kind] if n in cell.args]
        assert len(names) == len(want["in"]), key
        for name, w in zip(names, want["in"]):
            args, specs = cell.args[name], cell.in_specs[name]
            got = [(tuple(t.shape), _dtype(t.dtype), _norm(sp))
                   for t, sp in zip(leaves(args), leaves(specs))]
            assert len(got) == len(w), (key, name)
            wspecs = [x[2] for x in w]
            if name == "opt_state":
                paths = [p for p, _ in leaves_with_path(args)]
                fixed = _moment_fixed(wspecs, paths,
                                      [tuple(t.shape) for t in leaves(args)],
                                      mesh.shape)
                moved += sum(a != b for a, b in zip(fixed, wspecs))
                wspecs = fixed
            assert [g[:2] for g in got] == [x[:2] for x in w], (key, name)
            assert [g[2] for g in got] == wspecs, (key, name)
        outs = [cell.out_specs[n] for n in OUT_NAMES[cell.kind]]
        assert len(outs) == len(want["out"]), key
        for name, o, w in zip(OUT_NAMES[cell.kind], outs, want["out"]):
            got = [_norm(sp) for sp in leaves(o)]
            if name == "opt_state":
                args = cell.args["opt_state"]
                w = _moment_fixed(w, [p for p, _ in leaves_with_path(args)],
                                  [tuple(t.shape) for t in leaves(args)],
                                  mesh.shape)
            assert got == list(w), (key, name)
        donated = tuple(IN_NAMES[cell.kind].index(n) for n in cell.donate)
        assert donated == want["donate"], key
    assert moved > 0           # the int8-moment difference is exercised


_CELLS = """
import dataclasses, json, sys
import torch
torch.set_num_threads(2)
from repro_torch import configs
from repro_torch.launch import dryrun as D

out, recs = sys.argv[1], {}
cells = [("qwen3-4b", "decode_32k", None),
         ("deepseek-v2-236b", "train_4k", 1),
         ("mamba2-1.3b", "train_4k", 1),
         ("jamba-1.5-large-398b", "long_500k", None),
         ("phi-3-vision-4.2b", "train_4k", 1),
         ("musicgen-medium", "train_4k", 1)]
for arch, shape, mb in cells:
    recs[arch] = D.run_cell(arch, shape, False, out_dir=out,
                            microbatch_override=mb, save_hlo=True,
                            cfg=configs.reduced(arch, n_periods=1))
# published widths, one layer: the expert products, MLA and int8 moments
# of deepseek-v2-236b and the Mamba2 backward at their full shapes
for arch in ("deepseek-v2-236b", "mamba2-1.3b"):
    recs[arch, "full"] = D.run_cell(
        arch, "train_4k", False, out_dir=None, microbatch_override=1,
        cfg=dataclasses.replace(configs.get(arch), n_layers=1))
cfg = configs.reduced("qwen3-4b", n_periods=1)
recs["cached"] = D.run_cell("qwen3-4b", "decode_32k", False, out_dir=out,
                            cfg=cfg)
recs["forced"] = D.run_cell("qwen3-4b", "decode_32k", False, out_dir=out,
                            cfg=cfg, force=True)
recs["skipped"] = D.run_cell("qwen3-4b", "long_500k", False, out_dir=out,
                             cfg=cfg)
json.dump({str(k) if isinstance(k, tuple) else k: v
           for k, v in recs.items()}, open(out + "/all.json", "w"),
          default=str)
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_cells"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", _CELLS, out], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-4000:]
    with open(os.path.join(out, "all.json")) as f:
        return json.load(f), done.stdout, out


FAMILIES = ("qwen3-4b", "deepseek-v2-236b", "mamba2-1.3b",
            "jamba-1.5-large-398b", "phi-3-vision-4.2b", "musicgen-medium")


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cell_builds_on_256_fake_ranks(cells, arch):
    recs, _, _ = cells
    rec = recs[arch]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["n_chips"] == 256 and rec["compile_s"] is None
    assert rec["hlo_path"] is None
    assert rec["memory"]["per_device_total_GiB"] > 0
    assert rec["flops_per_device"] > 0 and rec["collective_counts"]
    assert set(rec["collective_by_op"]) == set(rec["collective_counts"])
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    assert rec["useful_flops_ratio"] > 0
    if rec["shape"] == "train_4k":
        assert "TrainConfig(microbatches=1" in rec["meta"]["tcfg"]
        assert rec["output_specs"]["loss"] == [["loss/", "P()"]]


@pytest.mark.parametrize("arch", ("deepseek-v2-236b", "mamba2-1.3b"))
def test_full_width_layer_builds(cells, arch):
    """One layer at the published widths: deepseek-v2-236b's 160 experts
    (10 per rank), its MLA heads and int8 moments, mamba2-1.3b's SSD
    backward, on the fake 256-rank group."""
    recs, _, _ = cells
    rec = recs[str((arch, "full"))]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["memory"]["per_device_total_GiB"] > 0


def test_long_context_places_the_sequence_over_data(cells):
    recs, _, _ = cells
    specs = dict(recs["jamba-1.5-large-398b"]["output_specs"]["caches"])
    kv = [sp for path, sp in specs.items() if "'data'" in sp]
    assert kv and all("'model'" not in sp for sp in kv)


def test_cached_forced_and_skipped_records(cells, ref):
    recs, stdout, out = cells
    assert "[skip cached] qwen3-4b__decode_32k__singlepod" in stdout
    first = recs["qwen3-4b"]
    assert recs["cached"] == {k: v for k, v in first.items()}
    assert recs["forced"]["status"] == "ok"
    assert "hlo_path" not in recs["forced"]
    assert recs["skipped"] == ref["skip_record"]
    assert os.path.exists(os.path.join(
        out, "qwen3-4b__long_500k__singlepod.json"))
