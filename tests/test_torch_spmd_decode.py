"""Decode and checkpoint saves on a mesh that keep the parameters and
caches sharded, on 8 gloo ranks.

(a) Sharded decode.  Reduced qwen2.5-3b (GQA), deepseek-v2-236b (MLA and
MoE) and mamba2-1.3b with the reference's seed-0 weights at f32: prefill
and 6 greedy tokens on a (2, 4) ("data", "model") mesh, the parameters
placed FSDP and the caches by the decode cache rule, so that every
rank holds a quarter of each sequence (a Mamba state a quarter of its
heads and conv channels).  The tokens equal the mesh-less port's
`generate` and the reference's.  Also qwen2.5-3b with int8 QuantKV
caches (the sequence split in whole scale blocks) and one prompt (a
long context: the sequence over "data").  The decode never calls
``full_tensor``, and the caches it decodes from sit at the rule's
placements.

(b) Sharded saves.  The reduced qwen2.5-3b parameters, smoothed so
that the int8 and lossless codecs keep every leaf, placed FSDP on
(4, 2), saved with the lossless, int8, int8-block and zfp policies in 4
shard files: no rank calls ``full_tensor``, each split-stable part is
assembled on one rank from at most a quarter of its leaf, and the files
equal a one-rank save of the same tree byte for byte and load in the
reference.  int8-block keeps the MLP's up and gate projections split
and stores the leaves it cannot represent lossless; zfp (not
split-stable) keeps some leaves whole and stores the others lossless
where it would not save bytes.
"""
import json
import os
import traceback

import numpy as np
import pytest
import torch

from torch_spmd import run_ranks, run_reference

ARCHS = ("qwen2.5-3b", "deepseek-v2-236b", "mamba2-1.3b")
NEW = 6
#: (arch, int8 QuantKV caches, prompts)
CASES = [(a, False, 4) for a in ARCHS] + [("qwen2.5-3b", True, 4),
                                           ("qwen2.5-3b", False, 1)]
SAVE_CODECS = ("lossless", "int8", "int8-block", "zfp")

_REF = """
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import model as M
from repro.serve import engine as E

rng = np.random.default_rng(5)
for arch in %(archs)r:
    cfg = configs.reduced(arch, n_periods=1)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    OUT[arch, "params"] = jax.tree.map(np.asarray, params)
    prompt = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    OUT[arch, "prompt"] = prompt
    scfg = E.ServeConfig(s_max=64, compute_dtype=jnp.float32)
    OUT[arch, "tokens"] = np.asarray(E.generate(
        params, cfg, jnp.asarray(prompt), %(new)d, scfg))
""" % {"archs": ARCHS, "new": NEW}

_REF_LOAD = """
import glob
import jax, numpy as np
from repro import configs
from repro.io import checkpoint as CK
from repro.models import model as M
cfg = configs.reduced("qwen2.5-3b", n_periods=1)
template = M.init_params(jax.random.PRNGKey(0), cfg)
for d in sorted(glob.glob(%(base)r + "/*")):
    tree, _ = CK.load_checkpoint(d, template)
    OUT[os.path.basename(d)] = jax.tree.map(np.asarray, tree)
"""


def _ranks(rank, ref, base):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as SH
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.tree import leaves_with_path

    calls = []
    whole = DTensor.full_tensor

    def spy(self, *a, **k):
        calls.append(tuple(self.shape))
        return whole(self, *a, **k)

    mesh = LM.make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    # (a) sharded decode
    seen = {}
    step = getattr(M, "mesh_decode_step", None)

    def watch(params, cfg, token, caches, *a, **k):
        seen.setdefault(cfg.name, [
            (str(p), str(SH.spec_of(t))) for p, t in
            leaves_with_path(caches)])
        return step(params, cfg, token, caches, *a, **k)

    if step is not None:
        M.mesh_decode_step = watch
    for case in CASES:
        try:
            _decode(out, case, ref, mesh, calls, spy, whole)
        except Exception:                # noqa: BLE001 (reported)
            out[case] = traceback.format_exc()
        calls.clear()
    out["cache_specs"] = seen
    if step is not None:
        M.mesh_decode_step = step
    try:
        _saves(out, rank, ref, base, calls, spy, whole)
    except Exception:                    # noqa: BLE001 (reported)
        out["save_error"] = traceback.format_exc()
    dist.barrier()
    return out if rank == 0 else None


def _decode(out, case, ref, mesh, calls, spy, whole):
    """(a) one decode case on the (2, 4) mesh against `generate`."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    arch, compressed, B = case
    cfg = configs.reduced(arch, n_periods=1)
    params = M.params_from_numpy(ref[arch, "params"], device="cpu")
    prompt = torch.from_numpy(ref[arch, "prompt"][:B])
    scfg = E.ServeConfig(s_max=512 if compressed else 64,
                         compressed_kv=compressed,
                         compute_dtype=torch.float32)
    want = E.generate(params, cfg, prompt, NEW, scfg)
    placed = SH.place(params, SH.param_shardings(params, mesh,
                                                 fsdp=True))
    DTensor.full_tensor = spy
    try:
        with use_mesh(mesh):
            last, caches, plen = E.prefill(placed, cfg, prompt, scfg)
            toks = E.decode_tokens(placed, cfg, scfg, last, caches,
                                   plen, NEW)
    finally:
        DTensor.full_tensor = whole
    out[case] = (toks.full_tensor(), want, list(calls))


def _saves(out, rank, ref, base, calls, spy, whole):
    """(b) sharded saves on (4, 2) and the one-rank saves of rank 0."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh
    from repro_torch.io import checkpoint as CK
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    mesh = LM.make_mesh((4, 2), ("data", "model"), "cpu")
    params = M.params_from_numpy(ref["qwen2.5-3b", "params"], device="cpu")
    params = tree_map(lambda x: torch.cumsum(x, dim=-1) / 8
                      if x.is_floating_point() else x, params)
    placed = SH.place(params, SH.param_shardings(params, mesh, fsdp=True))
    boxes = {codec: [] for codec in SAVE_CODECS}
    gather = CK._gather_box

    def box_spy(leaf, lo, hi, dst):
        boxes[codec].append((tuple(leaf.shape), int(np.prod(
            [h - l for l, h in zip(lo, hi)]))))
        return gather(leaf, lo, hi, dst)

    CK._gather_box = box_spy
    DTensor.full_tensor = spy
    try:
        for codec in SAVE_CODECS:
            CK.save_checkpoint(os.path.join(base, "mesh", codec), 0, placed,
                               policy=CK.CheckpointPolicy(codec=codec),
                               nshards=4)
    finally:
        CK._gather_box = gather
        DTensor.full_tensor = whole
    out["save_calls"], out["boxes"] = list(calls), boxes
    if rank == 0:
        for codec in SAVE_CODECS:
            with use_mesh(None):
                CK.save_checkpoint(os.path.join(base, "one", codec), 0,
                                   params,
                                   policy=CK.CheckpointPolicy(codec=codec),
                                   nshards=4)
        out["params"] = params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_decode")
    ref = run_reference(_REF, tmp)
    base = str(tmp / "ckpt")
    port = run_ranks(_ranks, 8, tmp, ref, base)[0]
    loaded = run_reference(_REF_LOAD % {"base": os.path.join(base, "mesh")},
                           tmp)
    return port, ref, base, loaded


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sharded_decode_tokens(runs, case):
    port, ref, _, _ = runs
    assert not isinstance(port[case], str), port[case]
    got, meshless, calls = port[case]
    arch, compressed, B = case
    np.testing.assert_array_equal(got.numpy(), meshless.numpy())
    if not compressed:
        np.testing.assert_array_equal(got.numpy(),
                                      ref[arch, "tokens"][:B])
    assert calls == [], f"full_tensor of {calls}"


def test_sharded_decode_caches_follow_the_rule(runs):
    port, _, _, _ = runs
    specs = port["cache_specs"]
    # GQA K / V and MLA latents: sequence over "model"; Mamba state
    # heads and conv channels over "model"
    assert all("'model'" in sp for _, sp in specs["qwen2.5-3b"])
    assert all("'model'" in sp for _, sp in specs["deepseek-v2-236b"])
    assert all("'model'" in sp for _, sp in specs["mamba2-1.3b"])


@pytest.mark.parametrize("codec", SAVE_CODECS)
def test_sharded_save_is_the_one_rank_save(runs, codec):
    port, _, base, loaded = runs
    assert "save_error" not in port, port["save_error"]
    assert port["save_calls"] == []
    assert port["boxes"][codec]
    for shape, n in port["boxes"][codec]:
        # a leaf the codec cannot split goes whole to one rank
        whole = codec in ("int8-block", "zfp") and n == np.prod(shape)
        assert whole or n * 4 <= int(np.prod(shape)), (shape, n)
    mine = os.path.join(base, "mesh", codec, "step_00000000")
    theirs = os.path.join(base, "one", codec, "step_00000000")
    man = json.load(open(os.path.join(mine, "manifest.json")))
    assert man == json.load(open(os.path.join(theirs, "manifest.json")))
    assert {e["codec"] for e in man["tensors"].values()} >= {codec}
    for f in sorted(os.listdir(theirs)):
        if f.endswith(".npz"):
            a = np.load(os.path.join(mine, f))
            b = np.load(os.path.join(theirs, f))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), (f, k)
    from repro_torch.tree import leaves
    got = leaves(loaded[codec])
    want = [t.numpy() for t in leaves(port["params"])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if codec == "lossless":
            assert a.tobytes() == b.tobytes()
        elif codec == "zfp":
            # its values: the bytes above, decoded as the reference's
            # (tests/test_torch_checkpoint.py, zfp across the packages)
            assert np.isfinite(a).all()
        else:
            assert np.abs(a - b).max() <= np.abs(b).max() / 127 * 0.51
