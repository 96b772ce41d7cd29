"""Scenarios (e) and (f): sharded checkpoints saved from one mesh and
restored onto another, on 8 gloo ranks, held against the reference's
8-fake-device run.

(e) The reference's seed-0 reduced qwen2.5-3b parameters, smoothed along
the last dim (so that cusz codes them), placed FSDP on a (4, 2)
("data", "model") mesh, are saved with the lossless, int8 and cusz
policies, once synchronously in one shard file and once through the
`AsyncWriter` in four.  Rank 0 writes every file (the reference's single
controller): the manifests and every stored array equal the reference's
byte for byte.  `load_checkpoint(shardings=)` onto a (2, 4) mesh gives
bit-equal trees from 1 and 4 shards, placed on mesh B, with the
reference's restore statistics (where both count the same leaves).  The
``use_restore_compress("int8-block")`` leg re-encodes the raw leaves:
the reference's statistics, within scale/2 of the plain restore, and
fewer bytes.

(f) Train state saved on a (2, 2, 2) ("pod", "data", "model") mesh at
two steps, with one shard file of the newer step corrupted, restores the
older step bit for bit, with the reference's quarantine report.
"""
import json
import os

import numpy as np
import pytest

from torch_spmd import run_ranks, run_reference

POLICIES = ({"codec": "lossless"}, {"codec": "int8"},
            {"codec": "cusz", "eb_valrel": 1e-4})

_REF = """
import glob, os
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.dist import context as ctx
from repro.dist import sharding as SH
from repro.dist.context import use_mesh
from repro.io import checkpoint as CK
from repro.io.async_writer import AsyncWriter
from repro.models import model as M
from repro.optim import adamw

BASE = %(base)r
cfg = configs.reduced("qwen2.5-3b", n_periods=1)
params = M.init_params(jax.random.PRNGKey(0), cfg)
params = jax.tree_util.tree_map(
    lambda x: jnp.cumsum(x, axis=-1) / 8
    if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
OUT["params"] = jax.tree.map(np.asarray, params)
mesh_a = jax.make_mesh((4, 2), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
mesh_b = jax.make_mesh((2, 4), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
params = jax.device_put(params, SH.param_shardings(params, mesh_a,
                                                   fsdp=True))
shard_b = SH.param_shardings(params, mesh_b, fsdp=True)
for pol in %(policies)r:
    d1 = os.path.join(BASE, "ref", pol["codec"] + "1")
    d4 = os.path.join(BASE, "ref", pol["codec"] + "4")
    CK.save_checkpoint(d1, 0, params, policy=CK.CheckpointPolicy(**pol),
                       nshards=1)
    with AsyncWriter(max_pending=1) as w:
        CK.save_checkpoint(d4, 0, params, policy=CK.CheckpointPolicy(**pol),
                           nshards=4, writer=w)
        w.wait()
    with use_mesh(mesh_b):
        CK.load_checkpoint(d4, params, shardings=shard_b)
    OUT[pol["codec"], "stats"] = dict(CK.LAST_RESTORE_STATS)
with use_mesh(mesh_b), ctx.use_restore_compress("int8-block"):
    CK.load_checkpoint(os.path.join(BASE, "ref", "lossless4"), params,
                       shardings=shard_b)
OUT["recode", "stats"] = dict(CK.LAST_RESTORE_STATS)

# (f): a corrupted shard of the newer step falls back to the older one
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
p = jax.device_put(OUT["params"], SH.param_shardings(params, mesh))
opt = adamw.init(p, adamw.AdamWConfig())
d = os.path.join(BASE, "ref", "quarantine")
for s in (0, 1):
    CK.save_checkpoint(d, s, (p, opt),
                       policy=CK.CheckpointPolicy(codec="lossless"), nshards=2)
shard = sorted(glob.glob(os.path.join(d, "step_00000001", "*.npz")))[0]
raw = bytearray(open(shard, "rb").read())
raw[len(raw) // 2] ^= 0xFF
open(shard, "wb").write(bytes(raw))
(_, _), step = CK.load_checkpoint(d, (p, opt))
OUT["quarantine"] = (step, [(r["step"], r["error_type"])
                            for r in CK.LAST_RESTORE_STATS["quarantine"]])
"""


def _ranks(rank, np_params, base):
    import glob

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import context as ctx
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh
    from repro_torch.io import checkpoint as CK
    from repro_torch.io.async_writer import AsyncWriter
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    def bits(t):
        return t.full_tensor().view(torch.uint8).reshape(-1)

    params = M.params_from_numpy(np_params, device="cpu")
    mesh_a = LM.make_mesh((4, 2), ("data", "model"), "cpu")
    mesh_b = LM.make_mesh((2, 4), ("data", "model"), "cpu")
    pa = SH.place(params, SH.param_shardings(params, mesh_a, fsdp=True))
    shard_b = SH.param_shardings(params, mesh_b, fsdp=True)
    out = {}
    for pol in POLICIES:
        d1 = os.path.join(base, "port", pol["codec"] + "1")
        d4 = os.path.join(base, "port", pol["codec"] + "4")
        CK.save_checkpoint(d1, 0, pa, policy=CK.CheckpointPolicy(**pol),
                           nshards=1)
        with AsyncWriter(max_pending=1) as w:
            assert CK.save_checkpoint(d4, 0, pa,
                                      policy=CK.CheckpointPolicy(**pol),
                                      nshards=4, writer=w) is w
            w.wait()
        with use_mesh(mesh_b):
            a, _ = CK.load_checkpoint(d1, params, shardings=shard_b)
            b, _ = CK.load_checkpoint(d4, params, shardings=shard_b)
        out[pol["codec"], "stats"] = dict(CK.LAST_RESTORE_STATS)
        out[pol["codec"], "equal"] = all(
            torch.equal(bits(x), bits(y)) for x, y in zip(leaves(a),
                                                          leaves(b)))
        out[pol["codec"], "mesh"] = all(
            x.device_mesh is mesh_b
            and tuple(x.placements) == tuple(s.placements(x.dim()))
            for x, s in zip(leaves(b), leaves(shard_b)))
        if pol["codec"] == "lossless":
            plain = [x.full_tensor() for x in leaves(b)]
    with use_mesh(mesh_b), ctx.use_restore_compress("int8-block"):
        c, _ = CK.load_checkpoint(os.path.join(base, "port", "lossless4"),
                                  params, shardings=shard_b)
    out["recode", "stats"] = dict(CK.LAST_RESTORE_STATS)
    out["recode", "pairs"] = [(p, x.full_tensor())
                              for p, x in zip(plain, leaves(c))]

    # (f)
    mesh = LM.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    p = SH.place(params, SH.param_shardings(params, mesh))
    opt = adamw.init(p, adamw.AdamWConfig())
    d = os.path.join(base, "port", "quarantine")
    for s in (0, 1):
        CK.save_checkpoint(d, s, (p, opt),
                           policy=CK.CheckpointPolicy(codec="lossless"),
                           nshards=2)
    if rank == 0:
        shard = sorted(glob.glob(os.path.join(d, "step_00000001",
                                              "*.npz")))[0]
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
    dist.barrier()
    shardings = SH.param_shardings((p, opt), mesh)
    (p2, o2), step = CK.load_checkpoint(d, (p, opt), shardings=shardings)
    out["quarantine"] = (step, [(r["step"], r["error_type"])
                                for r in CK.LAST_RESTORE_STATS["quarantine"]])
    out["quarantine_equal"] = all(
        torch.equal(bits(x), bits(y)) if hasattr(x, "full_tensor")
        else torch.equal(x, y)
        for x, y in zip(leaves((p, opt)), leaves((p2, o2))))
    out["marker"] = os.path.exists(os.path.join(d, "step_00000001",
                                                "QUARANTINE.json"))
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("spmd_ckpt"))
    ref = run_reference(_REF % {"base": base, "policies": POLICIES}, base)
    port = run_ranks(_ranks, 8, base, ref["params"], base)[0]
    return port, ref, base


@pytest.mark.parametrize("nshards", (1, 4))
@pytest.mark.parametrize("codec", [p["codec"] for p in POLICIES])
def test_files_are_the_references(runs, codec, nshards):
    _, _, base = runs
    mine = os.path.join(base, "port", f"{codec}{nshards}", "step_00000000")
    theirs = os.path.join(base, "ref", f"{codec}{nshards}", "step_00000000")
    man = open(os.path.join(mine, "manifest.json")).read()
    assert man == open(os.path.join(theirs, "manifest.json")).read()
    coded = {e["codec"] for e in json.loads(man)["tensors"].values()}
    assert codec in coded
    npz = sorted(f for f in os.listdir(mine) if f.endswith(".npz"))
    assert npz == sorted(f for f in os.listdir(theirs)
                         if f.endswith(".npz"))
    for f in npz:
        a, b = np.load(os.path.join(mine, f)), np.load(os.path.join(theirs, f))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("codec", [p["codec"] for p in POLICIES])
def test_elastic_restore_is_bit_equal_on_mesh_b(runs, codec):
    port, ref, _ = runs
    assert port[codec, "equal"] and port[codec, "mesh"]
    got, want = port[codec, "stats"], ref[codec, "stats"]
    assert got["saved_nshards"] == want["saved_nshards"] == 4
    assert got["leaves"] == want["leaves"]
    assert got["raw_bytes"] == want["raw_bytes"]
    assert got["wire_leaves"] > 0
    if codec != "cusz":
        # the reference counts cusz leaves as decoded on the host; the
        # port moves their containers and decodes on the device
        assert got == want
    if codec != "lossless":
        assert got["wire_bytes"] < got["raw_bytes"]


def test_restore_wire_codec_leg(runs):
    port, ref, _ = runs
    stats = port["recode", "stats"]
    assert stats == ref["recode", "stats"]
    assert stats["recoded_leaves"] > 0
    assert stats["wire_bytes"] < stats["raw_bytes"] / 3
    recoded = 0
    for a, b in port["recode", "pairs"]:
        a, b = a.numpy(), b.numpy()
        assert np.abs(a - b).max() <= np.abs(a).max() / 127.0 * 0.51
        recoded += not np.array_equal(a, b)
    assert recoded == stats["recoded_leaves"]


def test_invalid_restore_codec_rejected():
    from repro_torch.dist import context as ctx
    with pytest.raises(ValueError, match="unknown compression codec"):
        with ctx.use_restore_compress("no-such-codec"):
            pass
    with pytest.raises(ValueError, match="blockwise"):
        with ctx.use_restore_compress("cusz"):
            pass


def test_corrupted_shard_restores_last_good_step(runs):
    port, ref, _ = runs
    assert port["quarantine"] == ref["quarantine"]
    assert port["quarantine"][0] == 0
    assert port["quarantine_equal"] and port["marker"]
