"""The production-mesh faults of the port, on 8 gloo ranks: int8 AdamW
moments on leaves whose FSDP shard splits a 128-value block, modality
inputs in the train step on a (2, 2, 2) ("pod", "data", "model") mesh,
and the MLA, MoE and Mamba2 backward on a (4, 2) ("data", "model") mesh.

(a) The reduced qwen2.5-3b's seed-0 parameters placed FSDP on (4, 2):
its MLP weights' last dim (128) splits over "model" into shards of 64.
After `adamw.init` and one `adamw.update` with seeded grads, every int8
moment's codes and scales equal, bit for bit, those of the reference's
jitted update, which quantizes the global array; the moments sit at
`sharding.quantized_moment_spec` of their parameter's placement (the
port's one difference from the reference's specs) and the updated
parameters equal the mesh-less port's.

(b) phi-3-vision (``patch_embeds``) and musicgen-medium
(``frame_embeds``), reduced, two microbatches: the loss and grads of the
mesh step within 1e-5 relative of the mesh-less port's, forward at f32.

(c) deepseek-v2-236b (MLA with its heads split over "model", 8 experts
over "model") and mamba2-1.3b, reduced: loss and grads on (4, 2) within
1e-5 relative of the mesh-less port's.

(d) The same two at their published widths, 2 layers, on the fake
256-rank production group: the train step on [256, 4096] tokens builds
under `FakeTensorMode` (deepseek-v2-236b's 160 experts, 10 per "model"
rank; mamba2-1.3b's SSD backward, 2 microbatches) and gives back every
parameter at its placement.  DTensor's own propagation of these
products fails at these shapes: the expert einsum cannot view its
operand, and the SSD backward's bmm over a ``_StridedShard`` operand
reaches a data-dependent scalar.
"""
import contextlib
import functools
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

from torch_spmd import run_ranks, run_reference

_REF = """
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import model as M
from repro.optim import adamw

cfg = configs.reduced("qwen2.5-3b", n_periods=1)
params = M.init_params(jax.random.PRNGKey(0), cfg)
OUT["params"] = jax.tree.map(np.asarray, params)
rng = np.random.default_rng(3)
grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2)
                     .astype(np.float32), OUT["params"])
OUT["grads"] = grads
acfg = adamw.AdamWConfig(quantized_moments=True)
p, opt = jax.jit(lambda p, g: adamw.update(
    g, adamw.init(p, acfg), p, acfg))(params, jax.tree.map(jnp.asarray,
                                                           grads))
OUT["opt"] = jax.tree.map(np.asarray, opt)
"""

GRAD_ARCHS = (("phi-3-vision-4.2b", (2, 2, 2)),
              ("musicgen-medium", (2, 2, 2)),
              ("deepseek-v2-236b", (4, 2)),
              ("mamba2-1.3b", (4, 2)))


def _f32(M, T):
    M.forward = functools.partial(M.forward, compute_dtype=torch.float32)
    T.M.forward = M.forward


def _ranks(rank, np_params, np_grads):
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T

    _f32(M, T)
    out = {}
    with _scenario(out, "moments"):
        _moments(out, np_params, np_grads)
    for arch, shape in GRAD_ARCHS:
        with _scenario(out, arch):
            _grads(out, arch, shape)
    return out if rank == 0 else None


@contextlib.contextmanager
def _scenario(out, name):
    """Run one scenario; its exception is recorded under `name` (each
    test then fails on its own fault, not on an earlier one's)."""
    try:
        yield
    except Exception:                    # noqa: BLE001 (reported)
        out[name, "error"] = traceback.format_exc()


def _moments(out, np_params, np_grads):
    """(a) int8 moments on block-splitting shards."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import (leaves, leaves_up_to, leaves_with_path,
                                   tree_map)

    mesh = LM.make_mesh((4, 2), ("data", "model"), "cpu")
    params = M.params_from_numpy(np_params, device="cpu")
    grads = M.params_from_numpy(np_grads, device="cpu")
    acfg = adamw.AdamWConfig(quantized_moments=True)
    pshard = SH.param_shardings(params, mesh, fsdp=True)
    placed = SH.place(tree_map(torch.clone, params), pshard)
    opt = adamw.init(placed, acfg)
    want_specs = SH.param_specs(opt, mesh, fsdp=True)
    out["moment_specs"] = [
        (str(path), str(SH.spec_of(t)), str(sp))
        for (path, t), sp in zip(leaves_with_path(opt), leaves(want_specs))
        if hasattr(t, "device_mesh")]
    out["moved"] = sum(
        SH.spec_of(m.q) != SH.spec_of(p)
        for m, p in zip(leaves_up_to(placed, opt.m), leaves(placed))
        if isinstance(m, adamw.QTensor))
    out["split_blocks"] = [
        str(path) for path, p in leaves_with_path(placed)
        if p.dim() and p.shape[-1] % 128 == 0 and p.numel() >= 4096
        and p.to_local().shape[-1] % 128 != 0]
    placed, opt = adamw.update(SH.place(grads, pshard), opt, placed, acfg)
    out["opt"] = tree_map(lambda t: t.full_tensor() if hasattr(
        t, "full_tensor") else t, opt)
    plain = tree_map(torch.clone, params)
    plain, _ = adamw.update(tree_map(torch.clone, grads),
                            adamw.init(plain, acfg), plain, acfg)
    out["params_equal"] = all(
        torch.equal(a.full_tensor(), b)
        for a, b in zip(leaves(placed), leaves(plain)))


def _grads(out, arch, shape):
    """(b), (c) grads on a mesh against the mesh-less port."""
    from repro_torch import configs
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh, use_param_specs
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.tree import leaves, leaves_with_path

    cfg = configs.reduced(arch, n_periods=1)
    names = ("pod", "data", "model")[-len(shape):]
    mesh = LM.make_mesh(shape, names, "cpu")
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    S = 16
    toks = torch.randint(0, cfg.vocab, (8, S), generator=g,
                         dtype=torch.int32)
    extra = {}
    if cfg.n_prepend_embeds:
        extra["patch_embeds"] = torch.randn(
            (8, cfg.n_prepend_embeds, cfg.d_model), generator=g)
    if cfg.add_frame_embeds:
        extra["frame_embeds"] = torch.randn((8, S, cfg.d_model),
                                            generator=g)
    tcfg = T.TrainConfig(microbatches=2, npods=mesh.shape[0]
                         if "pod" in names else 1)
    want_l, want_g = T._microbatched_grads(params, cfg, tcfg, toks,
                                           extra or None)
    pspecs = SH.param_specs(params, mesh, fsdp=True)
    placed = SH.place(params, SH.param_shardings(params, mesh,
                                                 fsdp=True))
    with use_mesh(mesh), use_param_specs(pspecs):
        loss, gr = T._mesh_grads(cfg, tcfg, placed, toks, extra or None)
    out[arch] = (float(loss), float(want_l),
                 [(str(p), a.full_tensor(), b) for (p, a), b in zip(
                     leaves_with_path(gr), leaves(want_g))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_faults")
    ref = run_reference(_REF, tmp)
    port = run_ranks(_ranks, 8, tmp, ref["params"], ref["grads"])[0]
    return port, ref


def _ok(port, name):
    assert (name, "error") not in port, port[name, "error"]


def test_int8_moments_on_split_blocks_are_the_references(runs):
    from repro_torch.tree import leaves_with_path
    port, ref = runs
    _ok(port, "moments")
    assert port["split_blocks"], "no FSDP shard splits a 128-block"
    got = list(leaves_with_path(port["opt"]))
    want = list(leaves_with_path(ref["opt"]))
    assert [str(p) for p, _ in got] == [str(p) for p, _ in want]
    nq = 0
    for (path, a), (_, b) in zip(got, want):
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if str(path[-1]) in (".q", ".scale"):
            nq += 1
            assert a.tobytes() == b.tobytes(), path
    assert nq > 0
    assert port["params_equal"]


def test_int8_moments_sit_at_the_moment_spec(runs):
    """Every placed moment has the spec `param_specs` gives it; some of
    them left the last dim for another (the difference from the
    reference's specs)."""
    port, _ = runs
    _ok(port, "moments")
    specs = port["moment_specs"]
    assert specs and all(got == want for _, got, want in specs)
    assert port["moved"] > 0


@pytest.mark.parametrize("arch", [a for a, _ in GRAD_ARCHS])
def test_mesh_grads_equal_meshless(runs, arch):
    port, _ = runs
    _ok(port, arch)
    loss, want, pairs = port[arch]
    assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
    for path, a, b in pairs:
        a, b = a.numpy(), b.numpy()
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-5 * scale, (arch, path)


_FULL = """
import dataclasses, sys
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.dist import sharding as SH
from repro_torch.dist.context import use_mesh, use_param_specs
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves, tree_map

arch, nmb = sys.argv[1], int(sys.argv[2])
cfg = dataclasses.replace(configs.get(arch), n_layers=2)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = LM.make_production_mesh(device_type="cpu")
with FakeTensorMode(allow_non_fake_inputs=True):
    shapes = M.init_params(None, cfg, device="meta")
    params = SH.place(tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                               shapes),
                      SH.param_shardings(shapes, mesh, fsdp=True))
    tokens = SH.NamedSharding(mesh, SH.batch_spec(mesh, False)).place(
        torch.zeros(256, 4096, dtype=torch.int32))
    with use_mesh(mesh), use_param_specs(SH.param_specs(shapes, mesh,
                                                        fsdp=True)):
        opt = adamw.init(params, adamw.AdamWConfig())
        step = make_train_step(cfg, TrainConfig(microbatches=nmb))
        loss, new, _ = step(params, opt, tokens)
    assert tuple(loss.shape) == (), loss.shape
    for a, b in zip(leaves(new), leaves(params), strict=True):
        assert a.shape == b.shape and a.placements == b.placements
print("built")
"""


@pytest.mark.parametrize("arch,nmb", [("deepseek-v2-236b", 1),
                                      ("mamba2-1.3b", 2)])
def test_full_width_step_builds_on_256_fake_ranks(arch, nmb):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    done = subprocess.run([sys.executable, "-c", _FULL, arch, str(nmb)],
                          env=env, cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0 and "built" in done.stdout, \
        done.stdout[-2000:] + done.stderr[-4000:]
