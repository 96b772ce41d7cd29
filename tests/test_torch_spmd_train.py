"""Scenario (a): the train step on a (2, 2, 2) ("pod", "data", "model")
mesh of 8 gloo ranks, held against the reference's 8-fake-device run.

Both packages start from the reference's seed-0 parameters with the
forward patched to f32.  For ``grad_compress`` none and int8 (two pods,
two microbatches): the step-0 loss within 1e-5 relative of the
reference's and the step-0 grads within 1e-5 relative (int8: each value
within 1e-5 relative or one quantization step, the pod-wide scale, since
an f32 difference of 1e-7 can move a value across a rounding boundary);
six steps' losses within 1e-3; and the reference's own assertions (the
last loss below the first, none and int8 ending within 0.35).  At the
function level, the int8 pod mean of the same per-pod grads is
bit-identical to the mesh-less `compressed_psum_mean` and to the jitted
reference's, from plain tensors and from DTensors on the pod's sub-mesh,
and what enters the all-reduce is int8.
"""
import functools

import numpy as np
import pytest
import torch

from torch_spmd import run_ranks, run_reference

ARCH = "qwen2.5-3b"
STEPS = 6
MODES = ("none", "int8")

_REF = """
import functools
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.core import gradient as G
from repro.dist import sharding as SH
from repro.dist.context import dp_axes_override, use_mesh, use_param_specs
from repro.models import model as M
from repro.optim import adamw
from repro.train import train_step as T
from repro.data import pipeline

M.forward = functools.partial(M.forward, compute_dtype=jnp.float32)
cfg = configs.reduced("qwen2.5-3b", n_periods=1)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
params = M.init_params(jax.random.PRNGKey(0), cfg)
OUT["params"] = jax.tree.map(np.asarray, params)
pspecs = SH.param_specs(params, mesh)
pshard = SH.param_shardings(params, mesh)
for mode in ("none", "int8"):
    tcfg = T.TrainConfig(microbatches=2, grad_compress=mode, npods=2,
                         adamw=adamw.AdamWConfig(lr=5e-3))
    podded = mode != "none"

    def grads_fn(p, toks):
        if podded:
            def pod(t):
                with dp_axes_override(("data",)):
                    return T._microbatched_grads(p, cfg, tcfg, t, None)
            losses, gp = jax.vmap(pod, spmd_axis_name="pod")(toks)
            return jnp.mean(losses), G.compressed_psum_mean(gp, mode, 2)
        return T._microbatched_grads(p, cfg, tcfg, toks, None)

    p = jax.device_put(params, pshard)
    opt = adamw.init(p, tcfg.adamw)
    with use_mesh(mesh), use_param_specs(pspecs):
        toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, 0, podded=podded)
        l0, g0 = jax.jit(grads_fn)(p, toks)
        OUT[mode, "grads"] = jax.tree.map(np.asarray, g0)
        OUT[mode, "loss0"] = float(l0)
        step = jax.jit(T.make_train_step(cfg, tcfg))
        ls = []
        for s in range(%(steps)d):
            toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, s,
                                         podded=podded)
            loss, p, opt = step(p, opt, toks)
            ls.append(float(loss))
    OUT[mode, "losses"] = ls

# the jitted reference pod mean of fixed per-pod grads, off-mesh
rng = np.random.default_rng(7)
pods = {"a": rng.standard_normal((2, 64, 48)).astype(np.float32),
        "b": (rng.standard_normal((2, 256)) * 1e-3).astype(np.float32)}
OUT["pods"] = pods
mean = jax.jit(G.compressed_psum_mean, static_argnums=(1, 2))
OUT["pod_mean"] = jax.tree.map(np.asarray, mean(
    jax.tree.map(jnp.asarray, pods), "int8", 2))
""" % {"steps": STEPS}


def _ranks(rank, np_params, pods):
    """One rank's share of the scenario; rank 0 returns the results."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import gradient as G
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh, use_param_specs
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T
    from repro_torch.tree import leaves, tree_map

    M.forward = functools.partial(M.forward, compute_dtype=torch.float32)
    T.M.forward = M.forward
    cfg = configs.reduced(ARCH, n_periods=1)
    mesh = LM.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    params = M.params_from_numpy(np_params, device="cpu")
    pspecs = SH.param_specs(params, mesh)
    pshard = SH.param_shardings(params, mesh)
    out = {}
    for mode in MODES:
        tcfg = T.TrainConfig(microbatches=2, grad_compress=mode, npods=2,
                             adamw=adamw.AdamWConfig(lr=5e-3))
        podded = mode != "none"
        p = SH.place(tree_map(torch.clone, params), pshard)
        opt = adamw.init(p, tcfg.adamw)
        with use_mesh(mesh), use_param_specs(pspecs):
            toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, 0,
                                         podded=podded)
            l0, g0 = T._mesh_grads(cfg, tcfg, p, toks, None)
            out[mode, "grads"] = [g.full_tensor() for g in leaves(g0)]
            out[mode, "loss0"] = float(l0)
            step = T.make_train_step(cfg, tcfg)
            ls = []
            for s in range(STEPS):
                toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, s,
                                             podded=podded)
                loss, p, opt = step(p, opt, toks)
                ls.append(float(loss))
        out[mode, "losses"] = ls

    # the int8 pod mean of fixed per-pod grads: plain tensors and DTensors
    # on the pod's sub-mesh; record what enters each all-reduce
    ipod = mesh.get_coordinate()[0]
    mine = {k: torch.from_numpy(v[ipod].copy()) for k, v in pods.items()}
    seen, real = [], dist.all_reduce

    def recording(t, *a, **kw):
        seen.append(t.dtype)
        return real(t, *a, **kw)
    dist.all_reduce = recording
    try:
        with use_mesh(mesh):
            out["plain_mean"] = G.pod_mean(mine, "int8", mesh)
            sub = mesh["data", "model"]
            placed = {k: SH.NamedSharding(sub, SH.P("data"))
                      .place(v) for k, v in mine.items()}
            dmean = G.pod_mean(placed, "int8", mesh)
    finally:
        dist.all_reduce = real
    out["dtensor_mean"] = {k: v.full_tensor() for k, v in dmean.items()}
    out["all_reduce_dtypes"] = seen
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_train")
    ref = run_reference(_REF, tmp)
    port = run_ranks(_ranks, 8, tmp, ref["params"], ref["pods"])[0]
    return port, ref


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_step0_loss_and_grads_match_reference(runs, mode):
    port, ref = runs
    assert abs(port[mode, "loss0"] - ref[mode, "loss0"]) \
        <= 1e-5 * abs(ref[mode, "loss0"])
    from repro_torch.tree import leaves
    want = leaves(ref[mode, "grads"])
    got = port[mode, "grads"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        if mode == "none":
            assert _rel(g, w) <= 1e-5
            continue
        # int8: the pod mean sits on a grid of step scale/npods; a value
        # whose f32 grad differs by ~1e-7 may round to the next level
        step = 2 * np.max(np.abs(w)) / 63
        off = np.abs(g - w) > 1e-5 * np.max(np.abs(w))
        assert np.all(np.abs(g - w)[off] <= step)
        assert off.mean() < 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_losses_track_reference(runs, mode):
    port, ref = runs
    got, want = port[mode, "losses"], ref[mode, "losses"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w), (got, want)


def test_reference_assertions_hold(runs):
    port, _ = runs
    for mode in MODES:
        ls = port[mode, "losses"]
        assert all(np.isfinite(ls)) and ls[-1] < ls[0], (mode, ls)
    assert abs(port["none", "losses"][-1] - port["int8", "losses"][-1]) \
        < 0.35


def test_int8_pod_mean_is_bit_identical(runs):
    from repro_torch.core import gradient as G
    port, ref = runs
    stacked = {k: torch.from_numpy(v) for k, v in ref["pods"].items()}
    meshless = G.compressed_psum_mean(stacked, "int8", 2)
    for k in stacked:
        want = meshless[k].numpy()
        assert want.tobytes() == ref["pod_mean"][k].tobytes()
        assert port["plain_mean"][k].numpy().tobytes() == want.tobytes()
        assert port["dtensor_mean"][k].numpy().tobytes() == want.tobytes()


def test_int8_codes_enter_the_all_reduce(runs):
    """Per leaf: the f32 amax (MAX over pods), then the int8 codes."""
    port, _ = runs
    assert port["all_reduce_dtypes"] == [torch.float32, torch.int8] * 4
