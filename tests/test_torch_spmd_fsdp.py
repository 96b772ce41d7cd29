"""Scenario (b): FSDP on an (8, 1) ("data", "model") mesh of 8 gloo ranks
with the int8 weight gather, held against the reference's 8-fake-device
run.

Both packages start from the reference's seed-0 parameters with the
forward patched to f32.  `core.weights.gather_dequant_tree` of one
period's FSDP-sharded weights is bit-identical to the reference's (jitted)
one; its all-gathers move int8 codes and f32 block scales (the dtypes
handed to each collective, and `CommDebugMode`'s counts); and six steps
with ``weight_compress`` none and int8 give the reference's losses (step
0 within 1e-5 relative, later steps within 1e-3), with the reference's
own assertions (the loss falls, none and int8 end within 0.35).
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
from repro.core import weights as W
from repro.dist import sharding as SH
from repro.dist.context import use_mesh, use_param_specs
from repro.models import model as M
from repro.optim import adamw
from repro.train.train_step import TrainConfig, make_train_step
from repro.data import pipeline

M.forward = functools.partial(M.forward, compute_dtype=jnp.float32)
cfg = configs.reduced("qwen2.5-3b", n_periods=1)
mesh = jax.make_mesh((8, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
params = M.init_params(jax.random.PRNGKey(0), cfg)
OUT["params"] = jax.tree.map(np.asarray, params)
pspecs = SH.param_specs(params, mesh, fsdp=True)
pshard = SH.param_shardings(params, mesh, fsdp=True)

# one period's gathered weights (the hook's unit), outside the step
p = jax.device_put(params, pshard)
layer = jax.tree.map(lambda x: x[0], p["layers"][0])
lspec = jax.tree.map(lambda s: jax.sharding.PartitionSpec(*tuple(s)[1:]),
                     pspecs["layers"][0],
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
with use_mesh(mesh):
    got = jax.jit(lambda l: W.gather_dequant_tree(l, lspec, mesh))(layer)
OUT["gathered"] = jax.tree.map(np.asarray, got)

for mode in ("none", "int8"):
    tcfg = TrainConfig(weight_compress=mode,
                       adamw=adamw.AdamWConfig(lr=5e-3))
    p = jax.device_put(params, pshard)
    opt = adamw.init(p, tcfg.adamw)
    with use_mesh(mesh), use_param_specs(pspecs):
        step = jax.jit(make_train_step(cfg, tcfg))
        ls = []
        for s in range(%(steps)d):
            toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, s)
            loss, p, opt = step(p, opt, toks)
            ls.append(float(loss))
    OUT[mode] = ls
""" % {"steps": STEPS}


def _ranks(rank, np_params):
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch.core import weights as W
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import (_drop_lead, use_mesh,
                                          use_param_specs)
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T
    from repro_torch.tree import leaves, tree_map

    class Collectives(TorchDispatchMode):
        """(op, dtype) of every functional collective dispatched."""
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "_c10d_functional" \
                    and isinstance(args[0], torch.Tensor):
                self.seen.append((func._opname, args[0].dtype))
            return func(*args, **(kwargs or {}))

    M.forward = functools.partial(M.forward, compute_dtype=torch.float32)
    T.M.forward = M.forward
    cfg = configs.reduced(ARCH, n_periods=1)
    mesh = LM.make_mesh((8, 1), ("data", "model"), "cpu")
    params = M.params_from_numpy(np_params, device="cpu")
    pspecs = SH.param_specs(params, mesh, fsdp=True)
    pshard = SH.param_shardings(params, mesh, fsdp=True)
    out = {}

    p = SH.place(tree_map(torch.clone, params), pshard)
    layer = tree_map(lambda t: t[0], p["layers"][0])
    lspec = tree_map(_drop_lead, pspecs["layers"][0])
    rec, comm = Collectives(), CommDebugMode()
    with use_mesh(mesh), comm, rec:
        got = W.gather_dequant_tree(layer, lspec, mesh)
    out["gathered"] = [t.full_tensor() for t in leaves(got)]
    out["gather_dtypes"] = rec.seen
    out["gather_counts"] = {str(k): v
                            for k, v in comm.get_comm_counts().items()}

    for mode in MODES:
        tcfg = T.TrainConfig(weight_compress=mode,
                             adamw=adamw.AdamWConfig(lr=5e-3))
        p = SH.place(tree_map(torch.clone, params), pshard)
        opt = adamw.init(p, tcfg.adamw)
        step = T.make_train_step(cfg, tcfg)
        ls = []
        with use_mesh(mesh), use_param_specs(pspecs):
            for s in range(STEPS):
                toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, s)
                loss, p, opt = step(p, opt, toks)
                ls.append(float(loss))
        out[mode] = ls
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_fsdp")
    ref = run_reference(_REF, tmp)
    port = run_ranks(_ranks, 8, tmp, ref["params"])[0]
    return port, ref


def test_gather_dequant_tree_is_bit_identical(runs):
    from repro_torch.tree import leaves
    port, ref = runs
    want = leaves(ref["gathered"])
    assert len(port["gathered"]) == len(want)
    for g, w in zip(port["gathered"], want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_weight_all_gather_moves_int8(runs):
    port, _ = runs
    gathers = [dt for op, dt in port["gather_dtypes"]
               if op.startswith("all_gather")]
    # one int8 codes + one f32 scales gather per FSDP-sharded leaf
    assert gathers and gathers.count(torch.int8) == len(gathers) // 2
    assert set(gathers) == {torch.int8, torch.float32}
    assert port["gather_counts"] == {
        "c10d_functional.all_gather_into_tensor": len(gathers)}


@pytest.mark.parametrize("mode", MODES)
def test_losses_track_reference(runs, mode):
    port, ref = runs
    got, want = port[mode], ref[mode]
    assert len(got) == len(want) == STEPS
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w), (got, want)


def test_reference_assertions_hold(runs):
    port, _ = runs
    for mode in MODES:
        ls = port[mode]
        assert all(np.isfinite(ls)) and ls[-1] < ls[0], (mode, ls)
    assert abs(port["none"][-1] - port["int8"][-1]) < 0.35
