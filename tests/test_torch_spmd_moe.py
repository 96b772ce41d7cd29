"""Scenario (c): the compressed MoE all-to-all on a (2, 4) ("data",
"model") mesh of 8 gloo ranks, held against the reference's
`moe_forward` on 8 fake devices.

A reduced deepseek-v2 MoE layer (8 experts, top-2, one shared expert)
with the reference's seed-0 weights, placed as one period of the model's
layer tree is (experts over "model"), on rows placed over "data".  With
``use_a2a_compress`` off and on ("int8-block"), the forward and the
gradients of ``sum(out²)`` with respect to x and every routed-expert
weight and the router agree with the reference's (eager, so both divide
by 127 the same way) to f32 tolerance.  Under the hook the dispatch and
combine move int8 codes with f32 block scales, and without it f32 only.
"""
import numpy as np
import pytest
import torch

from torch_spmd import run_ranks, run_reference

B, S = 4, 16
CODECS = ("none", "int8-block")

_REF = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist import sharding as SH
from repro.dist.context import use_a2a_compress, use_mesh
from repro.models import moe

cfg = configs.reduced("deepseek-v2-236b", n_periods=1)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
p = moe.init_moe_params(jax.random.PRNGKey(0), cfg)
x = np.random.default_rng(0).standard_normal(
    (%(B)d, %(S)d, cfg.d_model)).astype(np.float32)
OUT["params"] = jax.tree.map(np.asarray, p)
OUT["x"] = x
specs = SH.param_specs({"layers": [{"moe": jax.tree.map(
    lambda t: t[None], p)}]}, mesh)["layers"][0]["moe"]
specs = jax.tree.map(lambda s: P(*tuple(s)[1:]), specs,
                     is_leaf=lambda s: isinstance(s, P))
pm = jax.tree.map(lambda t, s: jax.device_put(t, NamedSharding(mesh, s)),
                  p, specs, is_leaf=lambda s: isinstance(s, P))
xm = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))

def f(p, x):
    out = moe.moe_forward(p, cfg, x)
    return jnp.sum(out.astype(jnp.float32) ** 2), out

for codec in ("none", "int8-block"):
    with use_mesh(mesh), use_a2a_compress(codec):
        (_, out), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(pm, xm)
    OUT[codec] = (np.asarray(out), np.asarray(gx),
                  jax.tree.map(np.asarray, gp))
""" % {"B": B, "S": S}


def _ranks(rank, np_params, x):
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import (_drop_lead, use_a2a_compress,
                                          use_mesh)
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "_c10d_functional" \
                    and isinstance(args[0], torch.Tensor):
                self.seen.add(args[0].dtype)
            return func(*args, **(kwargs or {}))

    cfg = configs.reduced("deepseek-v2-236b", n_periods=1)
    mesh = LM.make_mesh((2, 4), ("data", "model"), "cpu")
    p = M.params_from_numpy(np_params, device="cpu")
    specs = SH.param_specs({"layers": [{"moe": tree_map(
        lambda t: t[None], p)}]}, mesh)["layers"][0]["moe"]
    specs = tree_map(_drop_lead, specs)
    out = {}
    for codec in CODECS:
        pm = tree_map(lambda t, s: SH.NamedSharding(mesh, s).place(t)
                      .detach().requires_grad_(), p, specs)
        xm = SH.NamedSharding(mesh, SH.P("data")).place(
            torch.from_numpy(x)).requires_grad_()
        rec = Collectives()
        with use_mesh(mesh), use_a2a_compress(codec), rec:
            y = moe.moe_forward(pm, cfg, xm)
            (y.float() ** 2).sum().backward()
        out[codec] = (y.full_tensor().detach(), xm.grad.full_tensor(),
                      tree_map(lambda t: t.grad.full_tensor(), pm),
                      sorted(str(d) for d in rec.seen))
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_moe")
    ref = run_reference(_REF, tmp)
    port = run_ranks(_ranks, 8, tmp, ref["params"], ref["x"])[0]
    return port, ref


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(got - want))) <= rtol * scale


@pytest.mark.parametrize("codec", CODECS)
def test_forward_matches_reference(runs, codec):
    port, ref = runs
    assert _close(port[codec][0], ref[codec][0], 1e-5)


@pytest.mark.parametrize("codec", CODECS)
def test_grads_match_reference(runs, codec):
    from repro_torch.tree import leaves_with_path
    port, ref = runs
    assert _close(port[codec][1], ref[codec][1], 1e-5)
    want = dict(leaves_with_path(ref[codec][2]))
    got = dict(leaves_with_path(port[codec][2]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _close(got[k], want[k], 1e-5), k


def test_compressed_crossings_move_int8(runs):
    port, _ = runs
    assert port["int8-block"][3] == ["torch.float32", "torch.int8"]
    assert port["none"][3] == ["torch.float32"]
