"""Scenario (d): prefill on a (4, 2) ("data", "model") mesh, the caches
cross to a (2, 4) decode mesh, on 8 gloo ranks, held against the
reference's 8-fake-device run.

Reduced qwen2.5-3b with the reference's seed-0 weights, an f32 compute
dtype and compressed KV.  On the int8-block wire the handoff and reshard
statistics are the reference's, both caches are adopted as QuantKV with
no decode, the adopted codes are int8 DTensors on mesh B, and six greedy
tokens equal the reference's and the mesh-less port's.  On the cusz wire
(decoded, then re-quantized under mesh B) the tokens are the reference's
cusz-leg tokens.
"""
import numpy as np
import pytest

from torch_spmd import run_ranks, run_reference

NEW = 6

_REF = """
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.dist import sharding as SH
from repro.dist.context import resolve_sharding, use_mesh
from repro.models import model as M
from repro.serve import engine as E

cfg = configs.reduced("qwen2.5-3b", n_periods=1)
params = M.init_params(jax.random.PRNGKey(0), cfg)
OUT["params"] = jax.tree.map(np.asarray, params)
rng = np.random.default_rng(0)
prompt = jnp.asarray(rng.integers(0, cfg.vocab, (4, 20)).astype(np.int32))
OUT["prompt"] = np.asarray(prompt)
scfg = E.ServeConfig(s_max=256, compressed_kv=True,
                     compute_dtype=jnp.float32)
mesh_a = jax.make_mesh((4, 2), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
mesh_b = jax.make_mesh((2, 4), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
params_a = jax.device_put(params, SH.param_shardings(params, mesh_a))
prompt_a = jax.device_put(prompt,
                          resolve_sharding(mesh_a, prompt.shape, "data"))
params_b = jax.device_put(params, SH.param_shardings(params, mesh_b))
with use_mesh(mesh_a):
    last, caches, plen = E.prefill(params_a, cfg, prompt_a, scfg)
last_b = jax.device_put(np.asarray(last),
                        resolve_sharding(mesh_b, last.shape, "data"))
for wire in ("int8-block", "cusz"):
    with use_mesh(mesh_a):
        h = E.encode_handoff(caches, cfg, scfg, wire=wire, plen=plen)
    OUT[wire, "handoff"] = dict(E.LAST_HANDOFF_STATS)
    with use_mesh(mesh_b):
        cb = E.reshard_caches(h, cfg, scfg)
        OUT[wire, "reshard"] = dict(E.LAST_RESHARD_STATS)
        OUT[wire, "tokens"] = np.asarray(E.decode_tokens(
            params_b, cfg, scfg, last_b, cb, plen, %(new)d))
""" % {"new": NEW}


def _ranks(rank, np_params, prompt):
    import torch

    from repro_torch import configs
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import resolve_sharding, use_mesh
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    cfg = configs.reduced("qwen2.5-3b", n_periods=1)
    params = M.params_from_numpy(np_params, device="cpu")
    prompt = torch.from_numpy(prompt)
    scfg = E.ServeConfig(s_max=256, compressed_kv=True,
                         compute_dtype=torch.float32)
    mesh_a = LM.make_mesh((4, 2), ("data", "model"), "cpu")
    mesh_b = LM.make_mesh((2, 4), ("data", "model"), "cpu")
    params_a = SH.place(params, SH.param_shardings(params, mesh_a))
    prompt_a = resolve_sharding(mesh_a, prompt.shape, "data").place(prompt)
    params_b = SH.place(params, SH.param_shardings(params, mesh_b))
    with use_mesh(mesh_a):
        last, caches, plen = E.prefill(params_a, cfg, prompt_a, scfg)
    last_b = resolve_sharding(mesh_b, last.shape, "data").place(last)
    out = {"meshless": E.generate(params, cfg, prompt, NEW, scfg)}
    for wire in ("int8-block", "cusz"):
        with use_mesh(mesh_a):
            h = E.encode_handoff(caches, cfg, scfg, wire=wire, plen=plen)
        out[wire, "handoff"] = dict(E.LAST_HANDOFF_STATS)
        with use_mesh(mesh_b):
            cb = E.reshard_caches(h, cfg, scfg)
            out[wire, "reshard"] = dict(E.LAST_RESHARD_STATS)
            q = cb.entries[0][0].q
            out[wire, "q"] = (q.dtype, tuple(q.device_mesh.shape),
                              q.device_mesh is mesh_b)
            out[wire, "tokens"] = E.decode_tokens(
                params_b, cfg, scfg, last_b, cb, plen, NEW).full_tensor()
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_reshard")
    ref = run_reference(_REF, tmp)
    port = run_ranks(_ranks, 8, tmp, ref["params"], ref["prompt"])[0]
    return port, ref


@pytest.mark.parametrize("wire", ("int8-block", "cusz"))
def test_handoff_and_reshard_stats_are_the_references(runs, wire):
    import torch
    port, ref = runs
    assert port[wire, "handoff"] == ref[wire, "handoff"]
    assert port[wire, "reshard"] == ref[wire, "reshard"]
    if wire == "int8-block":
        assert port[wire, "reshard"]["adopted_quantkv"] == 2
        assert port[wire, "reshard"]["decoded"] == 0
        assert port[wire, "handoff"]["wire_bytes"] \
            < port[wire, "handoff"]["raw_bf16_bytes"]
    assert port[wire, "q"] == (torch.int8, (2, 4), True)


@pytest.mark.parametrize("wire", ("int8-block", "cusz"))
def test_decode_tokens_are_the_references(runs, wire):
    port, ref = runs
    got = port[wire, "tokens"].numpy()
    assert got.shape == (4, NEW)
    np.testing.assert_array_equal(got, ref[wire, "tokens"])
    if wire == "int8-block":
        np.testing.assert_array_equal(got, port["meshless"].numpy())
