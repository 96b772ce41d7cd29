"""Port parity for the model stack (`repro_torch.models`,
`repro_torch.configs`) against the reference's `repro.models` /
`repro.configs`, on the CPU:

  * every config field, `param_count` and `active_param_count` of the ten
    archs, `reduced()`, the shape set and `applicable`;
  * `rms_norm`, `rope_freqs`, `apply_rope`, `swiglu`, the flash-scan core
    across KV and query blocks, `gqa_forward`, `gqa_decode` (dense and
    compressed) and the per-row in-place cache write;
  * `forward` logits and `decode_step` in f32 and in bf16, and `generate`
    tokens in f32, with the reference's weights carried over by
    `params_from_numpy`; for the MoE, MLA, Mamba2 and hybrid archs
    (moonshot, deepseek, mamba2, jamba) the parameter tree, f32 logits
    and collected caches, one decode step from the reference's prefill
    caches (dense and compressed), f32 `generate` tokens and mamba2's
    bf16 logits (the layers themselves: test_torch_moe_ssm.py).

Tolerances: f32 results agree within atol = rtol = 1e-4 (the two
packages' matmuls sum in different orders; the logits' gap at these
sizes is 0.5-2e-6).  `apply_rope` agrees within 8 ulp of the result's
largest magnitude (cos/sin may differ by an ulp between libms).  bf16
logits agree within 0.05 absolute plus 5% of their range, and 90% of
their argmaxes agree: the two packages round bf16 intermediates at
different points (XLA fuses elementwise chains in f32, eager torch
rounds after each op), and the layers compound those bf16 ulps (the gap
at these sizes is 0.006-0.03).  Greedy tokens are compared exactly in
f32.

The reference imports `repro.dist`, whose package init imports a `chaos`
module that the checkout lacks: the `ref` fixture puts an unarmed
stand-in into `sys.modules` for this module's duration and, on teardown,
removes every `repro*` module it caused to be imported, so the reference
suite's own files see the same interpreter state with or without this
one.  The `cuda` test at the end holds the card to the reference on the
same numpy inputs (JAX on the CPU, imported lazily by the fixture), in
f32 and in bf16 at the tolerances above.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import kvcache as TKV
from repro_torch.io import checkpoint as TCK
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as TE

DENSE = ("qwen3-4b", "qwen2.5-3b")
MOE_MLA_SSM = ("moonshot-v1-16b-a3b", "deepseek-v2-236b", "mamba2-1.3b",
               "jamba-1.5-large-398b")
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported with an unarmed `repro.dist.chaos`
    stand-in; every `repro*` module this import added leaves
    `sys.modules` again at teardown."""
    # the reference runs on the CPU, also where a card is present
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    before = set(sys.modules)
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    sys.modules["repro.dist.chaos"] = stub
    names = {"jax": "jax", "jnp": "jax.numpy", "configs": "repro.configs",
             "M": "repro.models.model", "attn": "repro.models.attention",
             "layers": "repro.models.layers", "E": "repro.serve.engine",
             "KV": "repro.core.kvcache"}
    try:
        yield types.SimpleNamespace(**{k: importlib.import_module(v)
                                       for k, v in names.items()})
    finally:
        _drop_new_repro_modules(before)


def _drop_new_repro_modules(before) -> None:
    for name in sorted(set(sys.modules) - before, reverse=True):
        if name == "repro" or name.startswith("repro."):
            del sys.modules[name]
            parent, _, child = name.rpartition(".")
            if parent in sys.modules:
                sys.modules[parent].__dict__.pop(child, None)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _np(x):
    return np.asarray(x)


def _t(a, device="cpu", dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    t = t.to(device)
    return t.to(dtype) if dtype is not None else t


def _f(t):
    return t.detach().float().cpu().numpy()


def _ref_params(ref, cfg, seed=0):
    p = ref.M.init_params(ref.jax.random.PRNGKey(seed), cfg)
    return p, ref.jax.tree.map(np.asarray, p)


def _assert_logits_close(got, want, dtype):
    """The stated tolerances: f32 within ATOL / RTOL; bf16 within 0.05
    absolute plus 5% of the reference's range."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        span = float(want.max() - want.min())
        assert float(np.abs(got - want).max()) <= 0.05 + 0.05 * span


def _cfgs(ref, arch, n_periods=2):
    return tconfigs.reduced(arch, n_periods), ref.configs.reduced(arch,
                                                                  n_periods)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

ALL_ARCHS = ("mamba2-1.3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
             "jamba-1.5-large-398b", "phi-3-vision-4.2b", "qwen3-32b",
             "qwen3-4b", "granite-34b", "qwen2.5-3b", "musicgen-medium")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_fields_and_counts(ref, arch):
    mine, theirs = tconfigs.get(arch), ref.configs.get(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert mine.layer_kinds() == theirs.layer_kinds()
    for n in (1, 2):
        a, b = _cfgs(ref, arch, n)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
    for name, shape in tconfigs.SHAPES.items():
        assert tconfigs.applicable(shape, mine) == ref.configs.applicable(
            ref.configs.SHAPES[name], theirs)


def test_registry_and_shapes(ref):
    assert sorted(tconfigs.ARCHS) == sorted(ref.configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref.configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_swiglu(ref):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        got = tlayers.rms_norm(_t(x, dtype=getattr(torch, dt)), _t(w), 1e-6)
        want = ref.layers.rms_norm(ref.jnp.asarray(x).astype(dt),
                                   ref.jnp.asarray(w), 1e-6)
        assert str(got.dtype).endswith(dt)
        tol = ATOL if dt == "float32" else 1e-2
        np.testing.assert_allclose(_f(got), _np(want).astype(np.float32),
                                   atol=tol, rtol=tol)
    wg, wu = (rng.standard_normal((64, 128)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((128, 64)).astype(np.float32) * 0.1
    got = tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd))
    want = ref.layers.swiglu(*(ref.jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(_f(got), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("theta", (1e6, 1e4))
def test_rope(ref, theta):
    np.testing.assert_array_equal(tlayers.rope_freqs(16, theta),
                                  ref.layers.rope_freqs(16, theta))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = _f(tlayers.apply_rope(_t(x), _t(pos), theta))
    want = _np(ref.layers.apply_rope(ref.jnp.asarray(x),
                                     ref.jnp.asarray(pos), theta))
    # within 8 ulp of the result's largest magnitude (cos/sin may differ
    # by one)
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    np.testing.assert_allclose(got, want, atol=8 * ulp, rtol=0)


def test_dense_init_scale():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(g, (256, 4, 32), in_axis=0)
    assert w.dtype == torch.float32 and tuple(w.shape) == (256, 4, 32)
    assert abs(float(w.std()) - 256 ** -0.5) < 0.01
    wo = tlayers.dense_init(g, (4, 32, 256), in_axis=(0, 1))
    assert abs(float(wo.std()) - 128 ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", (True, False))
def test_flash_across_blocks(ref, causal):
    """1100 queries and keys: two KV blocks (the second partial) and two
    query blocks; the causal case also has fully masked rows in the
    first query block's second KV block."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 1100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1100, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1100, 2, 16)).astype(np.float32)
    got = tattn._flash_qblocked(_t(q), _t(k), _t(v), causal)
    want = ref.attn._flash_qblocked(*(ref.jnp.asarray(a) for a in (q, k, v)),
                                    causal)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_f(got), _np(want), atol=ATOL, rtol=RTOL)


def test_flash_fully_masked_query_gives_zeros():
    """A query whose every key is masked (q_offset puts it before the
    first key under the causal mask) returns zeros, not NaN."""
    q = torch.randn(1, 3, 2, 8)
    k = torch.randn(1, 4, 1, 8)
    out = tattn._flash(q, k, k, causal=True, q_offset=-3)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("arch", DENSE)
def test_gqa_forward(ref, arch):
    tcfg, rcfg = _cfgs(ref, arch)
    rp, npp = _ref_params(ref, rcfg, seed=3)
    p_ref = ref.jax.tree.map(lambda a: a[0], rp["layers"][0]["attn"])
    p = TM.params_from_numpy(
        {k: v[0] for k, v in npp["layers"][0]["attn"].items()}, "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    out, (k, v) = tattn.gqa_forward(p, tcfg, _t(x), _t(pos))
    rout, (rk, rv) = ref.attn.gqa_forward(p_ref, rcfg, ref.jnp.asarray(x),
                                          ref.jnp.asarray(pos))
    for a, b in ((out, rout), (k, rk), (v, rv)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("arch", DENSE)
def test_gqa_decode(ref, arch, compressed):
    tcfg, rcfg = _cfgs(ref, arch)
    rp, npp = _ref_params(ref, rcfg, seed=4)
    p_ref = ref.jax.tree.map(lambda a: a[0], rp["layers"][0]["attn"])
    p = TM.params_from_numpy(
        {k: v[0] for k, v in npp["layers"][0]["attn"].items()}, "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    cshape = (2, 256, tcfg.n_kv_heads, tcfg.head_dim)
    ck = rng.standard_normal(cshape).astype(np.float32)
    cv = rng.standard_normal(cshape).astype(np.float32)
    ck[:, 140:] = 0.0
    cv[:, 140:] = 0.0
    if compressed:
        rk = ref.KV.kv_quantize(ref.jnp.asarray(ck), 1)
        rv = ref.KV.kv_quantize(ref.jnp.asarray(cv), 1)
        tk = TKV.QuantKV(_t(rk.q), _t(rk.scale))
        tv = TKV.QuantKV(_t(rv.q), _t(rv.scale))
    else:
        rk, rv = ref.jnp.asarray(ck), ref.jnp.asarray(cv)
        tk, tv = _t(ck), _t(cv)
    out, nk, nv = tattn.gqa_decode(p, tcfg, _t(x), tk, tv, 140,
                                   compressed=compressed)
    rout, rnk, rnv = ref.attn.gqa_decode(p_ref, rcfg, ref.jnp.asarray(x), rk,
                                         rv, ref.jnp.int32(140),
                                         compressed=compressed)
    np.testing.assert_allclose(_f(out), _np(rout), atol=ATOL, rtol=RTOL)
    assert nk is tk                          # written in place
    if compressed:
        for a, b in ((nk, rnk), (nv, rnv)):
            np.testing.assert_allclose(
                _f(TKV.kv_dequantize(a, 1, torch.float32)),
                _np(ref.KV.kv_dequantize(b, 1, ref.jnp.float32)),
                atol=float(np.asarray(b.scale).max()) + ATOL)
    else:
        for a, b in ((nk, rnk), (nv, rnv)):
            np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_kv_update_rows_matches_reference_per_row(ref, dtype):
    """The in-place write with per-row positions gives each row the bits
    of the reference's jitted `kv_update_block` (its serve steps' form)
    at that row's own position, including a scale-widening write and a
    write into a floor block; the functional `kv_update_block` at an int
    position gives the same bits and leaves its source as it was."""
    rng = np.random.default_rng(5)
    cache = (rng.standard_normal((3, 384, 2, 8)) * 0.1).astype(np.float32)
    cache[:, 200:] = 0.0
    new = (rng.standard_normal((3, 1, 2, 8))).astype(np.float32)
    new[1] *= 40.0
    pos = np.array([5, 130, 300])
    rq = ref.KV.kv_quantize(ref.jnp.asarray(cache), 1)
    rnew = ref.jnp.asarray(new).astype(dtype)
    mine = TKV.QuantKV(_t(rq.q), _t(rq.scale))
    out = TKV.kv_update_block_(mine, _t(rnew), torch.as_tensor(pos), 1)
    assert out is mine
    update = ref.jax.jit(ref.KV.kv_update_block, static_argnums=3)
    for b in range(3):
        want = update(ref.KV.QuantKV(rq.q[b:b + 1], rq.scale[b:b + 1]),
                      rnew[b:b + 1], int(pos[b]), 1)
        src = TKV.QuantKV(_t(rq.q[b:b + 1]), _t(rq.scale[b:b + 1]))
        one = TKV.kv_update_block(src, _t(rnew[b:b + 1]), int(pos[b]), 1)
        np.testing.assert_array_equal(src.q.numpy(), _np(rq.q[b:b + 1]))
        for got in (TKV.QuantKV(out.q[b:b + 1], out.scale[b:b + 1]), one):
            np.testing.assert_array_equal(got.q.numpy(), _np(want.q))
            np.testing.assert_array_equal(
                got.scale.numpy().view(np.int32),
                _np(want.scale).view(np.int32))


def test_kv_requantize_is_the_jitted_quantize(ref):
    """`kv_quantize(reciprocal=True)` is the reference's jitted
    `kv_quantize` bit for bit; the default form is its eager one."""
    x = np.random.default_rng(11).standard_normal((2, 256, 3, 8)
                                                  ).astype(np.float32)
    got = TKV.kv_quantize(_t(x), 1, reciprocal=True)
    want = ref.jax.jit(ref.KV.kv_quantize, static_argnums=1)(
        ref.jnp.asarray(x), 1)
    np.testing.assert_array_equal(got.q.numpy(), _np(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32),
                                  _np(want.scale).view(np.int32))
    # the eager form divides: the two differ in some scale's last bit
    eager = TKV.kv_quantize(_t(x), 1)
    assert not torch.equal(eager.scale, got.scale)
    np.testing.assert_array_equal(
        eager.scale.numpy().view(np.int32),
        _np(ref.KV.kv_quantize(ref.jnp.asarray(x), 1).scale).view(np.int32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_params_from_numpy_layout_and_checkpoint_paths(ref):
    tcfg, rcfg = _cfgs(ref, "qwen3-4b")
    rp, npp = _ref_params(ref, rcfg)
    mine = TM.params_from_numpy(npp, "cpu")
    flat, _ = ref.jax.tree_util.tree_flatten_with_path(rp)

    def key(path):
        return TCK._leaf_key(tuple(getattr(k, "key", getattr(k, "idx", k))
                                   for k in path))

    theirs = [(key(p), tuple(v.shape)) for p, v in flat]
    got = [(TCK._leaf_key(p), tuple(v.shape))
           for p, v in TCK._leaves_with_path(mine)]
    assert got == theirs
    assert mine["layers"][0]["attn"]["wq"].shape[0] == tcfg.n_periods
    for (_, a), (_, b) in zip(TCK._leaves_with_path(mine), flat):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # init_params draws the same tree structure, shapes and dtypes
    own = TM.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [(TCK._leaf_key(p), tuple(v.shape), v.dtype)
            for p, v in TCK._leaves_with_path(own)] == \
        [(k, s, torch.float32) for k, s in theirs]


@pytest.mark.parametrize("arch", ("qwen3-4b", "qwen2.5-3b", "granite-34b",
                                  "qwen3-32b") + MOE_MLA_SSM)
def test_param_shapes_full_size(ref, arch):
    """Full-width shapes without allocating (the meta device)."""
    mine = TM.param_shapes(tconfigs.get(arch))
    theirs = ref.M.param_shapes(ref.configs.get(arch))
    flat_t, _ = ref.jax.tree_util.tree_flatten(theirs)
    flat_m = [tuple(s) for _, s in _walk(mine)]
    assert flat_m == [tuple(s.shape) for s in flat_t]


def _walk(tree, path=()):
    """(path, leaf) in sorted-key order, `torch.Size` leaves kept whole."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ("qwen3-4b", "qwen2.5-3b", "granite-34b"))
def test_forward_logits(ref, arch, dtype):
    tcfg, rcfg = _cfgs(ref, arch)
    _, npp = _ref_params(ref, rcfg, seed=6)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 24)
                                               ).astype(np.int32)
    got, caches = TM.forward(TM.params_from_numpy(npp, "cpu"), tcfg,
                             _t(tokens), compute_dtype=getattr(torch, dtype),
                             collect_caches=True)
    want, rcaches = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens),
                                  compute_dtype=getattr(ref.jnp, dtype),
                                  collect_caches=True)
    want = _np(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_logits_close(got.numpy(), want, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_f(caches[0][0]), _np(rcaches[0][0]),
                                   atol=ATOL, rtol=RTOL)
    else:
        assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step(ref, arch, compressed, dtype):
    tcfg, rcfg = _cfgs(ref, arch)
    _, npp = _ref_params(ref, rcfg, seed=7)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                              compute_dtype=getattr(ref.jnp, dtype))
    prompt = np.random.default_rng(7).integers(0, tcfg.vocab, (2, 11)
                                               ).astype(np.int32)
    _, rcaches, plen = ref.E.prefill(rp, rcfg, ref.jnp.asarray(prompt),
                                     rscfg)
    caches = _caches_to_port(rcaches)
    token = np.array([[3], [77]], np.int32)
    got, caches = TM.decode_step(TM.params_from_numpy(npp, "cpu"), tcfg,
                                 _t(token), caches, plen,
                                 compute_dtype=getattr(torch, dtype),
                                 compressed_kv=compressed)
    want, rcaches = ref.M.decode_step(rp, rcfg, ref.jnp.asarray(token),
                                      rcaches, ref.jnp.int32(plen),
                                      compute_dtype=getattr(ref.jnp, dtype),
                                      compressed_kv=compressed)
    _assert_logits_close(got.numpy(), _np(want), dtype)
    k, rk = caches.entries[0][0], rcaches.entries[0][0]
    if compressed:
        k = TKV.kv_dequantize(k, 2, torch.float32)
        rk = ref.KV.kv_dequantize(rk, 2, ref.jnp.float32)
        atol = float(np.asarray(rcaches.entries[0][0].scale).max()) + ATOL
    else:
        atol = ATOL if dtype == "float32" else 0.05
    np.testing.assert_allclose(_f(k), _np(rk).astype(np.float32), atol=atol,
                               rtol=RTOL)


def _caches_to_port(rcaches, device="cpu"):
    """The reference's DecodeCaches -> the port's: GQA (k, v) pairs, MLA
    latents and MambaStates, dense or QuantKV, carried as numpy."""
    def one(c):
        if hasattr(c, "q"):
            return TKV.QuantKV(_t(c.q, device), _t(c.scale, device))
        if hasattr(c, "h"):
            return tssm.MambaState(_t(c.h, device), _t(c.conv, device))
        if isinstance(c, tuple):
            return tuple(one(x) for x in c)
        return _t(c, device)
    return TM.DecodeCaches(tuple(one(e) for e in rcaches.entries))


def _cache_leaves(entries):
    """Every tensor of a cache tree, in order (QuantKV as q then scale)."""
    for e in entries:
        if isinstance(e, tuple):
            yield from _cache_leaves(e)
        else:
            yield e


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("arch", DENSE)
def test_generate_tokens_f32(ref, arch, compressed):
    tcfg, rcfg = _cfgs(ref, arch)
    _, npp = _ref_params(ref, rcfg, seed=8)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, (2, 13)
                                               ).astype(np.int32)
    scfg = TE.ServeConfig(s_max=256, compressed_kv=compressed,
                          compute_dtype=torch.float32)
    rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                              compute_dtype=ref.jnp.float32)
    got = TE.generate(TM.params_from_numpy(npp, "cpu"), tcfg, _t(prompt), 6,
                      scfg)
    want = ref.E.generate(rp, rcfg, ref.jnp.asarray(prompt), 6, rscfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_patch_embeds_prepend(ref):
    """phi-3-vision's stub frontend: precomputed patch embeddings are
    prepended, and prefill counts them in the prompt length."""
    tcfg, rcfg = _cfgs(ref, "phi-3-vision-4.2b", 1)
    _, npp = _ref_params(ref, rcfg, seed=9)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, tcfg.vocab, (1, 6)).astype(np.int32)
    patch = rng.standard_normal((1, 8, tcfg.d_model)).astype(np.float32)
    got, _ = TM.forward(TM.params_from_numpy(npp, "cpu"), tcfg, _t(tokens),
                        {"patch_embeds": _t(patch)},
                        compute_dtype=torch.float32)
    want, _ = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens),
                            {"patch_embeds": ref.jnp.asarray(patch)},
                            compute_dtype=ref.jnp.float32)
    assert got.shape[1] == 14
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", MOE_MLA_SSM)
def test_params_from_numpy_moe_mla_ssm(ref, arch):
    """MoE, MLA and Mamba trees: the reference's leaf names, paths and
    shapes carry across, and `init_params` draws the same tree."""
    tcfg, rcfg = _cfgs(ref, arch, 1)
    rp, npp = _ref_params(ref, rcfg)
    flat, _ = ref.jax.tree_util.tree_flatten_with_path(rp)
    theirs = [(TCK._leaf_key(tuple(getattr(k, "key", getattr(k, "idx", k))
                                   for k in p)), tuple(v.shape))
              for p, v in flat]
    mine = TM.params_from_numpy(npp, "cpu")
    own = TM.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for tree in (mine, own):
        assert [(TCK._leaf_key(p), tuple(v.shape))
                for p, v in TCK._leaves_with_path(tree)] == theirs


@pytest.mark.parametrize("arch", MOE_MLA_SSM)
def test_forward_logits_moe_mla_ssm(ref, arch):
    """f32 logits and collected caches (GQA K, MLA latent, Mamba state)
    on the reference's weights."""
    tcfg, rcfg = _cfgs(ref, arch, 1)
    _, npp = _ref_params(ref, rcfg, seed=12)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    tokens = np.random.default_rng(12).integers(0, tcfg.vocab, (2, 32)
                                                ).astype(np.int32)
    got, caches = TM.forward(TM.params_from_numpy(npp, "cpu"), tcfg,
                             _t(tokens), compute_dtype=torch.float32,
                             collect_caches=True)
    want, rcaches = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens),
                                  compute_dtype=ref.jnp.float32,
                                  collect_caches=True)
    _assert_logits_close(got.numpy(), _np(want), "float32")
    mine = list(_cache_leaves(caches))
    theirs = ref.jax.tree.leaves(rcaches)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_f(a), _np(b).astype(np.float32),
                                   atol=ATOL, rtol=RTOL)


def test_forward_logits_mamba2_bf16(ref):
    """bf16 without routing (no MoE): the stated bf16 bound, and 90% of
    the argmaxes agree."""
    tcfg, rcfg = _cfgs(ref, "mamba2-1.3b")
    _, npp = _ref_params(ref, rcfg, seed=13)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    tokens = np.random.default_rng(13).integers(0, tcfg.vocab, (2, 64)
                                                ).astype(np.int32)
    got, _ = TM.forward(TM.params_from_numpy(npp, "cpu"), tcfg, _t(tokens))
    want = _np(ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens))[0])
    _assert_logits_close(got.numpy(), want, "bfloat16")
    assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("arch", MOE_MLA_SSM)
def test_decode_step_moe_mla_ssm(ref, arch, compressed):
    """One f32 step from the reference's prefill caches: logits, and the
    caches it writes (latents and GQA K dequantized within a scale when
    compressed; Mamba states within ATOL / RTOL)."""
    tcfg, rcfg = _cfgs(ref, arch, 1)
    _, npp = _ref_params(ref, rcfg, seed=14)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                              compute_dtype=ref.jnp.float32)
    prompt = np.random.default_rng(14).integers(0, tcfg.vocab, (2, 11)
                                                ).astype(np.int32)
    _, rcaches, plen = ref.E.prefill(rp, rcfg, ref.jnp.asarray(prompt),
                                     rscfg)
    caches = _caches_to_port(rcaches)
    token = np.array([[3], [77]], np.int32)
    got, caches = TM.decode_step(TM.params_from_numpy(npp, "cpu"), tcfg,
                                 _t(token), caches, plen,
                                 compute_dtype=torch.float32,
                                 compressed_kv=compressed)
    want, rcaches = ref.M.decode_step(rp, rcfg, ref.jnp.asarray(token),
                                      rcaches, ref.jnp.int32(plen),
                                      compute_dtype=ref.jnp.float32,
                                      compressed_kv=compressed)
    _assert_logits_close(got.numpy(), _np(want), "float32")
    for mine, theirs in zip(caches.entries, rcaches.entries):
        if isinstance(mine, tssm.MambaState):
            pairs = [(mine.h, theirs.h), (mine.conv, theirs.conv)]
        elif isinstance(mine, (TKV.QuantKV, torch.Tensor)):     # MLA
            pairs = [(mine, theirs)]
        else:                                                   # (k, v)
            pairs = list(zip(mine, theirs))
        for a, b in pairs:
            atol = ATOL
            if isinstance(a, TKV.QuantKV):
                atol += float(np.asarray(b.scale).max())
                a = TKV.kv_dequantize(a, 2, torch.float32)
                b = ref.KV.kv_dequantize(b, 2, ref.jnp.float32)
            np.testing.assert_allclose(_f(a), _np(b).astype(np.float32),
                                       atol=atol, rtol=RTOL)


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("arch", MOE_MLA_SSM)
def test_generate_tokens_f32_moe_mla_ssm(ref, arch, compressed):
    tcfg, rcfg = _cfgs(ref, arch, 1)
    _, npp = _ref_params(ref, rcfg, seed=15)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    prompt = np.random.default_rng(15).integers(0, tcfg.vocab, (2, 13)
                                                ).astype(np.int32)
    scfg = TE.ServeConfig(s_max=256, compressed_kv=compressed,
                          compute_dtype=torch.float32)
    rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                              compute_dtype=ref.jnp.float32)
    got = TE.generate(TM.params_from_numpy(npp, "cpu"), tcfg, _t(prompt), 6,
                      scfg)
    want = ref.E.generate(rp, rcfg, ref.jnp.asarray(prompt), 6, rscfg)
    np.testing.assert_array_equal(got.numpy(), _np(want).astype(np.int32))


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced("qwen3-4b", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_caches(cfg, 1, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.params_from_numpy({"w": np.zeros(2, np.float32)})


def test_cast_params_casts_once_and_keeps_norms_f32():
    cfg = tconfigs.reduced("qwen2.5-3b", 1)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    c = TM.cast_params(p, torch.bfloat16)
    assert c["embed"].dtype == torch.bfloat16
    assert c["layers"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert c["out_norm"].dtype == torch.float32
    assert c["layers"][0]["pre_norm"] is p["layers"][0]["pre_norm"]
    again = TM.cast_params(c, torch.bfloat16)
    assert again["embed"] is c["embed"]           # no second copy
    tokens = torch.randint(0, cfg.vocab, (1, 9))
    a, _ = TM.forward(p, cfg, tokens)
    b, _ = TM.forward(c, cfg, tokens)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_generate_on_card(cuda_dev, ref, arch, dtype):
    """The card against the reference (JAX on the CPU) on the same numpy
    weights and tokens: `forward` logits and `decode_step` from the
    reference's prefill caches (dense and compressed) within the
    tolerances stated above for f32 and for bf16, and in f32 identical
    greedy tokens from `generate`."""
    tcfg, rcfg = _cfgs(ref, arch)
    _, npp = _ref_params(ref, rcfg, seed=10)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    card = TM.params_from_numpy(npp, cuda_dev)
    cdt, rdt = getattr(torch, dtype), getattr(ref.jnp, dtype)
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab, (2, 13)
                                                ).astype(np.int32)
    got, _ = TM.forward(card, tcfg, _t(tokens, cuda_dev), compute_dtype=cdt)
    want, _ = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens),
                            compute_dtype=rdt)
    assert got.is_cuda
    _assert_logits_close(_f(got), _np(want), dtype)
    if dtype == "bfloat16":
        assert (_f(got).argmax(-1) == _np(want).argmax(-1)).mean() >= 0.9
    token = np.array([[3], [77]], np.int32)
    for compressed in (False, True):
        rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                                  compute_dtype=rdt)
        _, rcaches, plen = ref.E.prefill(rp, rcfg, ref.jnp.asarray(tokens),
                                         rscfg)
        got, _ = TM.decode_step(card, tcfg, _t(token, cuda_dev),
                                _caches_to_port(rcaches, cuda_dev), plen,
                                compute_dtype=cdt, compressed_kv=compressed)
        want, _ = ref.M.decode_step(rp, rcfg, ref.jnp.asarray(token),
                                    rcaches, ref.jnp.int32(plen),
                                    compute_dtype=rdt,
                                    compressed_kv=compressed)
        _assert_logits_close(_f(got), _np(want), dtype)
        if dtype == "float32":
            scfg = TE.ServeConfig(s_max=256, compressed_kv=compressed,
                                  compute_dtype=cdt)
            toks = TE.generate(card, tcfg, _t(tokens, cuda_dev), 6, scfg)
            rtoks = ref.E.generate(rp, rcfg, ref.jnp.asarray(tokens), 6,
                                   rscfg)
            np.testing.assert_array_equal(toks.cpu().numpy(), _np(rtoks))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_MLA_SSM)
def test_moe_mla_ssm_on_card(cuda_dev, ref, arch):
    """MoE, MLA and Mamba models on the card against the reference (JAX
    on the CPU): f32 logits within ATOL / RTOL and identical greedy
    tokens from `generate`, dense and compressed; the bf16 bound for the
    model without routing (mamba2: MoE archs hold bf16 at the layer, on
    the rows whose experts agree, in test_torch_moe_ssm.py)."""
    tcfg, rcfg = _cfgs(ref, arch, 1)
    _, npp = _ref_params(ref, rcfg, seed=16)
    rp = ref.jax.tree.map(ref.jnp.asarray, npp)
    card = TM.params_from_numpy(npp, cuda_dev)
    tokens = np.random.default_rng(16).integers(0, tcfg.vocab, (2, 13)
                                                ).astype(np.int32)
    got, _ = TM.forward(card, tcfg, _t(tokens, cuda_dev),
                        compute_dtype=torch.float32)
    want, _ = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens),
                            compute_dtype=ref.jnp.float32)
    assert got.is_cuda
    _assert_logits_close(_f(got), _np(want), "float32")
    if arch == "mamba2-1.3b":
        got, _ = TM.forward(card, tcfg, _t(tokens, cuda_dev))
        want, _ = ref.M.forward(rp, rcfg, ref.jnp.asarray(tokens))
        _assert_logits_close(_f(got), _np(want), "bfloat16")
    for compressed in (False, True):
        scfg = TE.ServeConfig(s_max=256, compressed_kv=compressed,
                              compute_dtype=torch.float32)
        rscfg = ref.E.ServeConfig(s_max=256, compressed_kv=compressed,
                                  compute_dtype=ref.jnp.float32)
        toks = TE.generate(card, tcfg, _t(tokens, cuda_dev), 6, scfg)
        rtoks = ref.E.generate(rp, rcfg, ref.jnp.asarray(tokens), 6, rscfg)
        np.testing.assert_array_equal(toks.cpu().numpy(), _np(rtoks))
