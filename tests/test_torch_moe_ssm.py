"""Port parity for the MoE, MLA and Mamba2/SSD layers
(`repro_torch.models.{moe,ssm}`, `attention.mla_*`) against the
reference's `repro.models`, on the CPU at reduced widths:

  * `moe_forward` with no drops (capacity factor 8, the reduced
    configs') and with drops (capacity factor 1.0), where the kept set
    and the dispatch slots equal the reference's exactly; top-k on
    forced ties; bf16 on the rows whose expert set agrees;
  * `mla_forward`; `mla_decode` dense and compressed, with per-row
    lengths against the reference's one-row calls (compressed: its
    jitted form);
  * `mamba_forward` in one segment and across two, `mamba_decode`, and
    the reference's length asserts;
  * `cast_params` keeps ``A_log``, ``D`` and ``dt_bias`` in f32;
  * teacher-forced `forward` against step-by-step `decode_step` for
    moonshot, deepseek, mamba2 and jamba (the reference's
    `test_arch_smoke::test_agreement`), the forward also against the
    reference's on the same weights;
  * every one of the ten archs through `init_params`, `forward`,
    `init_caches`, `decode_step`, `generate` and `run_continuous` (bar
    phi-3-vision's scheduler run, which fails in the reference too).

Tolerances: f32 within atol = rtol = 1e-4 (ATOL / RTOL, as in
test_torch_models.py); the agreement test within 2e-2 as the
reference's.  bf16 within 0.05 absolute plus 5% of the reference's
range, on the rows compared: MoE routing is discontinuous, so in bf16 a
token whose top-k set differs between the packages (a near-tie rounded
differently) is not compared, and at most a tenth of the tokens may
differ so.  `_softplus` is the reference's ``logaddexp(x, 0)`` and
agrees with ``jax.nn.softplus`` within two ulp (the two libms' `exp` and
`log1p` differ; `F.softplus` returns x above 20 instead).

The `ref` fixture imports the reference with an unarmed
`repro.dist.chaos` stand-in and removes every `repro*` module it added
at teardown (see test_torch_models.py).  The `cuda` tests at the end
hold the same layers on the card to the reference (JAX on the CPU).
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
from repro_torch.dist import context as tctx
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as TE
from repro_torch.serve import scheduler as TS
from repro_torch.tree import tree_map

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported with an unarmed `repro.dist.chaos`
    stand-in; every `repro*` module this import added leaves
    `sys.modules` again at teardown."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    before = set(sys.modules)
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    sys.modules["repro.dist.chaos"] = stub
    names = {"jax": "jax", "jnp": "jax.numpy", "configs": "repro.configs",
             "M": "repro.models.model", "attn": "repro.models.attention",
             "moe": "repro.models.moe", "ssm": "repro.models.ssm",
             "KV": "repro.core.kvcache"}
    try:
        yield types.SimpleNamespace(**{k: importlib.import_module(v)
                                       for k, v in names.items()})
    finally:
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


def _t(a, device="cpu"):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _f(t):
    return t.detach().float().cpu().numpy()


def _np(x):
    return np.asarray(x).astype(np.float32)


def _cfgs(ref, arch, n_periods=1, **moe_changes):
    tcfg = tconfigs.reduced(arch, n_periods)
    rcfg = ref.configs.reduced(arch, n_periods)
    if moe_changes:
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_changes))
        rcfg = dataclasses.replace(
            rcfg, moe=dataclasses.replace(rcfg.moe, **moe_changes))
    return tcfg, rcfg


def _layer(ref, rcfg, key: str, seed: int, position: int = 0):
    """One layer's sub-tree (`key`: "attn", "moe" or "mamba") of the
    reference's parameters at `position`, period 0: (reference, port)."""
    rp = ref.M.init_params(ref.jax.random.PRNGKey(seed), rcfg)
    sub = ref.jax.tree.map(lambda a: a[0], rp["layers"][position][key])
    return sub, TM.params_from_numpy(ref.jax.tree.map(np.asarray, sub),
                                     "cpu")


def _assert_bf16_close(got, want, rows=None):
    """The stated bf16 bound, on `rows` (a boolean mask over the leading
    axes) when given."""
    if rows is not None:
        got, want = got[rows], want[rows]
    span = float(want.max() - want.min())
    assert float(np.abs(got - want).max()) <= 0.05 + 0.05 * span


def _same_dequantized(mine, theirs, ref):
    """A written QuantKV cache against the reference's: dequantized, within
    the largest block scale (one quantization step: the new entry's
    values, and so its widened scale, differ in the last bits between
    the packages' matmuls) plus ATOL, as test_gqa_decode compares."""
    np.testing.assert_allclose(
        _f(TKV.kv_dequantize(mine, 1, torch.float32)),
        _np(ref.KV.kv_dequantize(theirs, 1, ref.jnp.float32)),
        atol=float(np.asarray(theirs.scale).max()) + ATOL, rtol=0)


def _ref_routing(ref, p_ref, rcfg, x):
    """The reference's routing of x, step by step as `moe_forward`
    computes it (the module returns only the combined output): top-k
    experts, the kept set and the dispatch slots."""
    jax, jnp = ref.jax, ref.jnp
    m = rcfg.moe
    B, S, _ = x.shape
    E, k = m.n_experts, m.top_k
    A = S * k
    logits = jnp.einsum("bsd,de->bse", x, p_ref["router"].astype(x.dtype)
                        ).astype(jnp.float32)
    _, eidx = jax.lax.top_k(logits, k)
    flat_e = eidx.reshape(B, A)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    counts = jax.vmap(lambda e: jnp.bincount(e, length=E))(se)
    starts = jnp.cumsum(counts, axis=1) - counts
    rank = jnp.arange(A)[None, :] - jnp.take_along_axis(starts, se, axis=1)
    cap = min(max(8, int(A / E * m.capacity_factor)), A)
    keep = rank < cap
    slot = jnp.where(keep, se * cap + rank, E * cap)
    return np.asarray(eidx), np.asarray(keep), np.asarray(slot)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cf", [("moonshot-v1-16b-a3b", None),
                                     ("deepseek-v2-236b", None),
                                     ("deepseek-v2-236b", 1.0)])
def test_moe_forward(ref, arch, cf):
    """No drops at the reduced configs' capacity factor 8; at 1.0 tokens
    are dropped, and the kept set and slots are the reference's."""
    tcfg, rcfg = _cfgs(ref, arch, **({} if cf is None else
                                     {"capacity_factor": cf}))
    p_ref, p = _layer(ref, rcfg, "moe", seed=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32)
    r = tmoe.route(p, tcfg, _t(x))
    eidx, keep, slot = _ref_routing(ref, p_ref, rcfg, ref.jnp.asarray(x))
    np.testing.assert_array_equal(r.eidx.numpy(), eidx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    assert bool(keep.all()) == (cf is None)        # cf 1.0 drops tokens
    got = tmoe.moe_forward(p, tcfg, _t(x))
    want = ref.moe.moe_forward(p_ref, rcfg, ref.jnp.asarray(x))
    np.testing.assert_allclose(_f(got), _np(want), atol=ATOL, rtol=RTOL)


def test_moe_top_k_ties_keep_the_lower_expert_first(ref):
    """Router columns duplicated, so experts (1, 3) and (2, 5) tie
    exactly on every token: the port's top-k order (and so the routing
    and output) is `jax.lax.top_k`'s, lower index first."""
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b")
    p_ref, p = _layer(ref, rcfg, "moe", seed=2)
    router = np.asarray(p_ref["router"]).copy()
    router[:, 3], router[:, 5] = router[:, 1], router[:, 2]
    router[:, 1] += 0.5                    # make the tied pair win often
    router[:, 3] += 0.5
    p_ref = dict(p_ref, router=ref.jnp.asarray(router))
    p = dict(p, router=_t(router))
    x = np.random.default_rng(2).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    r = tmoe.route(p, tcfg, _t(x))
    eidx, keep, slot = _ref_routing(ref, p_ref, rcfg, ref.jnp.asarray(x))
    np.testing.assert_array_equal(r.eidx.numpy(), eidx)
    chosen = r.eidx.numpy()
    assert ((chosen == 1) & (np.roll(chosen, -1, -1) == 3)).any()
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    got = tmoe.moe_forward(p, tcfg, _t(x))
    want = ref.moe.moe_forward(p_ref, rcfg, ref.jnp.asarray(x))
    np.testing.assert_allclose(_f(got), _np(want), atol=ATOL, rtol=RTOL)


def _moe_bf16(ref, device):
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b")
    p_ref, p = _layer(ref, rcfg, "moe", seed=3)
    p = tree_map(lambda t: t.to(device), p)
    x = ref.jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)).astype(ref.jnp.bfloat16)
    got = _f(tmoe.moe_forward(p, tcfg, _t(x, device)))
    want = _np(ref.moe.moe_forward(p_ref, rcfg, x))
    mine = np.sort(tmoe.route(p, tcfg, _t(x, device)).eidx.cpu().numpy(), -1)
    theirs = np.sort(_ref_routing(ref, p_ref, rcfg, x)[0], -1)
    same = (mine == theirs).all(-1)                  # [B, S]
    assert same.mean() >= 0.9, same.mean()
    _assert_bf16_close(got, want, same)


def test_moe_bf16_on_rows_whose_experts_agree(ref):
    _moe_bf16(ref, "cpu")


def test_moe_a2a_hook_is_inert_without_a_mesh(ref):
    """As in the reference, the armed all-to-all hook acts only under a
    mesh, so without one `moe_forward` runs its plain path."""
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b")
    _, p = _layer(ref, rcfg, "moe", seed=4)
    x = torch.randn(1, 8, tcfg.d_model)
    plain = tmoe.moe_forward(p, tcfg, x)
    with tctx.use_a2a_compress("int8-block"):
        assert not tctx.a2a_compress_active()
        assert torch.equal(tmoe.moe_forward(p, tcfg, x), plain)
    with pytest.raises(ValueError, match="unknown compression codec"):
        with tctx.use_a2a_compress("no-such-codec"):
            pass


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_forward(ref):
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b")
    p_ref, p = _layer(ref, rcfg, "attn", seed=5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    out, lat = tattn.mla_forward(p, tcfg, _t(x), _t(pos))
    rout, rlat = ref.attn.mla_forward(p_ref, rcfg, ref.jnp.asarray(x),
                                      ref.jnp.asarray(pos))
    assert tuple(lat.shape) == (2, 20, 32 + 8)
    for a, b in ((out, rout), (lat, rlat)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("compressed", (False, True))
def test_mla_decode_per_row_lengths(ref, compressed):
    """One batched call with a length per row against the reference's
    one-row calls at each row's length (the scheduler's ragged slots);
    the compressed reference runs jitted, as its serve steps do."""
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b")
    p_ref, p = _layer(ref, rcfg, "attn", seed=6)
    rng = np.random.default_rng(6)
    lens = np.array([140, 7, 255])
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    cache = rng.standard_normal((3, 256, 40)).astype(np.float32)
    for b, n in enumerate(lens):
        cache[b, n:] = 0.0
    if compressed:
        rc = ref.KV.kv_quantize(ref.jnp.asarray(cache), 1)
        mine = TKV.QuantKV(_t(rc.q), _t(rc.scale))
    else:
        rc, mine = ref.jnp.asarray(cache), _t(cache)
    out, back = tattn.mla_decode(p, tcfg, _t(x), mine, torch.as_tensor(lens),
                                 compressed=compressed)
    assert back is mine                      # written in place
    step = ref.jax.jit(ref.attn.mla_decode, static_argnums=(1, 5))
    for b, n in enumerate(lens):
        one = ref.jax.tree.map(lambda a: a[b:b + 1], rc)
        rout, rnew = step(p_ref, rcfg, ref.jnp.asarray(x[b:b + 1]), one,
                          ref.jnp.int32(n), compressed)
        np.testing.assert_allclose(_f(out[b:b + 1]), _np(rout), atol=ATOL,
                                   rtol=RTOL)
        if compressed:
            _same_dequantized(TKV.QuantKV(mine.q[b:b + 1],
                                          mine.scale[b:b + 1]), rnew, ref)
        else:
            np.testing.assert_allclose(_f(mine[b:b + 1]), _np(rnew),
                                       atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", (12, 64, 1024))
def test_mamba_forward(ref, seq):
    """Shorter than one chunk (12), four chunks in one segment (64) and
    64 chunks in two segments of 32 (1024): output and final state."""
    tcfg, rcfg = _cfgs(ref, "mamba2-1.3b")
    p_ref, p = _layer(ref, rcfg, "mamba", seed=7)
    x = np.random.default_rng(7).standard_normal(
        (2 if seq < 1024 else 1, seq, tcfg.d_model)).astype(np.float32)
    out, st = tssm.mamba_forward(p, tcfg, _t(x))
    rout, rst = ref.ssm.mamba_forward(p_ref, rcfg, ref.jnp.asarray(x))
    for a, b in ((out, rout), (st.h, rst.h), (st.conv, rst.conv)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


def test_mamba_forward_lengths_are_the_reference_asserts(ref):
    """No padding: a prompt longer than one chunk must be whole chunks,
    and over 32 chunks whole 32-chunk segments (trap: 40 tokens at chunk
    16 fail in both packages)."""
    tcfg, rcfg = _cfgs(ref, "mamba2-1.3b")
    p_ref, p = _layer(ref, rcfg, "mamba", seed=8)
    for seq in (40, 16 * 33):
        x = np.zeros((1, seq, tcfg.d_model), np.float32)
        with pytest.raises(AssertionError):
            tssm.mamba_forward(p, tcfg, _t(x))
        with pytest.raises(AssertionError):
            ref.ssm.mamba_forward(p_ref, rcfg, ref.jnp.asarray(x))


def test_mamba_decode(ref):
    tcfg, rcfg = _cfgs(ref, "mamba2-1.3b")
    p_ref, p = _layer(ref, rcfg, "mamba", seed=9)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    _, rst = ref.ssm.mamba_forward(
        p_ref, rcfg, ref.jnp.asarray(rng.standard_normal(
            (2, 16, tcfg.d_model)).astype(np.float32)))
    st = tssm.MambaState(_t(rst.h), _t(rst.conv))
    out, new = tssm.mamba_decode(p, tcfg, _t(x), st)
    rout, rnew = ref.ssm.mamba_decode(p_ref, rcfg, ref.jnp.asarray(x), rst)
    for a, b in ((out, rout), (new.h, rnew.h), (new.conv, rnew.conv)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


def test_softplus_is_logaddexp(ref):
    """`_softplus` against `jax.nn.softplus` across its range, beyond the
    threshold of 20 where `F.softplus` switches to x: within two ulp."""
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.float32([-1e-3, 0.0, 1e-3, 19.99, 20.01, 88.0])])
    got = tssm._softplus(_t(x)).numpy()
    want = np.asarray(ref.jax.nn.softplus(ref.jnp.asarray(x)))
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()


def test_cast_params_keeps_the_mamba_f32_leaves():
    """`A_log`, `D` and `dt_bias` stay f32 after the bf16 cast (the
    reference reads them in f32 against an f32 dt); the bf16 prefill and
    decode step from the cast tree equal those from the f32 tree."""
    cfg = tconfigs.reduced("mamba2-1.3b", 1)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    c = TM.cast_params(p, torch.bfloat16)
    m = c["layers"][0]["mamba"]
    for key in ("A_log", "D", "dt_bias", "gate_norm"):
        assert m[key].dtype == torch.float32, key
        assert m[key] is p["layers"][0]["mamba"][key]
    for key in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert m[key].dtype == torch.bfloat16, key
    tokens = torch.randint(0, cfg.vocab, (2, 16))
    a, ca = TM.forward(p, cfg, tokens, collect_caches=True)
    b, cb = TM.forward(c, cfg, tokens, collect_caches=True)
    assert torch.equal(a, b)
    step = torch.tensor([[3], [9]])
    a, _ = TM.decode_step(p, cfg, step, TM.DecodeCaches(ca), 16)
    b, _ = TM.decode_step(c, cfg, step, TM.DecodeCaches(cb), 16)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model: teacher-forced forward against step-by-step decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b"))
def test_agreement(ref, arch):
    """The reference's `test_arch_smoke::test_agreement` on the port: the
    f32 forward over 12 tokens equals 12 single-token decode steps from
    empty caches (within the reference's 2e-2), and equals the
    reference's forward on the same weights (within ATOL / RTOL)."""
    tcfg, rcfg = _cfgs(ref, arch, n_periods=2)
    rp = ref.M.init_params(ref.jax.random.PRNGKey(3), rcfg)
    p = TM.params_from_numpy(ref.jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (1, 12)
                                             ).astype(np.int32)
    full, _ = TM.forward(p, tcfg, _t(toks), compute_dtype=torch.float32)
    want, _ = ref.M.forward(rp, rcfg, ref.jnp.asarray(toks),
                            compute_dtype=ref.jnp.float32)
    np.testing.assert_allclose(full.numpy(), _np(want), atol=ATOL, rtol=RTOL)
    caches = TM.init_caches(tcfg, 1, 32, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(12):
        lg, caches = TM.decode_step(p, tcfg, _t(toks[:, t:t + 1]), caches, t,
                                    compute_dtype=torch.float32)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_every_arch_runs_every_entry_point(arch):
    """Each of the ten archs, reduced, on the CPU through every model and
    serve entry point: finite f32 logits of the expected shapes, tokens
    in range, and the continuous scheduler finishing three requests on
    a two-slot, two-page pool (parity with the reference: the tests
    above, test_torch_models.py and test_torch_serve.py).  phi-3-vision
    serves with its patch embeddings; the scheduler, which has none to
    give, fails on it as the reference's does."""
    cfg = tconfigs.reduced(arch, 1)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(1, cfg.vocab, (3, 9),
                            generator=torch.Generator().manual_seed(1))
    logits, caches = TM.forward(params, cfg, prompts[:2],
                                compute_dtype=torch.float32,
                                collect_caches=True)
    assert tuple(logits.shape) == (2, 9, cfg.vocab)
    assert len(caches) == len(cfg.pattern)
    empty = TM.init_caches(cfg, 2, 128, dtype=torch.float32, device="cpu")
    step, _ = TM.decode_step(params, cfg, prompts[:2, :1], empty, 0,
                             compute_dtype=torch.float32)
    assert tuple(step.shape) == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
    scfg = TE.ServeConfig(s_max=128, compressed_kv=True,
                          compute_dtype=torch.float32)
    # prefill counts a VLM's prepended patch positions whether or not
    # patches are given (as the reference does), so it needs them
    extra = ({"patch_embeds": torch.zeros((2, cfg.n_prepend_embeds,
                                           cfg.d_model))}
             if cfg.n_prepend_embeds else None)
    toks = TE.generate(params, cfg, prompts[:2], 3, scfg, extra=extra)
    assert tuple(toks.shape) == (2, 3)
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    reqs = [TS.Request(rid=i, prompt=prompts[i].numpy(), max_new=3)
            for i in range(3)]
    sched_cfg = TS.SchedulerConfig(max_batch=2, pool_pages=2)
    if cfg.n_prepend_embeds:
        # the scheduler's prefill carries no patches: the reference's
        # fails the same way (its cache is not whole SEQ_BLOCKs)
        with pytest.raises(AssertionError):
            TS.run_continuous(params, cfg, scfg, sched_cfg, reqs)
        return
    fin, sched = TS.run_continuous(params, cfg, scfg, sched_cfg, reqs)
    assert sorted(fin) == [0, 1, 2]
    assert all(len(f["tokens"]) == 3 for f in fin.values())
    assert sched.pool.used_pages == 0 and not sched.states


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card(p, dev):
    return tree_map(lambda t: t.to(dev), p)


@pytest.mark.cuda
def test_layers_on_card(cuda_dev, ref):
    """The three layers on the card against the reference (JAX on the
    CPU) on the same numpy inputs, in f32 within ATOL / RTOL: MoE with
    drops (its kept set exactly the reference's), MLA prefill and a
    compressed per-row decode, Mamba
    prefill across two segments and a decode step."""
    dev = cuda_dev
    rng = np.random.default_rng(12)
    tcfg, rcfg = _cfgs(ref, "deepseek-v2-236b", capacity_factor=1.0)
    p_ref, p = _layer(ref, rcfg, "moe", seed=12)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    r = tmoe.route(_card(p, dev), tcfg, _t(x, dev))
    _, keep, slot = _ref_routing(ref, p_ref, rcfg, ref.jnp.asarray(x))
    np.testing.assert_array_equal(r.keep.cpu().numpy(), keep)
    np.testing.assert_array_equal(r.slot.cpu().numpy(), slot)
    got = tmoe.moe_forward(_card(p, dev), tcfg, _t(x, dev))
    assert got.is_cuda
    np.testing.assert_allclose(
        _f(got), _np(ref.moe.moe_forward(p_ref, rcfg, ref.jnp.asarray(x))),
        atol=ATOL, rtol=RTOL)

    p_ref, p = _layer(ref, rcfg, "attn", seed=13)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    out, lat = tattn.mla_forward(_card(p, dev), tcfg, _t(x[:, :20], dev),
                                 _t(pos, dev))
    rout, rlat = ref.attn.mla_forward(p_ref, rcfg,
                                      ref.jnp.asarray(x[:, :20]),
                                      ref.jnp.asarray(pos))
    for a, b in ((out, rout), (lat, rlat)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)
    cache = rng.standard_normal((2, 256, 40)).astype(np.float32)
    cache[:, 130:] = 0.0
    rc = ref.KV.kv_quantize(ref.jnp.asarray(cache), 1)
    mine = TKV.QuantKV(_t(rc.q, dev), _t(rc.scale, dev))
    lens = np.array([130, 3])
    out, _ = tattn.mla_decode(_card(p, dev), tcfg, _t(x[:, :1], dev), mine,
                              torch.as_tensor(lens, device=dev),
                              compressed=True)
    step = ref.jax.jit(ref.attn.mla_decode, static_argnums=(1, 5))
    for b, n in enumerate(lens):
        rout, rnew = step(p_ref, rcfg, ref.jnp.asarray(x[b:b + 1, :1]),
                          ref.jax.tree.map(lambda a: a[b:b + 1], rc),
                          ref.jnp.int32(n), True)
        np.testing.assert_allclose(_f(out[b:b + 1]), _np(rout), atol=ATOL,
                                   rtol=RTOL)
        _same_dequantized(TKV.QuantKV(mine.q[b:b + 1].cpu(),
                                      mine.scale[b:b + 1].cpu()), rnew, ref)

    tcfg, rcfg = _cfgs(ref, "mamba2-1.3b")
    p_ref, p = _layer(ref, rcfg, "mamba", seed=14)
    x = rng.standard_normal((1, 1024, tcfg.d_model)).astype(np.float32)
    out, st = tssm.mamba_forward(_card(p, dev), tcfg, _t(x, dev))
    rout, rst = ref.ssm.mamba_forward(p_ref, rcfg, ref.jnp.asarray(x))
    for a, b in ((out, rout), (st.h, rst.h), (st.conv, rst.conv)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)
    out, new = tssm.mamba_decode(_card(p, dev), tcfg, _t(x[:, :1], dev), st)
    rout, rnew = ref.ssm.mamba_decode(p_ref, rcfg, ref.jnp.asarray(x[:, :1]),
                                      rst)
    for a, b in ((out, rout), (new.h, rnew.h)):
        np.testing.assert_allclose(_f(a), _np(b), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_moe_bf16_on_card(cuda_dev, ref):
    """bf16 MoE on the card against the reference on the rows whose
    expert set agrees (at least 90% of them), within the bf16 bound."""
    _moe_bf16(ref, cuda_dev)
