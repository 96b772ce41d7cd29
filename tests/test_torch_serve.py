"""Port parity for the serving path (`repro_torch.serve`,
`repro_torch.dist.context`, `repro_torch.launch.serve`) against the
reference's `repro.serve` / `repro.dist.context`, on the CPU:

  * handoff — on the same cache tensors (the reference's prefill caches,
    carried over as numpy), `encode_handoff` packs byte-identical
    containers on all four wires, and each package's `reshard_caches`
    adopts or restores the other's handoff to identical QuantKV bits;
    the disaggregated path's f32 greedy tokens equal the reference's;
  * the reshard / eviction hooks, with arm-time validation and the
    explicit-disarm resolutions;
  * pool — the accounting invariants on seeded random traces, cold-first
    eviction, byte-identical cusz / fz eviction containers for one slab,
    the bad-codec rejection;
  * scheduler, in f32 — `run_continuous` tokens and preemption / evicted
    / restored counts equal the reference's on a tight pool with cusz
    eviction; the int8-block tight-pool run equals the big-pool run;
    `run_static` and "pool too small" behave as in the reference;
  * MLA latents and Mamba state (deepseek, mamba2, jamba): the "mla"
    and "state" handoff kinds byte-identical and resharding across the
    packages, disaggregated tokens, 4-D latent pages and leafless pages
    in the pool, and `run_continuous` counts and tokens on a tight pool
    with the state sidecar;
  * the `launch.serve` CLI at ``--reduced --device cpu``, every arch
    family.

Greedy tokens are compared exactly (f32 compute; the model's logits agree
within 1e-4, see test_torch_models.py).  Containers and QuantKV caches
are compared bit for bit.

The `ref` fixture imports the reference with an unarmed
`repro.dist.chaos` stand-in and removes every `repro*` module it added at
teardown (see test_torch_models.py).  The `cuda` tests at the end hold
the handoff and the scheduler on a card to the reference on the same
inputs (JAX on the CPU, imported lazily by the fixture).
"""
from __future__ import annotations

import copy
import importlib
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch.core import kvcache as TKV
from repro_torch.dist import context as tctx
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as TE
from repro_torch.serve import pool as TP
from repro_torch.serve import scheduler as TS

WIRES = ("int8-block", "cusz", "fz", "lossless")
SEQ_AXIS = 2


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
             "M": "repro.models.model", "E": "repro.serve.engine",
             "P": "repro.serve.pool", "S": "repro.serve.scheduler",
             "ctx": "repro.dist.context", "KV": "repro.core.kvcache",
             "codecs": "repro.codecs"}
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


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if a.dtype.name == "bfloat16" or str(a.dtype) == "torch.bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


class _Model:
    """One reduced dense model with the reference's weights in both
    packages, f32 compute."""

    def __init__(self, ref, arch="qwen2.5-3b", n_periods=1, seed=0,
                 device="cpu"):
        self.tcfg = tconfigs.reduced(arch, n_periods)
        self.rcfg = ref.configs.reduced(arch, n_periods)
        rp = ref.M.init_params(ref.jax.random.PRNGKey(seed), self.rcfg)
        self.rp = rp
        self.tp = TM.params_from_numpy(ref.jax.tree.map(np.asarray, rp),
                                       device)

    def scfgs(self, ref, compressed=True, s_max=256):
        return (TE.ServeConfig(s_max=s_max, compressed_kv=compressed,
                               compute_dtype=torch.float32),
                ref.E.ServeConfig(s_max=s_max, compressed_kv=compressed,
                                  compute_dtype=ref.jnp.float32))


@pytest.fixture(scope="module")
def model(ref):
    return _Model(ref)


# ---------------------------------------------------------------------------
# container / cache conversion between the packages
# ---------------------------------------------------------------------------

def _to_port(ref, c):
    return tcodecs.from_arrays(*ref.codecs.to_arrays(c))


def _to_ref(ref, c):
    return ref.codecs.from_arrays(*tcodecs.to_arrays(c))


def _handoff_to_port(ref, h):
    return TE.KVHandoff(h.kinds, tuple(
        tuple(tuple(_to_port(ref, p) for p in parts) for parts in entry)
        for entry in h.entries), h.plen, h.wire)


def _handoff_to_ref(ref, h):
    return ref.E.KVHandoff(h.kinds, tuple(
        tuple(tuple(_to_ref(ref, p) for p in parts) for parts in entry)
        for entry in h.entries), h.plen, h.wire)


def _caches_to_port(ref, rcaches, device="cpu"):
    """The reference's DecodeCaches -> the port's: GQA (k, v) pairs, MLA
    latents and MambaStates, dense or QuantKV."""
    def one(c):
        if isinstance(c, ref.KV.QuantKV):
            return TKV.QuantKV(_t(c.q, device), _t(c.scale, device))
        if hasattr(c, "h"):
            return tssm.MambaState(_t(c.h, device), _t(c.conv, device))
        if isinstance(c, tuple):
            return tuple(one(x) for x in c)
        return _t(c, device)
    return TM.DecodeCaches(tuple(one(e) for e in rcaches.entries))


def _cache_arrays(entries):
    """Every array of a cache tree in order (QuantKV: q, then scale;
    MambaState: h, then conv)."""
    for e in entries:
        if isinstance(e, tuple):
            yield from _cache_arrays(e)
        else:
            yield e


def _same_parts(ref, mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        ha, aa = tcodecs.to_arrays(a)
        hb, ab = ref.codecs.to_arrays(b)
        assert ha == hb
        assert sorted(aa) == sorted(ab)
        for k in aa:
            x, y = np.asarray(aa[k]), np.asarray(ab[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def _same_caches(mine, theirs):
    """Two packages' caches, bit for bit, whatever their entries."""
    a, b = list(_cache_arrays(mine.entries)), list(_cache_arrays(
        theirs.entries))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# handoff
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prefilled(ref, model):
    """The reference's compressed and dense prefill caches of one batch
    (plen 150: two SEQ_BLOCKs, the second partial)."""
    prompt = np.random.default_rng(0).integers(
        1, model.tcfg.vocab, (2, 150)).astype(np.int32)
    out = {}
    for compressed in (True, False):
        _, rscfg = model.scfgs(ref, compressed)
        last, caches, plen = ref.E.prefill(model.rp, model.rcfg,
                                           ref.jnp.asarray(prompt), rscfg)
        out[compressed] = (np.asarray(last), caches, plen)
    return prompt, out


@pytest.mark.parametrize("compressed", (True, False))
@pytest.mark.parametrize("wire", WIRES)
def test_handoff_containers_byte_identical(ref, model, prefilled, wire,
                                           compressed):
    _, runs = prefilled
    _, rcaches, plen = runs[compressed]
    scfg, rscfg = model.scfgs(ref, compressed)
    mine = TE.encode_handoff(_caches_to_port(ref, rcaches), model.tcfg, scfg,
                             plen=plen, wire=wire)
    mine_stats = dict(TE.LAST_HANDOFF_STATS)
    theirs = ref.E.encode_handoff(rcaches, model.rcfg, rscfg, plen=plen,
                                  wire=wire)
    assert mine.kinds == theirs.kinds and mine.plen == theirs.plen == plen
    assert mine.wire == theirs.wire == wire
    for me, th in zip(mine.entries, theirs.entries):
        for a, b in zip(me, th):
            _same_parts(ref, a, b)
    assert mine_stats == dict(ref.E.LAST_HANDOFF_STATS)


@pytest.mark.parametrize("wire", WIRES)
def test_reshard_cross_package(ref, model, prefilled, wire):
    """The port adopts / restores the reference's handoff and the
    reference the port's, to identical QuantKV bits; the adopt counts
    agree."""
    _, runs = prefilled
    _, rcaches, plen = runs[True]
    scfg, rscfg = model.scfgs(ref)
    rh = ref.E.encode_handoff(rcaches, model.rcfg, rscfg, plen=plen,
                              wire=wire)
    th = TE.encode_handoff(_caches_to_port(ref, rcaches), model.tcfg, scfg,
                           plen=plen, wire=wire)
    mine = TE.reshard_caches(_handoff_to_port(ref, rh), model.tcfg, scfg,
                             device="cpu")
    mine_stats = dict(TE.LAST_RESHARD_STATS)
    theirs = ref.E.reshard_caches(_handoff_to_ref(ref, th), model.rcfg,
                                  rscfg)
    assert mine_stats == dict(ref.E.LAST_RESHARD_STATS)
    assert mine_stats["adopted_quantkv"] == (2 if wire == "int8-block"
                                             else 0)
    _same_caches(mine, theirs)
    if wire == "int8-block":
        _same_caches(mine, rcaches)            # zero round trip


@pytest.mark.parametrize("wire", ("int8-block", "lossless"))
def test_reshard_dense_target(ref, model, prefilled, wire):
    _, runs = prefilled
    _, rcaches, plen = runs[False]
    scfg, rscfg = model.scfgs(ref, compressed=False)
    rh = ref.E.encode_handoff(rcaches, model.rcfg, rscfg, plen=plen,
                              wire=wire)
    mine = TE.reshard_caches(_handoff_to_port(ref, rh), model.tcfg, scfg,
                             device="cpu")
    _same_caches(mine, ref.E.reshard_caches(rh, model.rcfg, rscfg))
    assert mine.entries[0][0].dtype == torch.float32


@pytest.mark.parametrize("wire", WIRES)
def test_disaggregated_tokens_equal_reference(ref, model, prefilled, wire):
    prompt, runs = prefilled
    last, rcaches, plen = runs[True]
    scfg, rscfg = model.scfgs(ref)
    rh = ref.E.encode_handoff(rcaches, model.rcfg, rscfg, plen=plen,
                              wire=wire)
    want = ref.E.decode_tokens(model.rp, model.rcfg, rscfg,
                               ref.jnp.asarray(last),
                               ref.E.reshard_caches(rh, model.rcfg, rscfg),
                               rh.plen, 5)
    tlast, tcaches, tplen = TE.prefill(model.tp, model.tcfg, _t(prompt),
                                       scfg)
    th = TE.encode_handoff(tcaches, model.tcfg, scfg, plen=tplen, wire=wire)
    got = TE.decode_tokens(model.tp, model.tcfg, scfg, tlast,
                           TE.reshard_caches(th, model.tcfg, scfg,
                                             device="cpu"), th.plen, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if wire == "int8-block":
        # adoption is exact, so the split path equals the one-device path
        np.testing.assert_array_equal(
            got.numpy(), TE.generate(model.tp, model.tcfg, _t(prompt), 5,
                                     scfg).numpy())


def test_decode_tokens_leaves_callers_caches(model, ref):
    scfg, _ = model.scfgs(ref)
    prompt = torch.randint(1, model.tcfg.vocab, (1, 20), dtype=torch.int32)
    last, caches, plen = TE.prefill(model.tp, model.tcfg, prompt, scfg)
    before = TM.clone_caches(caches)
    a = TE.decode_tokens(model.tp, model.tcfg, scfg, last, caches, plen, 4)
    b = TE.decode_tokens(model.tp, model.tcfg, scfg, last, caches, plen, 4)
    assert torch.equal(a, b)
    for (k0, _), (k1, _) in zip(before.entries, caches.entries):
        assert torch.equal(k0.q, k1.q) and torch.equal(k0.scale, k1.scale)


def test_temperature_sampling_in_distribution():
    """Temperature sampling matches softmax(logits / T) in distribution
    (a seeded frequency check; draws are not the reference's)."""
    scfg = TE.ServeConfig(temperature=0.7)
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = TE.pick_token(logits, gen, scfg).numpy()
    freq = np.bincount(draws, minlength=4) / draws.size
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    greedy = TE.pick_token(torch.tensor([[1.0, 3.0, 3.0]]), None,
                           TE.ServeConfig())
    assert greedy.tolist() == [1]                 # first index on ties


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

def test_reshard_hook_arms_wire_and_validates(ref, model, prefilled):
    _, runs = prefilled
    _, rcaches, plen = runs[True]
    scfg, _ = model.scfgs(ref)
    caches = _caches_to_port(ref, rcaches)
    with tctx.use_kv_reshard_compress("cusz"):
        assert TE.encode_handoff(caches, model.tcfg, scfg,
                                 plen=plen).wire == "cusz"
        # explicit arg wins over the armed hook
        assert TE.encode_handoff(caches, model.tcfg, scfg, plen=plen,
                                 wire="fz").wire == "fz"
    with tctx.use_kv_reshard_compress(False):
        assert tctx.kv_reshard_codec() == "lossless"
        with ref.ctx.use_kv_reshard_compress(False):
            assert ref.ctx.kv_reshard_codec() == "lossless"
    with tctx.use_kv_reshard_compress(True):
        assert tctx.kv_reshard_codec() == "int8-block"
    assert tctx.kv_reshard_codec() is None
    assert TE.encode_handoff(caches, model.tcfg, scfg,
                             plen=plen).wire == "int8-block"
    for bad in ("no-such-codec", "zfp"):
        with pytest.raises(ValueError):
            tctx.use_kv_reshard_compress(bad)
        with pytest.raises(ValueError):
            ref.ctx.use_kv_reshard_compress(bad)


def test_evict_hook_resolution(ref):
    with tctx.use_kv_evict_codec("lossless"):
        assert TP.PagedKVPool(2, device="cpu").evict_codec == "lossless"
        assert TP.PagedKVPool(2, evict_codec="int8-block",
                              device="cpu").evict_codec == "int8-block"
    with tctx.use_kv_evict_codec(False):
        assert tctx.kv_evict_codec() == "int8-block"
        assert TP.PagedKVPool(2, device="cpu").evict_codec == "int8-block"
    with tctx.use_kv_evict_codec("int8"):
        assert tctx.kv_evict_codec() == "int8-block"
    assert TP.PagedKVPool(2, device="cpu").evict_codec == "cusz"
    with pytest.raises(ValueError):
        tctx.use_kv_evict_codec("cusz-i")
    with pytest.raises(ValueError):
        ref.ctx.use_kv_evict_codec("cusz-i")


def test_mesh_is_the_distribution_slice(model, ref, prefilled):
    _, runs = prefilled
    _, rcaches, plen = runs[True]
    scfg, _ = model.scfgs(ref)
    h = TE.encode_handoff(_caches_to_port(ref, rcaches), model.tcfg, scfg,
                          plen=plen)
    with pytest.raises(NotImplementedError, match="mesh"):
        TE.reshard_caches(h, model.tcfg, scfg, mesh=object(), device="cpu")
    assert tctx.current_mesh() is None and tctx.weight_gather_info() is None
    x = torch.ones(2)
    assert tctx.constrain(x, "dp") is x


def test_no_cuda_means_no_default_device(monkeypatch, model, ref,
                                         prefilled):
    _, runs = prefilled
    _, rcaches, plen = runs[True]
    scfg, _ = model.scfgs(ref)
    h = TE.encode_handoff(_caches_to_port(ref, rcaches), model.tcfg, scfg,
                          plen=plen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.reshard_caches(h, model.tcfg, scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.PagedKVPool(2)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3-4b", "--reduced"])


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------

def _slab_np(seed, n_blocks=1, heads=2, dim=4):
    return np.random.default_rng(seed).standard_normal(
        (1, 1, n_blocks * TKV.SEQ_BLOCK, heads, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def page_slab():
    qkv = TKV.kv_quantize(torch.from_numpy(_slab_np(0)), SEQ_AXIS)
    return TKV.kv_page_slice(qkv, SEQ_AXIS, 0)


def _check_invariants(pool):
    pids = [p.pid for t in pool._tables.values() for p in t if p.resident]
    assert len(pids) == len(set(pids)), f"double-allocated page: {pids}"
    assert pool.free_pages + pool.used_pages == pool.n_pages
    assert len(pids) == pool.used_pages
    assert not (set(pids) & set(pool._free)), "page both free and live"
    assert set(pids) | set(pool._free) <= set(range(pool.n_pages))
    assert pool.device_pids() == set(pids)
    st_ = pool.stats()
    assert st_["used"] == pool.used_pages and st_["free"] == pool.free_pages
    assert (st_["host_bytes"] > 0) == (st_["host_pages"] > 0)


@pytest.mark.parametrize("seed,n_pages", [(0, 1), (1, 3), (2, 5), (3, 9),
                                          (4, 2), (5, 7)])
def test_pool_random_trace_invariants(page_slab, seed, n_pages):
    rng = random.Random(seed)
    pool = TP.PagedKVPool(n_pages, evict_codec="int8-block",
                          source_dtype=torch.float32, device="cpu")
    next_sid = 0
    for _ in range(60):
        op = rng.choice(["admit", "grow", "evict", "restore", "release"])
        sids = pool.sequences()
        try:
            if op == "admit":
                sid = next_sid
                next_sid += 1
                pool.register(sid)
                for _ in range(rng.randint(1, 3)):
                    pool.append_page(sid, (page_slab,))
            elif op == "grow" and sids:
                pool.append_page(rng.choice(sids), (page_slab,))
            elif op == "evict" and sids:
                sid = rng.choice(sids)
                if pool.n_pages_of(sid):
                    pool.evict_page(sid, rng.randrange(pool.n_pages_of(sid)))
            elif op == "restore" and sids:
                sid = rng.choice(sids)
                if pool.n_pages_of(sid):
                    pool.restore_page(sid,
                                      rng.randrange(pool.n_pages_of(sid)))
            elif op == "release" and sids:
                pool.release(rng.choice(sids))
        except TP.PoolExhausted:
            pass
        _check_invariants(pool)
    for sid in pool.sequences():
        pool.release(sid)
    assert pool.used_pages == 0
    assert sorted(pool._free) == list(range(pool.n_pages))
    assert pool.stats()["host_bytes"] == 0


def test_pool_cold_first_and_exhaustion(page_slab):
    pool = TP.PagedKVPool(4, evict_codec="int8-block",
                          source_dtype=torch.float32, device="cpu")
    for sid in ("old", "hot"):
        pool.register(sid)
        pool.append_page(sid, (page_slab,))
        pool.append_page(sid, (page_slab,))
    pool.register("new")
    with pytest.raises(TP.PoolExhausted):
        pool.append_page("new", (page_slab,))
    pool.touch("hot")
    assert pool.evict_cold(2, exclude=()) == 2
    assert pool.n_resident("old") == 0       # the cold sequence went first
    assert pool.n_resident("hot") == 2
    with pytest.raises(ValueError, match="evicted"):
        pool.write_page("old", 0, (page_slab,))


@pytest.mark.parametrize("codec", ("int8-block", "cusz", "fz", "lossless"))
def test_pool_eviction_containers_match_reference(ref, codec):
    """The same slab evicted by each package's pool: byte-identical host
    containers; restored by each: identical page bits."""
    x = _slab_np(3, n_blocks=2)
    rq = ref.KV.kv_quantize(ref.jnp.asarray(x), SEQ_AXIS)
    tq = TKV.QuantKV(_t(rq.q), _t(rq.scale))
    pools = (TP.PagedKVPool(2, evict_codec=codec, source_dtype=torch.float32,
                            device="cpu"),
             ref.P.PagedKVPool(2, evict_codec=codec,
                               source_dtype=ref.jnp.float32))
    for pool, q, kv in ((pools[0], tq, TKV), (pools[1], rq, ref.KV)):
        pool.register("s")
        for i in range(2):
            pool.append_page("s", (kv.kv_page_slice(q, SEQ_AXIS, i),))
        assert pool.evict_sequence("s") == 2
    for pm, pr in zip(pools[0]._tables["s"], pools[1]._tables["s"]):
        _same_parts(ref, pm.host[0], pr.host[0])
    assert pools[0].host_bytes == pools[1].host_bytes > 0
    evicted = pools[0].host_bytes
    assert pools[0].ensure_resident("s") == pools[1].ensure_resident("s") == 2
    for a, b in zip(pools[0].read_pages("s"), pools[1].read_pages("s")):
        np.testing.assert_array_equal(_bits(a[0].q), _bits(b[0].q))
        np.testing.assert_array_equal(_bits(a[0].scale), _bits(b[0].scale))
    mine = pools[0].stats()
    assert mine["host_bytes"] == 0 and mine["evicted_bytes"] == evicted
    assert {k: v for k, v in mine.items() if k != "evicted_bytes"} == \
        pools[1].stats()


def test_bad_evict_codec_rejected_at_construction():
    for bad in ("no-such-codec", "cusz-i"):
        with pytest.raises((ValueError, KeyError)):
            TP.PagedKVPool(2, evict_codec=bad, device="cpu")
    with pytest.raises(ValueError, match="n_pages"):
        TP.PagedKVPool(0, device="cpu")


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _requests(mod, n, rng, plen_lo=5, plen_hi=14, new_lo=3, new_hi=7,
              arrivals=None):
    return [mod.Request(
        rid=i,
        prompt=rng.integers(1, 100, size=int(rng.integers(plen_lo, plen_hi))
                            ).astype(np.int32),
        max_new=int(rng.integers(new_lo, new_hi)),
        arrival=0 if arrivals is None else arrivals[i]) for i in range(n)]


def _run_both(ref, model, runner, schedcfg_kw, seed, **req_kw):
    scfg, rscfg = model.scfgs(ref)
    reqs = _requests(TS, 3, np.random.default_rng(seed), **req_kw)
    rreqs = _requests(ref.S, 3, np.random.default_rng(seed), **req_kw)
    mine, msched = getattr(TS, runner)(model.tp, model.tcfg, scfg,
                                       TS.SchedulerConfig(**schedcfg_kw),
                                       reqs)
    theirs, rsched = getattr(ref.S, runner)(
        model.rp, model.rcfg, rscfg, ref.S.SchedulerConfig(**schedcfg_kw),
        rreqs)
    return (mine, msched), (theirs, rsched)


def test_scheduler_tight_pool_cusz_matches_reference(ref, model):
    """3 live sequences on a 2-page pool with cusz eviction: the same
    preemptions, evictions and restores, and the same tokens."""
    (mine, ms), (theirs, rs) = _run_both(
        ref, model, "run_continuous",
        dict(max_batch=3, pool_pages=2, evict_codec="cusz"), seed=4,
        plen_lo=6, plen_hi=12, new_lo=5, new_hi=8)
    assert ms.preemptions == rs.preemptions > 0
    st, rst = ms.pool.stats(), rs.pool.stats()
    for k in ("evicted_pages", "restored_pages", "peak_used"):
        assert st[k] == rst[k], k
    assert st["evicted_pages"] > 0 and st["restored_pages"] > 0
    assert ms.n_steps == rs.n_steps
    assert mine.keys() == theirs.keys()
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid
        assert mine[rid]["t_finish"] == theirs[rid]["t_finish"], rid
    assert ms.pool.used_pages == 0 and not ms._suspended


def test_scheduler_int8_block_tight_pool_equals_big_pool(ref, model):
    scfg, _ = model.scfgs(ref)
    reqs = _requests(TS, 3, np.random.default_rng(4), plen_lo=6,
                     plen_hi=12, new_lo=5, new_hi=8)
    tiny, st = TS.run_continuous(model.tp, model.tcfg, scfg,
                                 TS.SchedulerConfig(max_batch=3,
                                                    pool_pages=2,
                                                    evict_codec="int8-block"),
                                 reqs)
    big, sb = TS.run_continuous(model.tp, model.tcfg, scfg,
                                TS.SchedulerConfig(max_batch=3,
                                                   pool_pages=16,
                                                   evict_codec="int8-block"),
                                reqs)
    assert st.preemptions > 0 and sb.preemptions == 0
    assert st.pool.stats()["restored_pages"] > 0
    for rid in tiny:
        assert tiny[rid]["tokens"] == big[rid]["tokens"], rid


def test_scheduler_static_matches_reference(ref, model):
    (mine, ms), (theirs, rs) = _run_both(
        ref, model, "run_static", dict(max_batch=2, pool_pages=12), seed=2,
        arrivals=[0, 0, 2])
    assert ms.n_steps == rs.n_steps
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid


def test_scheduler_single_request_matches_generate(ref, model):
    scfg, _ = model.scfgs(ref)
    prompt = np.random.default_rng(1).integers(1, 100, size=9
                                               ).astype(np.int32)
    want = TE.generate(model.tp, model.tcfg, _t(prompt)[None, :], 5,
                       scfg)[0].tolist()
    fin, _ = TS.run_continuous(model.tp, model.tcfg, scfg,
                               TS.SchedulerConfig(max_batch=2, pool_pages=8),
                               [TS.Request(rid=0, prompt=prompt, max_new=5)])
    assert fin[0]["tokens"] == want


def test_scheduler_pool_too_small_and_config_checks(ref, model):
    scfg, _ = model.scfgs(ref)
    prompt = np.random.default_rng(5).integers(1, 100, size=150
                                               ).astype(np.int32)
    with pytest.raises(RuntimeError, match="pool too small"):
        TS.run_continuous(model.tp, model.tcfg, scfg,
                          TS.SchedulerConfig(max_batch=1, pool_pages=1,
                                             preempt=False),
                          [TS.Request(rid=0, prompt=prompt, max_new=2)])
    with pytest.raises(ValueError, match="compressed_kv"):
        TS.ContinuousScheduler(model.tp, model.tcfg,
                               model.scfgs(ref, compressed=False)[0],
                               TS.SchedulerConfig())
    with pytest.raises(ValueError, match="multiple"):
        TS.ContinuousScheduler(model.tp, model.tcfg,
                               TE.ServeConfig(s_max=200, compressed_kv=True),
                               TS.SchedulerConfig())


def test_adopt_flush_slot_round_trip():
    """A slot adopted from pages flushes back to copies of the same
    pages, and adoption resets the tail to the extension pattern."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 512, 2, 4)).astype(np.float32))
    buf = TKV.kv_quantize(x, SEQ_AXIS)
    src = TKV.kv_quantize(x[:, :1] * 2, SEQ_AXIS)
    pages = [TKV.kv_page_slice(src, SEQ_AXIS, i) for i in range(2)]
    assert TS._adopt_slot(buf, pages, 1, SEQ_AXIS) is buf
    back = TS._flush_slot(buf, 1, 2, SEQ_AXIS)
    for a, b in zip(back, pages):
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    assert bool((buf.q[:, 1, 256:] == 0).all())
    assert bool((buf.scale[:, 1, 2:] == np.float32(TKV.SCALE_FLOOR)).all())
    buf.q.zero_()                    # flushed pages own their bytes
    assert not bool((back[0].q == 0).all())


# ---------------------------------------------------------------------------
# MLA latents, Mamba state: the "mla" and "state" handoff kinds, latent and
# leafless pool pages, the scheduler's state sidecar
# ---------------------------------------------------------------------------

NEW_ARCHS = ("deepseek-v2-236b", "mamba2-1.3b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def arch_models(ref):
    """Reduced MLA+MoE, Mamba2 and hybrid models, one period each, with
    the reference's weights in both packages (f32 compute), and each
    one's reference prefill of 2 x 144 tokens (two SEQ_BLOCKs, the second
    partial; 9 SSD chunks of 16) on compressed caches."""
    prompt = np.random.default_rng(20).integers(1, 200, (2, 144)
                                                ).astype(np.int32)
    out = {}
    for arch in NEW_ARCHS:
        m = _Model(ref, arch)
        _, rscfg = m.scfgs(ref)
        last, caches, plen = ref.E.prefill(m.rp, m.rcfg,
                                           ref.jnp.asarray(prompt), rscfg)
        out[arch] = (m, prompt, (np.asarray(last), caches, plen))
    return out


@pytest.mark.parametrize("wire", ("int8-block", "cusz"))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_handoff_mla_and_state_kinds(ref, arch_models, arch, wire):
    """On the reference's prefill caches: the same kinds, byte-identical
    containers (latents on the wire codec, Mamba h and conv lossless)
    and the same wire accounting; each package's reshard of the other's
    handoff gives the same cache bits (int8-block: the prefill's own)."""
    m, _, (_, rcaches, plen) = arch_models[arch]
    scfg, rscfg = m.scfgs(ref)
    mine = TE.encode_handoff(_caches_to_port(ref, rcaches), m.tcfg, scfg,
                             plen=plen, wire=wire)
    mine_stats = dict(TE.LAST_HANDOFF_STATS)
    theirs = ref.E.encode_handoff(rcaches, m.rcfg, rscfg, plen=plen,
                                  wire=wire)
    assert mine.kinds == theirs.kinds
    assert set(mine.kinds) == {"mla"} if arch.startswith("deepseek") \
        else "state" in mine.kinds
    for me, th in zip(mine.entries, theirs.entries):
        for a, b in zip(me, th):
            _same_parts(ref, a, b)
    assert mine_stats == dict(ref.E.LAST_HANDOFF_STATS)
    got = TE.reshard_caches(_handoff_to_port(ref, theirs), m.tcfg, scfg,
                            device="cpu")
    got_stats = dict(TE.LAST_RESHARD_STATS)
    want = ref.E.reshard_caches(_handoff_to_ref(ref, mine), m.rcfg, rscfg)
    assert got_stats == dict(ref.E.LAST_RESHARD_STATS)
    _same_caches(got, want)
    if wire == "int8-block":
        _same_caches(got, rcaches)             # adopted, state lossless


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_disaggregated_tokens_new_archs(ref, arch_models, arch):
    """The port's own prefill -> cusz handoff -> reshard -> decode gives
    the reference's f32 greedy tokens from the reference's handoff."""
    m, prompt, (last, rcaches, plen) = arch_models[arch]
    scfg, rscfg = m.scfgs(ref)
    rh = ref.E.encode_handoff(rcaches, m.rcfg, rscfg, plen=plen, wire="cusz")
    want = ref.E.decode_tokens(m.rp, m.rcfg, rscfg, ref.jnp.asarray(last),
                               ref.E.reshard_caches(rh, m.rcfg, rscfg),
                               rh.plen, 5)
    tlast, tcaches, tplen = TE.prefill(m.tp, m.tcfg, _t(prompt), scfg)
    th = TE.encode_handoff(tcaches, m.tcfg, scfg, plen=tplen, wire="cusz")
    got = TE.decode_tokens(m.tp, m.tcfg, scfg, tlast,
                           TE.reshard_caches(th, m.tcfg, scfg,
                                             device="cpu"), th.plen, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", ("int8-block", "cusz"))
def test_pool_latent_pages_match_reference(ref, codec):
    """4-D MLA latent slabs ([n_periods, 1, 128, R]) through each
    package's pool: byte-identical eviction containers, identical
    restored bits."""
    x = np.random.default_rng(21).standard_normal(
        (2, 1, 2 * TKV.SEQ_BLOCK, 40)).astype(np.float32)
    rq = ref.KV.kv_quantize(ref.jnp.asarray(x), SEQ_AXIS)
    tq = TKV.QuantKV(_t(rq.q), _t(rq.scale))
    pools = (TP.PagedKVPool(2, evict_codec=codec, source_dtype=torch.float32,
                            device="cpu"),
             ref.P.PagedKVPool(2, evict_codec=codec,
                               source_dtype=ref.jnp.float32))
    for pool, q, kv in ((pools[0], tq, TKV), (pools[1], rq, ref.KV)):
        pool.register("s")
        for i in range(2):
            pool.append_page("s", (kv.kv_page_slice(q, SEQ_AXIS, i),))
        assert tuple(pool.read_pages("s")[0][0].q.shape) == (2, 1, 128, 40)
        assert pool.evict_sequence("s") == 2
    for pm, pr in zip(pools[0]._tables["s"], pools[1]._tables["s"]):
        _same_parts(ref, pm.host[0], pr.host[0])
    assert pools[0].ensure_resident("s") == pools[1].ensure_resident("s") == 2
    for a, b in zip(pools[0].read_pages("s"), pools[1].read_pages("s")):
        np.testing.assert_array_equal(_bits(a[0].q), _bits(b[0].q))
        np.testing.assert_array_equal(_bits(a[0].scale), _bits(b[0].scale))


def test_pool_leafless_pages_count():
    """A pure SSM model's pages hold no leaf: they still take pool pages,
    evict (to host pages of no bytes) and restore (to empty slabs), and
    the page accounting holds."""
    pool = TP.PagedKVPool(3, evict_codec="cusz", device="cpu")
    for sid in ("a", "b"):
        pool.register(sid)
        pool.append_page(sid, ())
    pool.append_page("a", ())
    with pytest.raises(TP.PoolExhausted):
        pool.append_page("b", ())
    assert pool.evict_cold(2, exclude={"b"}) == 2
    st = pool.stats()
    assert st["host_pages"] == 2 and st["host_bytes"] == 0
    assert pool.free_pages == 2 and pool.device_pids() == {
        p.pid for p in pool._tables["b"]}
    assert pool.ensure_resident("a") == 2
    assert pool.read_pages("a") == [(), ()]
    assert pool.stats()["restored_pages"] == 2 and pool.free_pages == 0
    assert len(pool.device_pids()) == pool.used_pages == 3


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_scheduler_tight_pool_new_archs_match_reference(ref, arch):
    """3 live sequences on a 2-page pool with cusz eviction: the same
    steps, preemptions, evicted / restored pages and tokens as the
    reference.  Mamba states cross each preemption through the sidecar
    (mamba2's pages hold no leaf, jamba's the attention position's K/V);
    prompts of 6-11 tokens are shorter than one SSD chunk."""
    m = _Model(ref, arch)
    (mine, ms), (theirs, rs) = _run_both(
        ref, m, "run_continuous",
        dict(max_batch=3, pool_pages=2, evict_codec="cusz"), seed=4,
        plen_lo=6, plen_hi=12, new_lo=5, new_hi=8)
    assert ms.preemptions == rs.preemptions > 0
    st, rst = ms.pool.stats(), rs.pool.stats()
    for k in ("evicted_pages", "restored_pages", "peak_used"):
        assert st[k] == rst[k], k
    assert ms.n_steps == rs.n_steps
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid
    assert not ms.states and ms.pool.used_pages == 0


def test_scheduler_ssm_sidecar_tight_equals_big_pool(ref):
    """mamba2 with int8-block eviction on a 2-page pool (preempting, the
    state parked in the sidecar) against a 16-page pool: equal tokens;
    prompts of 16 and 32 tokens (one and two SSD chunks)."""
    m = _Model(ref, "mamba2-1.3b")
    scfg, _ = m.scfgs(ref)
    rng = np.random.default_rng(22)
    reqs = [TS.Request(rid=i, prompt=rng.integers(1, 100, size=n
                                                  ).astype(np.int32),
                       max_new=6) for i, n in enumerate((16, 32, 16))]
    runs = [TS.run_continuous(m.tp, m.tcfg, scfg,
                              TS.SchedulerConfig(max_batch=3, pool_pages=n,
                                                 evict_codec="int8-block"),
                              reqs) for n in (2, 16)]
    (tiny, st), (big, sb) = runs
    assert st.preemptions > 0 and sb.preemptions == 0
    for rid in tiny:
        assert tiny[rid]["tokens"] == big[rid]["tokens"], rid


def test_scheduler_static_new_arch_matches_reference(ref):
    (mine, ms), (theirs, rs) = _run_both(
        ref, _Model(ref, "jamba-1.5-large-398b"), "run_static",
        dict(max_batch=2, pool_pages=12), seed=2, arrivals=[0, 0, 2])
    assert ms.n_steps == rs.n_steps
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid


def test_chip_smoke_schedules_rehearsed():
    """The continuous runs of `chip_smoke.py` rehearsed on the CPU at
    reduced width: with EOS off the schedule (steps, preemptions, pages
    evicted and restored) depends only on the requests' lengths and the
    pool, not on the model or the eviction codec, so the card's runs at
    full width must give these counts (`SERVE_COUNTS` for qwen3-4b and
    deepseek-v2-236b at the default seed, `MAMBA2_COUNTS`)."""
    import chip_smoke as cs

    scfg = TE.ServeConfig(s_max=cs.SERVE["s_max"], compressed_kv=True,
                          compute_dtype=torch.float32)
    for arch, runs, want in (
            ("qwen2.5-3b", (("cusz", cs.SERVE["cusz_requests"],
                             cs.SERVE["tight_pages"]),
                            ("int8-block", None, cs.SERVE["tight_pages"]),
                            ("int8-block-big", None, cs.SERVE["big_pages"])),
             cs.SERVE_COUNTS),
            ("mamba2-1.3b", (("int8-block", None, cs.MAMBA2["tight_pages"]),
                             ("int8-block-big", None,
                              cs.MAMBA2["big_pages"])), cs.MAMBA2_COUNTS)):
        cfg = tconfigs.reduced(arch, 1)
        params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        if arch == "mamba2-1.3b":
            reqs = [TS.Request(rid=i, prompt=np.ones(n, np.int32),
                               max_new=cs.MAMBA2["max_new"])
                    for i, n in enumerate(cs.MAMBA2["prompts"])]
            max_batch = cs.MAMBA2["max_batch"]
        else:
            reqs = cs.serve_requests(np, TS.Request, cfg.vocab, 0)
            max_batch = cs.SERVE["max_batch"]
        for label, n_req, pages in runs:
            _, sched = TS.run_continuous(
                params, cfg, scfg,
                TS.SchedulerConfig(max_batch=max_batch, pool_pages=pages,
                                   evict_codec="int8-block"),
                reqs[:n_req])
            assert cs.schedule_counts(sched) == want[label], (arch, label)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", (
    ["--compressed-kv"],
    ["--compressed-kv", "--disaggregate", "--wire-codec", "cusz"],
    ["--continuous", "--requests", "4", "--pool-pages", "3",
     "--prompt-len", "140"]))
def test_launch_serve_cli_on_cpu(capsys, extra):
    tlaunch.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--new-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert "arch=qwen3-4b device=cpu" in out
    if "--disaggregate" in extra:
        assert "handoff wire=cusz" in out and "decoded=2" in out
    if "--continuous" in extra:
        assert "requests=4" in out and "evict_codec=cusz" in out


@pytest.mark.parametrize("arch,extra", (
    ("deepseek-v2-236b", ["--compressed-kv", "--disaggregate",
                          "--wire-codec", "fz"]),
    ("moonshot-v1-16b-a3b", ["--compressed-kv"]),
    ("mamba2-1.3b", ["--prompt-len", "48", "--compressed-kv",
                     "--disaggregate"]),
    ("jamba-1.5-large-398b", ["--continuous", "--requests", "3",
                              "--pool-pages", "3", "--prompt-len", "144"])))
def test_launch_serve_cli_new_archs(capsys, arch, extra):
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--batch", "2", "--new-tokens", "3"] + extra)
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu" in out
    if "--disaggregate" in extra:
        assert "handoff wire=" in out
    with pytest.raises(SystemExit, match="SSD chunk"):
        tlaunch.main(["--arch", "mamba2-1.3b", "--reduced", "--device",
                      "cpu", "--prompt-len", "40"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _on_card(model, dev):
    """`model` with the port's weights on `dev` (the reference's stay)."""
    card = copy.copy(model)
    card.tp = TM._map(lambda t: t.to(dev), model.tp)
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_disaggregated_on_card(cuda_dev, ref, model, prefilled, wire):
    """The handoff on the card against the reference (JAX on the CPU):
    the reference's prefill caches, moved to the card, encode to
    byte-identical containers; the card's reshard of the reference's
    handoff gives the reference's QuantKV bits and, decoded on the card,
    its f32 greedy tokens; the card's own prefill -> handoff -> reshard
    -> decode gives the same tokens."""
    prompt, runs = prefilled
    last, rcaches, plen = runs[True]
    scfg, rscfg = model.scfgs(ref)
    card = _on_card(model, cuda_dev)
    mine = TE.encode_handoff(_caches_to_port(ref, rcaches, cuda_dev),
                             card.tcfg, scfg, plen=plen, wire=wire)
    rh = ref.E.encode_handoff(rcaches, model.rcfg, rscfg, plen=plen,
                              wire=wire)
    for me, th in zip(mine.entries, rh.entries):
        for a, b in zip(me, th):
            _same_parts(ref, a, b)
    got = TE.reshard_caches(_handoff_to_port(ref, rh), card.tcfg, scfg,
                            device=cuda_dev)
    want = ref.E.reshard_caches(rh, model.rcfg, rscfg)
    assert got.entries[0][0].q.is_cuda
    _same_caches(got, want)
    rtoks = np.asarray(ref.E.decode_tokens(
        model.rp, model.rcfg, rscfg, ref.jnp.asarray(last), want, rh.plen,
        5))
    toks = TE.decode_tokens(card.tp, card.tcfg, scfg, _t(last, cuda_dev),
                            got, plen, 5)
    np.testing.assert_array_equal(toks.cpu().numpy(), rtoks)
    tlast, tcaches, tplen = TE.prefill(card.tp, card.tcfg,
                                       _t(prompt, cuda_dev), scfg)
    th = TE.encode_handoff(tcaches, card.tcfg, scfg, plen=tplen, wire=wire)
    own = TE.decode_tokens(card.tp, card.tcfg, scfg, tlast,
                           TE.reshard_caches(th, card.tcfg, scfg,
                                             device=cuda_dev), th.plen, 5)
    np.testing.assert_array_equal(own.cpu().numpy(), rtoks)


@pytest.mark.cuda
def test_scheduler_on_card(cuda_dev, ref, model):
    """The continuous scheduler on the card with cusz eviction on a tight
    pool against the reference (JAX on the CPU): the same preemptions,
    evictions, restores, steps and tokens."""
    (mine, ms), (theirs, rs) = _run_both(
        ref, _on_card(model, cuda_dev), "run_continuous",
        dict(max_batch=3, pool_pages=2, evict_codec="cusz"), seed=4,
        plen_lo=6, plen_hi=12, new_lo=5, new_hi=8)
    assert ms.pool.device.type == "cuda"
    assert ms.preemptions == rs.preemptions > 0
    st, rst = ms.pool.stats(), rs.pool.stats()
    for k in ("evicted_pages", "restored_pages", "peak_used"):
        assert st[k] == rst[k], k
    assert ms.n_steps == rs.n_steps
    assert mine.keys() == theirs.keys()
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ("cusz", "fz"))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_disaggregated_on_card(cuda_dev, ref, arch_models, arch,
                                         wire):
    """MLA latents (through the codec kernels on the card) and Mamba
    state (lossless) against the reference: the reference's prefill
    caches moved to the card encode to byte-identical containers; the
    card's reshard of the reference's handoff gives its cache bits and,
    decoded on the card, its f32 greedy tokens."""
    m, _, (last, rcaches, plen) = arch_models[arch]
    scfg, rscfg = m.scfgs(ref)
    card = _on_card(m, cuda_dev)
    mine = TE.encode_handoff(_caches_to_port(ref, rcaches, cuda_dev),
                             card.tcfg, scfg, plen=plen, wire=wire)
    rh = ref.E.encode_handoff(rcaches, m.rcfg, rscfg, plen=plen, wire=wire)
    for me, th in zip(mine.entries, rh.entries):
        for a, b in zip(me, th):
            _same_parts(ref, a, b)
    got = TE.reshard_caches(_handoff_to_port(ref, rh), card.tcfg, scfg,
                            device=cuda_dev)
    want = ref.E.reshard_caches(rh, m.rcfg, rscfg)
    assert next(_cache_arrays(got.entries)).is_cuda
    _same_caches(got, want)
    rtoks = np.asarray(ref.E.decode_tokens(
        m.rp, m.rcfg, rscfg, ref.jnp.asarray(last), want, rh.plen, 5))
    toks = TE.decode_tokens(card.tp, card.tcfg, scfg, _t(last, cuda_dev),
                            got, plen, 5)
    np.testing.assert_array_equal(toks.cpu().numpy(), rtoks)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_scheduler_on_card(cuda_dev, ref, arch):
    """The continuous scheduler on the card with cusz eviction on a tight
    pool against the reference: the same steps, preemptions, evicted /
    restored pages and tokens."""
    (mine, ms), (theirs, rs) = _run_both(
        ref, _on_card(_Model(ref, arch), cuda_dev), "run_continuous",
        dict(max_batch=3, pool_pages=2, evict_codec="cusz"), seed=4,
        plen_lo=6, plen_hi=12, new_lo=5, new_hi=8)
    assert ms.pool.device.type == "cuda"
    assert ms.preemptions == rs.preemptions > 0
    st, rst = ms.pool.stats(), rs.pool.stats()
    for k in ("evicted_pages", "restored_pages", "peak_used"):
        assert st[k] == rst[k], k
    assert ms.n_steps == rs.n_steps
    for rid in mine:
        assert mine[rid]["tokens"] == theirs[rid]["tokens"], rid
