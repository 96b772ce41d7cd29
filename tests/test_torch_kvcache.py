"""Port parity for the KV-cache codec layer (`repro_torch.core.kvcache`)
against the reference's `repro.core.kvcache` on numpy-seeded inputs, on
the CPU: the quantized cache, the per-coordinate scale widening of
`kv_update_block` (the reference's six TestKVCache cases, each also held
bit for bit against the reference), the error bound, each wire's packed
parts on a small cache, and the adopt / restore / page round trips.

The `cuda` tests at the end run one encode / restore per wire on a card.
"""
from __future__ import annotations

import importlib
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch.core import compressor as TCZ
from repro_torch.core import kvcache as TKV
from repro_torch.kernels import dispatch

WIRES = ("int8-block", "cusz", "fz", "lossless")
CACHE_SHAPE = (2, 1, 512, 2, 16)          # [n_periods, B, S, Hkv, D]
SEQ = 2


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported on first use.  `import repro.core`
    fails the first time in a fresh process, because `repro.dist` imports
    a `chaos` module that the checkout lacks; the failed import leaves the
    partly initialised modules behind and the second attempt succeeds.
    Hence one retry."""
    try:
        importlib.import_module("repro.core")
    except ImportError:
        importlib.import_module("repro.core")
    names = {"jnp": "jax.numpy", "codecs": "repro.codecs",
             "KV": "repro.core.kvcache"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _cache(shape=CACHE_SHAPE, seed=0, scale=0.5) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _same_qkv(t, j):
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy().view(np.int32),
                                  np.asarray(j.scale).view(np.int32))


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


# ---------------------------------------------------------------------------
# In-memory format: the reference's TestKVCache cases, held bit for bit
# ---------------------------------------------------------------------------

class TestQuantKV:
    @pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
    def test_quantize_dequantize_bound(self, ref, dtype):
        k = np.random.default_rng(2).standard_normal((2, 4, 512, 16)
                                                    ).astype(np.float32)
        kt = torch.from_numpy(k).to(getattr(torch, dtype))
        qkv = TKV.kv_quantize(kt, seq_axis=2)
        _same_qkv(qkv, ref.KV.kv_quantize(
            ref.jnp.asarray(k).astype(dtype), seq_axis=2))
        rec = TKV.kv_dequantize(qkv, seq_axis=2, dtype=torch.float32)
        eb = TKV.error_bound(qkv)
        np.testing.assert_array_equal(
            eb.numpy(), np.asarray(ref.KV.error_bound(
                ref.KV.kv_quantize(ref.jnp.asarray(k).astype(dtype), 2))))
        eb_full = eb.repeat_interleave(TKV.SEQ_BLOCK, dim=2)
        assert bool(((rec - kt.float()).abs() <= eb_full * 2 + 1e-12).all())
        assert qkv.q.dtype == torch.int8
        assert TKV.kv_dequantize(qkv, 2).dtype == torch.bfloat16

    def test_update_block_preserves_old_tokens(self, ref):
        cache = _cache((1, 256, 8), seed=3, scale=0.1)
        qkv = TKV.kv_quantize(torch.from_numpy(cache), seq_axis=1)
        before = TKV.kv_dequantize(qkv, 1, torch.float32).numpy()
        big = torch.ones((1, 1, 8)) * 5.0                 # widens the scale
        qkv2 = TKV.kv_update_block(qkv, big, pos=7, seq_axis=1)
        _same_qkv(qkv2, ref.KV.kv_update_block(
            ref.KV.kv_quantize(ref.jnp.asarray(cache), 1),
            ref.jnp.asarray(big.numpy()), pos=7, seq_axis=1))
        after = TKV.kv_dequantize(qkv2, 1, torch.float32).numpy()
        np.testing.assert_allclose(after[0, 7], 5.0, atol=0.05)
        new_eb = float(TKV.error_bound(qkv2)[0, 0].max())
        mask = np.ones(256, bool)
        mask[7] = False
        assert np.abs(after[0, mask] - before[0, mask]).max() \
            <= 2 * new_eb + 1e-6
        np.testing.assert_array_equal(after[0, 128:], before[0, 128:])
        # the source cache is not written in place
        _same_qkv(qkv, ref.KV.kv_quantize(ref.jnp.asarray(cache), 1))

    def test_memory_footprint_4x(self):
        k = torch.zeros((2, 4, 1024, 64), dtype=torch.bfloat16)
        qkv = TKV.kv_quantize(k.float(), seq_axis=2)
        raw = k.numel() * 2
        comp = qkv.q.numel() + qkv.scale.numel() * 4
        assert raw / comp > 1.9

    def test_update_widens_per_coordinate_not_globally(self, ref):
        cache = np.zeros((1, 256, 2), np.float32)
        cache[0, :8, 0] = np.linspace(1e-3, 2e-3, 8)
        cache[0, :8, 1] = np.linspace(0.5, 1.0, 8)
        qkv = TKV.kv_quantize(torch.from_numpy(cache), seq_axis=1)
        before = TKV.kv_dequantize(qkv, 1, torch.float32).numpy()
        new = torch.tensor([[[1e-3, 100.0]]])
        qkv2 = TKV.kv_update_block(qkv, new, pos=8, seq_axis=1)
        _same_qkv(qkv2, ref.KV.kv_update_block(
            ref.KV.kv_quantize(ref.jnp.asarray(cache), 1),
            ref.jnp.asarray(new.numpy()), pos=8, seq_axis=1))
        after = TKV.kv_dequantize(qkv2, 1, torch.float32).numpy()
        np.testing.assert_array_equal(after[0, :8, 0], before[0, :8, 0])
        assert float(qkv2.scale[0, 0, 0]) == float(qkv.scale[0, 0, 0])
        eb1 = float(qkv2.scale[0, 0, 1]) / 2
        assert abs(after[0, 8, 1] - 100.0) <= eb1 + 1e-6
        assert abs(after[0, 8, 0] - 1e-3) <= \
            float(qkv2.scale[0, 0, 0]) / 2 + 1e-9

    def test_zero_extension_blocks_stay_at_floor_until_written(self, ref):
        cache = np.zeros((1, 256, 4), np.float32)
        cache[0, :100] = np.random.default_rng(0).standard_normal((100, 4))
        qkv = TKV.kv_quantize(torch.from_numpy(cache), seq_axis=1)
        assert bool((qkv.scale[0, 1] == np.float32(TKV.SCALE_FLOOR)).all())
        new = torch.full((1, 1, 4), 3.0)
        qkv2 = TKV.kv_update_block(qkv, new, pos=130, seq_axis=1)
        _same_qkv(qkv2, ref.KV.kv_update_block(
            ref.KV.kv_quantize(ref.jnp.asarray(cache), 1),
            ref.jnp.asarray(new.numpy()), pos=130, seq_axis=1))
        after = TKV.kv_dequantize(qkv2, 1, torch.float32).numpy()
        np.testing.assert_allclose(after[0, 130], 3.0, atol=3.0 / 254 + 1e-6)
        mask = np.ones(256, bool)
        mask[130] = False
        np.testing.assert_array_equal(after[0, 128:][mask[128:]], 0.0)
        qkv3 = TKV.kv_update_block(qkv, torch.zeros((1, 1, 4)), pos=200,
                                   seq_axis=1)
        assert bool(torch.isfinite(qkv3.scale).all())
        assert torch.equal(TKV.kv_dequantize(qkv3, 1, torch.float32),
                           TKV.kv_dequantize(qkv, 1, torch.float32))

    def test_misaligned_prompt_tail_block_survives_decode_writes(self, ref):
        plen = 100
        cache = np.zeros((1, 256, 4), np.float32)
        cache[0, :plen] = np.random.default_rng(1).standard_normal((plen, 4))
        qkv = TKV.kv_quantize(torch.from_numpy(cache), seq_axis=1)
        rq = ref.KV.kv_quantize(ref.jnp.asarray(cache), 1)
        before = TKV.kv_dequantize(qkv, 1, torch.float32).numpy()
        for i in range(4):
            tok = np.random.default_rng(2 + i).standard_normal(
                (1, 1, 4)).astype(np.float32)
            qkv = TKV.kv_update_block(qkv, torch.from_numpy(tok),
                                      pos=plen + i, seq_axis=1)
            rq = ref.KV.kv_update_block(rq, ref.jnp.asarray(tok),
                                        pos=plen + i, seq_axis=1)
        _same_qkv(qkv, rq)
        after = TKV.kv_dequantize(qkv, 1, torch.float32).numpy()
        eb = TKV.error_bound(qkv)[0, 0].numpy()
        err = np.abs(after[0, :plen] - before[0, :plen])
        assert (err <= 2 * eb[None, :] + 1e-9).all()


# ---------------------------------------------------------------------------
# Wire and page layers
# ---------------------------------------------------------------------------

class TestWire:
    @pytest.mark.parametrize("source", ("raw", "quantkv"))
    @pytest.mark.parametrize("wire", WIRES)
    def test_packed_parts_match_reference(self, ref, wire, source):
        x = _cache()
        xj = ref.jnp.asarray(x).astype(ref.jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        if source == "quantkv":
            xj, xt = ref.KV.kv_quantize(xj, SEQ), TKV.kv_quantize(xt, SEQ)
        mine = TKV.kv_wire_encode(xt, SEQ, wire=wire, nslabs=4)
        theirs = ref.KV.kv_wire_encode(xj, SEQ, wire=wire, nslabs=4)
        _same_parts(ref, mine, theirs)
        got = TKV.kv_wire_restore(mine, SEQ, device="cpu")
        want = ref.KV.kv_wire_restore(theirs, SEQ)
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == CACHE_SHAPE
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(want.astype(ref.jnp.float32)))
        assert TKV.kv_wire_nbytes(mine) == ref.KV.kv_wire_nbytes(theirs)

    @pytest.mark.parametrize("wire", ("cusz", "fz"))
    def test_restore_within_slab_bound(self, wire):
        xt = torch.from_numpy(_cache()).to(torch.bfloat16)
        parts = TKV.kv_wire_encode(xt, SEQ, wire=wire, nslabs=4)
        assert [p.header.param("kv_shape") for p in parts] == \
            [(2, 1, 128, 2, 16)] * 4
        got = TKV.kv_wire_restore(parts, SEQ, dtype=torch.float32,
                                  device="cpu")
        for i, p in enumerate(parts):
            sl = slice(128 * i, 128 * (i + 1))
            err = (got[:, :, sl] - xt[:, :, sl].float()).abs().max()
            # the codec's bound, then the bf16 rounding of the source
            bf16 = float(xt[:, :, sl].float().abs().max()) * 2.0 ** -8
            assert float(err) <= float(p.header.param("eb")) + bf16

    def test_int8_block_raw_equals_whole_quantize_and_adopts(self):
        xt = torch.from_numpy(_cache())
        parts = TKV.kv_wire_encode(xt, SEQ, nslabs=4)
        whole = TKV.kv_quantize(xt, SEQ)
        adopted = TKV.kv_wire_adopt(parts, SEQ, device="cpu")
        assert torch.equal(adopted.q, whole.q)
        assert torch.equal(adopted.scale, whole.scale)
        # QuantKV source: payload space, bit for bit
        again = TKV.kv_wire_adopt(
            TKV.kv_wire_encode(whole, SEQ, nslabs=2), SEQ, device="cpu")
        assert torch.equal(again.q, whole.q)
        assert torch.equal(again.scale, whole.scale)
        with pytest.raises(ValueError, match="cannot adopt"):
            TKV.kv_wire_adopt(TKV.kv_wire_encode(xt, SEQ, wire="lossless",
                                                 nslabs=2), SEQ)

    def test_cusz_overflow_slab_ships_lossless(self):
        xt = torch.from_numpy(_cache(scale=1.0))
        cfg = dict(eb=1e-6, eb_mode="valrel", outlier_frac=0.001)
        parts = TKV.kv_wire_encode(xt, SEQ, wire="cusz", nslabs=2,
                                   wire_cfg=cfg)
        assert {p.header.codec for p in parts} == {"lossless"}
        got = TKV.kv_wire_restore(parts, SEQ, dtype=torch.float32,
                                  device="cpu")
        assert torch.equal(got, xt)

    def test_page_layer_round_trip(self, ref):
        xt = torch.from_numpy(_cache())
        qkv = TKV.kv_quantize(xt, SEQ)
        n = TKV.kv_page_count(xt.shape[SEQ])
        assert n == 4 and TKV.kv_page_count(130) == 2
        pages = [TKV.kv_page_slice(qkv, SEQ, i) for i in range(n)]
        wire = [TKV.kv_page_encode(p, SEQ) for p in pages]
        theirs = ref.KV.kv_page_encode(
            ref.KV.kv_page_slice(ref.KV.kv_quantize(ref.jnp.asarray(
                _cache()), SEQ), SEQ, 1), SEQ)
        _same_parts(ref, wire[1], theirs)
        back = TKV.kv_page_concat(
            [TKV.kv_page_adopt(w, SEQ, device="cpu") for w in wire], SEQ)
        assert torch.equal(back.q, qkv.q)
        assert torch.equal(back.scale, qkv.scale)
        lossy = TKV.kv_page_encode(pages[0], SEQ, codec="fz")
        assert lossy[0].header.codec == "fz"

    def test_restore_without_cuda_needs_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        parts = TKV.kv_wire_encode(torch.from_numpy(_cache()), SEQ,
                                   wire="cusz", nslabs=2)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TKV.kv_wire_restore(parts, SEQ)
        assert TKV.kv_wire_restore(parts, SEQ, device="cpu").shape == \
            CACHE_SHAPE

    def test_deprecated_offload_shims_warn_and_round_trip(self, ref):
        x = torch.from_numpy(_cache((4, 256), seed=6))
        cfg = TCZ.CompressorConfig(eb=1e-3, eb_mode="valrel")
        TKV._WARNED.clear()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            packed, eb = TKV.kv_offload_pack(x, cfg)
            y = TKV.kv_offload_restore(packed, eb, x.shape, cfg,
                                       dtype=torch.float32, device="cpu")
        assert sum(issubclass(i.category, DeprecationWarning)
                   for i in w) == 2
        rpacked, reb = ref.KV.kv_offload_pack(ref.jnp.asarray(x.numpy()),
                                              cfg)
        assert eb == reb
        for k in rpacked:
            assert np.asarray(rpacked[k]).tobytes() == \
                np.asarray(packed[k]).tobytes(), k
        assert float((y - x).abs().max()) <= eb * 1.0001


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_wire_on_card(cuda_dev, wire):
    """One encode / restore per wire on the card: the parts equal the
    CPU's (int8-block, lossless, and the error-bounded wires, which run
    the same kernels bit-identically); cusz and fz launch kernels."""
    xt = torch.from_numpy(_cache()).to(torch.bfloat16)
    dispatch.reset_launches()
    parts = TKV.kv_wire_encode(xt.to(cuda_dev), SEQ, wire=wire, nslabs=4)
    got = TKV.kv_wire_restore(parts, SEQ, device=cuda_dev)
    counts = dispatch.launch_counts()
    assert got.is_cuda and got.shape == xt.shape
    cpu = TKV.kv_wire_encode(xt, SEQ, wire=wire, nslabs=4)
    for a, b in zip(parts, cpu):
        assert a.header == b.header
        for k in a.payload:
            assert np.asarray(a.payload[k]).tobytes() == \
                np.asarray(b.payload[k]).tobytes(), k
    want = TKV.kv_wire_restore(cpu, SEQ, device="cpu")
    assert torch.equal(got.cpu(), want)
    if wire in ("cusz", "fz"):
        assert counts["lorenzo.dualquant"] == 4
        assert counts["lorenzo.reverse"] == 4
    if wire == "int8-block":
        q = TKV.kv_wire_adopt(parts, SEQ, device=cuda_dev)
        whole = TKV.kv_quantize(xt, SEQ)
        assert torch.equal(q.q.cpu(), whole.q)
        assert torch.equal(q.scale.cpu(), whole.scale)
