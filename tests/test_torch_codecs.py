"""Port parity for the whole codec registry and the gap-less Huffman
decode: `repro_torch.codecs` against the reference package on the same
numpy-seeded inputs, on the CPU.

  * the registry ids are the reference's, and for every id the packed
    container (header JSON and every array) is bit-identical to the
    reference's, on float32 and bfloat16 fields of three shapes;
    containers cross-decode both ways, bit for bit;
  * split-stable ids: `encode_parts` + `concat_containers` equals a whole
    encode; `get_block_codec` rejects the other ids like the reference;
  * the int8 family holds the bound its math meets: scale/2 plus one ulp
    of max|x| in the output dtype;
  * gap-less (format v1) cusz containers decode bit-identically to the
    reference's sequential decode and to the gap-array decode, through
    both the table walk and the bit scan; the host Huffman helpers equal
    the reference's;
  * without CUDA, numpy input and packed containers need
    ``device="cpu"`` (no silent fallback).

The `cuda` tests at the end run the new paths on a card.
"""
from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch.core import huffman as thf
from repro_torch.kernels import dispatch
from repro_torch.kernels.deflate import ops as t_deflate
from repro_torch.kernels.encode import ops as t_encode
from repro_torch.kernels.inflate import ops as t_inflate

SHAPES = ((4, 32), (7, 9, 16), (96,))
DTYPES = ("float32", "bfloat16")
BLOCK = 16
SPLIT_STABLE = ("int16", "int8", "int8-block", "lossless")


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported on first use.  `import repro.core`
    fails the first time in a fresh process, because `repro.dist` imports
    a `chaos` module that the checkout lacks; the failed import leaves the
    partly initialised modules behind and the second attempt succeeds.
    Hence one retry."""
    try:
        importlib.import_module("repro.core")
    except ImportError:
        importlib.import_module("repro.core")
    names = {"jnp": "jax.numpy", "codecs": "repro.codecs",
             "hf": "repro.core.huffman", "M": "repro.core.metrics",
             "inflate": "repro.kernels.inflate.ops"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _make(mod, name: str, eb: float = 1e-3):
    """One configured instance per registry id, as the reference's
    property tests configure them."""
    if name in ("cusz", "cusz-i", "fz"):
        return mod.get(name, eb=eb, eb_mode="valrel", chunk_size=256,
                       outlier_frac=1.0)
    if name == "int8-block":
        return mod.get("int8-block", axis=-1, block=BLOCK)
    if name == "zfp":
        return mod.get("zfp", rate_bits=14)
    return mod.get(name)


def _field(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _inputs(ref, x: np.ndarray, dtype: str):
    """(reference array, port tensor) of the same values in `dtype`."""
    return (ref.jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _bits32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _ref_f32(ref, y) -> np.ndarray:
    return np.asarray(y.astype(ref.jnp.float32))


# ---------------------------------------------------------------------------
# Registry parity
# ---------------------------------------------------------------------------

def test_registry_ids_match_reference(ref):
    assert tcodecs.names() == ref.codecs.names()
    assert len(tcodecs.names()) == 8
    for name in tcodecs.names():
        codec = tcodecs.get(name)
        assert codec.name == name
        assert codec.version == ref.codecs.get(name).version
        assert codec.shardable == ref.codecs.get(name).shardable


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", tcodecs.names())
def test_packed_container_matches_reference(ref, name, shape, dtype):
    """Bit-identical packed containers; each package decodes the other's,
    bit for bit."""
    x = _field(shape, seed=len(shape) * 10 + len(name))
    xj, xt = _inputs(ref, x, dtype)
    rc, tc = _make(ref.codecs, name), _make(tcodecs, name)
    rp = rc.pack(rc.encode(xj))
    tp = tc.pack(tc.encode(xt))
    rh, ra = ref.codecs.to_arrays(rp)
    th, ta = tcodecs.to_arrays(tp)
    assert th == rh
    _same_arrays(ta, ra)
    want = _ref_f32(ref, ref.codecs.decode(rp))
    got = tcodecs.decode(tcodecs.from_arrays(rh, ra), device="cpu")
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits32(got.float().numpy()),
                                  _bits32(want))
    back = ref.codecs.decode(ref.codecs.from_arrays(th, ta))
    np.testing.assert_array_equal(_bits32(_ref_f32(ref, back)),
                                  _bits32(want))
    # the device form decodes like the packed form
    np.testing.assert_array_equal(
        _bits32(tcodecs.decode(tc.encode(xt)).float().numpy()),
        _bits32(want))


@pytest.mark.parametrize("name", SPLIT_STABLE)
def test_encode_parts_concat_equals_whole(ref, name):
    x = _field((64, 32), seed=3)
    tc, rc = _make(tcodecs, name), _make(ref.codecs, name)
    axis = tc.shard_axis(x.shape, 4)
    assert axis == rc.shard_axis(x.shape, 4)
    assert axis is not None
    parts = tc.encode_parts(torch.from_numpy(x), axis, 4)
    rparts = rc.encode_parts(ref.jnp.asarray(x), axis, 4)
    for p, r in zip(parts, rparts):
        _same_arrays(tcodecs.to_arrays(tc.pack(p))[1],
                     ref.codecs.to_arrays(rc.pack(r))[1])
    merged = tcodecs.concat_containers(parts, axis, tc.payload_axes(axis))
    assert merged.header == tc.encode(torch.from_numpy(x)).header
    whole = tc.decode(tc.encode(torch.from_numpy(x)))
    np.testing.assert_array_equal(_bits32(tc.decode(merged).numpy()),
                                  _bits32(whole.numpy()))
    # packed parts merge in payload space too (numpy fields)
    packed = [tc.pack(p) for p in parts]
    merged_np = tcodecs.concat_containers(packed, axis,
                                          tc.payload_axes(axis))
    assert merged_np.header.param("checksum") is None
    np.testing.assert_array_equal(
        _bits32(tc.decode(merged_np, device="cpu").numpy()),
        _bits32(whole.numpy()))


@pytest.mark.parametrize("name", ("cusz", "cusz-i", "fz", "zfp"))
def test_chunked_codecs_do_not_split(ref, name):
    codec = _make(tcodecs, name)
    assert codec.shard_axis((64, 32), 4) is None
    assert codec.payload_axes(0) is None
    assert codec.shardable is False


@pytest.mark.parametrize("name", ("cusz", "int8", "lossless", "zfp"))
def test_get_block_codec_rejects_non_block_ids(ref, name):
    with pytest.raises(ValueError) as mine:
        tcodecs.get_block_codec(name, axis=0, block=128)
    with pytest.raises(ValueError) as theirs:
        ref.codecs.get_block_codec(name, axis=0, block=128)
    assert str(mine.value) == str(theirs.value)
    codec = tcodecs.get_block_codec("int8-block", axis=2, block=128)
    assert (codec.axis, codec.block) == (2, 128)


def test_concat_rejects_differing_params():
    a = tcodecs.get("int8-block", axis=0, block=4).encode(torch.ones(8, 4))
    b = tcodecs.get("int8-block", axis=0, block=8).encode(torch.ones(8, 4))
    with pytest.raises(ValueError, match="differing"):
        tcodecs.concat_containers([a, b], 0, {"q": 0, "scale": 0})


def _ulp(m: float, dtype: torch.dtype) -> float:
    """One ulp of the value m in `dtype`."""
    return float(2.0 ** np.floor(np.log2(m))) * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ("int8", "int16", "int8-block"))
def test_int8_family_error_bound(name, dtype):
    """decode(encode(x)) within scale/2 plus one ulp of max|x| (in the
    output dtype): float32 dequantization rounds once more than the
    exact scale/2 the quantizer guarantees."""
    codec = _make(tcodecs, name)
    tdt = getattr(torch, dtype)
    for seed in range(12):
        rng = np.random.default_rng(seed)
        shape = SHAPES[seed % 2]
        x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 2)
             ).astype(np.float32)
        xt = torch.from_numpy(x).to(tdt)
        c = codec.encode(xt)
        y = codec.decode(c).float()
        x32 = xt.float()
        scale = c.payload["scale"]
        if name == "int8-block":
            scale = scale.repeat_interleave(BLOCK, dim=-1)
        tol = scale / 2 + _ulp(float(x32.abs().max()), tdt)
        assert bool(((y - x32).abs() <= tol).all()), (seed, name)


def test_lossless_bf16_stores_the_reference_uint16_bytes(ref):
    x = _field((5, 40), seed=8)
    xj, xt = _inputs(ref, x, "bfloat16")
    p = tcodecs.get("lossless").pack(tcodecs.get("lossless").encode(xt))
    assert p.payload["data"].dtype == np.uint16
    assert p.payload["data"].tobytes() == \
        np.asarray(xj).view(np.uint16).tobytes()
    y = tcodecs.decode(p, device="cpu")
    assert y.dtype == torch.bfloat16 and torch.equal(y, xt)


def test_zfp_accounting_and_4d_batch_match_reference(ref):
    x = _field((2, 5, 6, 7), seed=4)
    rc, tc = ref.codecs.get("zfp", rate_bits=10), tcodecs.get("zfp",
                                                            rate_bits=10)
    r, t = rc.encode(ref.jnp.asarray(x)), tc.encode(torch.from_numpy(x))
    _same_arrays(tcodecs.to_arrays(tc.pack(t))[1],
                 ref.codecs.to_arrays(rc.pack(r))[1])
    assert tc.stored_nbytes(t) == rc.stored_nbytes(r)
    assert tc.achieved_bitrate(t) == rc.achieved_bitrate(r)
    np.testing.assert_array_equal(
        _bits32(tc.decode(t).numpy()),
        _bits32(np.asarray(rc.decode(r))))


def test_zfp_block_exponent_at_powers_of_two(ref):
    """Blocks whose max |x| sits at or one ulp around a power of two:
    the exponent is the reference's compiled log2, not the exact one."""
    base = np.float32(2.0) ** np.arange(-20, 21, 5, dtype=np.float32)
    vals = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(0))])
    x = np.zeros((vals.size, 4), np.float32)
    x[:, 0] = vals
    x[:, 1] = -vals / 3
    rc, tc = ref.codecs.get("zfp"), tcodecs.get("zfp")
    _same_arrays(
        tcodecs.to_arrays(tc.pack(tc.encode(torch.from_numpy(x))))[1],
        ref.codecs.to_arrays(rc.pack(rc.encode(ref.jnp.asarray(x))))[1])


# ---------------------------------------------------------------------------
# Devices: the CPU only when asked for
# ---------------------------------------------------------------------------

def test_default_device_without_cuda_raises_actionably(ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _field((20, 30), seed=5)
    codec = tcodecs.get("cusz", eb=1e-3, eb_mode="valrel")
    packed = codec.pack(codec.encode(x, device="cpu"))
    for call in (lambda: tcodecs.decode(packed),
                 lambda: codec.encode(x),
                 lambda: tcodecs.get("int8").encode(x),
                 lambda: tcodecs.decode(tcodecs.get("lossless").pack(
                     tcodecs.get("lossless").encode(x, device="cpu")))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    y = tcodecs.decode(packed, device="cpu")
    rc = ref.codecs.get("cusz", eb=1e-3, eb_mode="valrel")
    want = np.asarray(ref.codecs.decode(rc.pack(rc.encode(
        ref.jnp.asarray(x)))))
    np.testing.assert_array_equal(_bits32(y.numpy()), _bits32(want))
    # a tensor input stays where it is, CUDA or not
    assert tcodecs.get("int8").encode(torch.from_numpy(x)).payload[
        "q"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Gap-less (format v1) Huffman decode
# ---------------------------------------------------------------------------

def _v1(mod, c):
    """The format-v1 form of a cusz container: no gap arrays, no
    sub_size, version 1 (as `tests/test_codecs.py` builds it)."""
    return mod.Container(
        dataclasses.replace(c.header.without_params("sub_size"), version=1),
        {k: v for k, v in c.payload.items()
         if k not in ("gap_bits", "gap_syms")})


def _fib_field() -> np.ndarray:
    """A 1-D field whose Lorenzo deltas take 24 values with Fibonacci
    frequencies, so its Huffman code is deeper than the 16-bit table."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    steps = np.repeat(np.arange(24) - 12, fib[::-1])
    steps = np.random.default_rng(3).permutation(steps)
    return np.cumsum(steps).astype(np.float32)


V1_CASES = {
    # tests/test_codecs.py::test_cusz_v1_gapless_container_still_decodes
    "lut": (lambda: _field((40, 64), seed=21),
            dict(eb=1e-3, eb_mode="valrel", chunk_size=512)),
    "bitscan": (_fib_field,
                dict(eb=0.5, eb_mode="abs", chunk_size=512,
                     outlier_frac=1.0)),
}


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_container_decodes_like_reference(ref, case):
    make, kw = V1_CASES[case]
    x = make()
    tc, rc = tcodecs.get("cusz", **kw), ref.codecs.get("cusz", **kw)
    c = tc.encode(x, device="cpu")
    bucket = thf.bucket_max_len(int(c.payload["max_len"]))
    assert (bucket <= thf.SEQ_LUT_BITS) == (case == "lut")
    v1 = _v1(tcodecs, c)
    assert "gap_bits" not in v1.payload and v1.header.version == 1
    want = np.asarray(ref.codecs.decode(_v1(ref.codecs, rc.encode(
        ref.jnp.asarray(x)))))
    gap = tcodecs.decode(c).numpy()
    dispatch.reset_launches()
    y = tcodecs.decode(v1).numpy()
    assert set(dispatch.launch_counts().values()) == {0}
    np.testing.assert_array_equal(_bits32(y), _bits32(want))
    np.testing.assert_array_equal(_bits32(y), _bits32(gap))
    assert ref.M.verify_error_bound(x, want, c.header.param("eb"))
    # the packed v1 form, and the reference's packed v1 container
    p1 = tc.pack(v1)
    assert "gap_bits" not in p1.payload and "gap_syms" not in p1.payload
    np.testing.assert_array_equal(
        _bits32(tcodecs.decode(p1, device="cpu").numpy()), _bits32(want))
    rh, ra = ref.codecs.to_arrays(rc.pack(_v1(ref.codecs, rc.encode(
        ref.jnp.asarray(x)))))
    th, ta = tcodecs.to_arrays(p1)
    assert th == rh
    _same_arrays(ta, ra)
    np.testing.assert_array_equal(
        _bits32(tcodecs.decode(tcodecs.from_arrays(rh, ra),
                               device="cpu").numpy()), _bits32(want))


def _fib_codes(n_sym: int, seed: int) -> np.ndarray:
    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    codes = np.repeat(np.arange(n_sym) * 7 + 100, fib[:n_sym])
    return np.random.default_rng(seed).permutation(codes).astype(np.int32)


@pytest.mark.parametrize("n_sym,bucket", [(8, 8), (12, 12), (16, 16),
                                          (22, 32)])
def test_sequential_inflate_every_bucket_matches_reference(ref, n_sym,
                                                           bucket):
    """The sequential decoder of the inflate op (no gap array) against
    the reference's table walk (buckets 8/12/16) and bit scan (32)."""
    codes = _fib_codes(n_sym, seed=n_sym)
    chunk = 256
    freq = np.bincount(codes, minlength=1024).astype(np.int32)
    lengths = thf.codeword_lengths(torch.from_numpy(freq))
    cb = thf.canonical_codebook(lengths)
    assert thf.bucket_max_len(int(cb.max_len)) == bucket
    cw, bw = t_encode.encode(torch.from_numpy(codes), cb)
    words, bits, _, _ = t_deflate.deflate(cw, bw, chunk, 64)
    nc = words.shape[0]
    n_valid = np.minimum(chunk, np.maximum(
        len(codes) - np.arange(nc) * chunk, 0)).astype(np.int32)
    dec = t_inflate.inflate(words, torch.from_numpy(n_valid),
                            thf.decode_table(lengths), gaps=None,
                            bits_used=bits, max_len_static=bucket)
    jtab = ref.hf.decode_table(ref.jnp.asarray(lengths.numpy()), bucket)
    jdec = ref.inflate.inflate(
        ref.jnp.asarray(words.numpy()), ref.jnp.asarray(bits.numpy()),
        ref.jnp.asarray(n_valid), jtab, bucket)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(dec.reshape(-1)[:len(codes)].numpy(),
                                  codes)


def _zipf_codes(rng, n, k, skew=2.0):
    p = 1.0 / np.arange(1, k + 1) ** skew
    p /= p.sum()
    return rng.choice(k, size=n, p=p).astype(np.int32)


HOST_FREQS = {
    "zipf16": lambda: np.bincount(_zipf_codes(np.random.default_rng(16),
                                              500, 16), minlength=16),
    "zipf256": lambda: np.bincount(_zipf_codes(np.random.default_rng(256),
                                               5000, 256), minlength=256),
    "zipf1024": lambda: np.bincount(_zipf_codes(
        np.random.default_rng(1024), 20000, 1024), minlength=1024),
    "ties": lambda: np.where(np.arange(64) % 3 == 0, 5, 0),
    "pair_ties": lambda: np.array([4, 4, 2, 2, 1, 1, 1, 1, 0, 8]),
    "single": lambda: np.eye(1, 32, 5, dtype=np.int64)[0] * 100,
    "empty": lambda: np.zeros(8, np.int64),
}


@pytest.mark.parametrize("case", sorted(HOST_FREQS))
def test_host_huffman_helpers_match_reference(ref, case):
    freq = HOST_FREQS[case]().astype(np.int32)
    got = thf.codeword_lengths_host(freq)
    want = ref.hf.codeword_lengths_host(freq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if not freq.any():
        return
    lengths = thf.codeword_lengths(torch.from_numpy(freq))
    tcb = thf.canonical_codebook(lengths)
    jcb = ref.hf.canonical_codebook(ref.jnp.asarray(lengths.numpy()))
    for unit in (32, 64):
        np.testing.assert_array_equal(
            thf.packed_codebook(tcb, unit).numpy(),
            np.asarray(ref.hf.packed_codebook(jcb, unit)))
    for ml in (int(tcb.max_len), 25, 26, 27, 32):
        assert thf.select_repr(ml) == ref.hf.select_repr(ml)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_decode_on_card_matches_cpu(cuda_dev, case):
    make, kw = V1_CASES[case]
    x = make()
    codec = tcodecs.get("cusz", **kw)
    v1 = _v1(tcodecs, codec.encode(x, device="cpu"))
    want = tcodecs.decode(v1).numpy()
    dev_form = _v1(tcodecs, codec.encode(x, device=cuda_dev))
    assert dev_form.payload["words"].is_cuda
    y = tcodecs.decode(dev_form)
    assert y.is_cuda
    np.testing.assert_array_equal(_bits32(y.cpu().numpy()), _bits32(want))
    p = tcodecs.decode(codec.pack(v1), device=cuda_dev)
    np.testing.assert_array_equal(_bits32(p.cpu().numpy()), _bits32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("int8", "int16", "int8-block",
                                  "lossless", "zfp"))
def test_new_codecs_on_card(cuda_dev, name):
    """Encode on the card, decode within the codec's bound; the packed
    containers equal the CPU's (zfp: its stated rate)."""
    codec = _make(tcodecs, name)
    x = torch.from_numpy(_field((64, 256), seed=9))
    c = codec.encode(x.to(cuda_dev))
    assert all(v.is_cuda for v in c.payload.values())
    y = tcodecs.decode(c)
    assert y.is_cuda and y.shape == x.shape
    err = (y.cpu() - x).abs()
    if name == "lossless":
        assert torch.equal(y.cpu(), x)
    elif name == "zfp":
        assert codec.achieved_bitrate(c) == 14 + 16.0 / 16
        assert codec.stored_nbytes(c) * 8 == 14 * c.payload["u"].numel() \
            + 16 * c.payload["e"].numel()
        assert bool(torch.isfinite(y).all())
    else:
        scale = c.payload["scale"].cpu()
        if name == "int8-block":
            scale = scale.repeat_interleave(BLOCK, dim=-1)
        tol = scale / 2 + _ulp(float(x.abs().max()), torch.float32)
        assert bool((err <= tol).all())
    if name != "zfp":
        _same_arrays(tcodecs.to_arrays(codec.pack(c))[1],
                     tcodecs.to_arrays(codec.pack(codec.encode(x)))[1])
