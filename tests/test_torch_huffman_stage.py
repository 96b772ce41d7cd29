"""The Huffman codebook stage of the port (`core.huffman`'s
`codeword_lengths`, `canonical_codebook`, `build_decode_table` and the
`huffman.*` kernels behind them) against the reference's device
functions, and the last public helpers of the main path's modules
(`core.dualquant`, `core.compressor.packed_nbytes`,
`core.zfp_like.compress_decompress`) against theirs.

On the CPU the plain versions run: bit for bit against the reference's
jitted `codeword_lengths` and `canonical_codebook`, both heap oracles and
the reference's decode tables, over seeded histograms of every kind; a
numpy model of the decode-table kernel's arithmetic equals the plain
decode table; cusz and cusz-i containers built under
``kernel_policy("torch")`` equal the reference's byte for byte.  The
`cuda` tests hold each kernel against its plain version on the card and
check that the cusz path reads nothing back inside the stage; they skip
without a card.  On the card:
``python -m pytest -m cuda tests/test_torch_huffman_stage.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_spmd import reference_modules

from repro_torch import codecs as tcodecs
from repro_torch.core import compressor as TCZ
from repro_torch.core import dualquant as tdq
from repro_torch.core import huffman as thf
from repro_torch.core import zfp_like as tzfp
from repro_torch.kernels import dispatch

KS = (2, 3, 256, 1024, 4096)
KINDS = ("random", "sparse", "all_equal", "one", "two", "fibonacci",
         "large", "skewed", "empty", "fibonacci_deep", "ties")
CASES = [(kind, k) for kind in KINDS for k in KS]
BIG = (2 ** 31 - 1) // 4          # the reference's key of an unused bin


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported on first use with an unarmed
    stand-in for the `repro.dist.chaos` module the checkout lacks; every
    `repro*` module the import added leaves `sys.modules` again at
    teardown, so later reference test files on the same worker import
    as they would alone."""
    yield from reference_modules(
        jax="jax", jnp="jax.numpy", hf="repro.core.huffman",
        dq="repro.core.dualquant", CZ="repro.core.compressor",
        zfp="repro.core.zfp_like", codecs="repro.codecs",
        sci="repro.data.scidata")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _fib(m: int):
    f = [1, 1]
    while len(f) < m:
        f.append(f[-1] + f[-2])
    return f[:m]


def make_hist(kind: str, k: int, seed: int) -> np.ndarray:
    """An int32 histogram of `k` bins whose total stays below 2^31 (the
    reference sums merged frequencies in int32)."""
    rng = np.random.default_rng(seed)
    f = np.zeros(k, np.int64)
    if kind == "random":
        f = rng.integers(0, 1000, k)
    elif kind == "sparse":                    # mostly empty bins
        idx = rng.choice(k, size=max(1, k // 10), replace=False)
        f[idx] = rng.integers(1, 1 << 20, idx.size)
    elif kind == "all_equal":
        f[:] = rng.integers(1, 100)
    elif kind == "one":
        f[rng.integers(k)] = rng.integers(1, 1 << 28)
    elif kind == "two":
        f[rng.choice(k, size=2, replace=False)] = rng.integers(1, 1 << 28, 2)
    elif kind == "fibonacci":                 # max_len up to 31
        m = min(k, int(rng.integers(3, 33)))
        f[rng.choice(k, size=m, replace=False)] = _fib(m)
    elif kind == "large":                     # counts up to 2^28
        m = min(k, 7)
        f[rng.choice(k, size=m, replace=False)] = rng.integers(
            1 << 20, (1 << 28) + 1, m)
        f[rng.random(k) < 0.5] += rng.integers(0, 1000)
    elif kind == "fibonacci_deep":            # max_len 32-43: lengths > 32
        m = min(k, int(rng.integers(33, 45)))
        f[rng.choice(k, size=m, replace=False)] = _fib(m)
    elif kind == "ties":                      # a leaf equals a merged node
        m = min(k, int(rng.integers(3, 300)))  # at many picks
        f[rng.choice(k, size=m, replace=False)] = 1 << rng.integers(0, 8, m)
    elif kind == "skewed":                    # error-bounded codes' shape
        c = np.rint(rng.normal(k / 2, max(k / 64, 0.5), 200_000))
        f = np.bincount(np.clip(c, 0, k - 1).astype(np.int64), minlength=k)
    elif kind != "empty":
        raise ValueError(kind)
    assert f.sum() < 2 ** 31
    return f.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _case(kind: str, k: int) -> np.ndarray:
    return make_hist(kind, k, seed=k * 31 + KINDS.index(kind))


def _eq(got: torch.Tensor, want, what: str = ""):
    if got.dtype == torch.uint32:
        got = got.view(torch.int32).numpy().view(np.uint32)
    else:
        got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def check_stage(ref, freq: np.ndarray) -> None:
    """The port's plain stage against the reference's on one histogram."""
    tl = thf.codeword_lengths(torch.from_numpy(freq))
    jl = np.asarray(ref.hf.codeword_lengths(ref.jnp.asarray(freq)))
    _eq(tl, jl, "lengths vs the reference's device loop")
    if freq.max(initial=0) <= BIG:
        # the device loop keys unused bins INT_MAX / 4, so a larger
        # frequency sorts after them (Fibonacci's 44th, 701,408,733): the
        # heap oracles know no such key, and only the device loop holds
        _eq(tl, ref.hf.codeword_lengths_host(freq),
            "lengths vs the heap oracle")
        _eq(tl, thf.codeword_lengths_host(freq),
            "lengths vs the port's oracle")
    assert tl.device.type == "cpu" and tl.dtype == torch.int32

    tcb = thf.canonical_codebook(tl)
    jcb = ref.hf.canonical_codebook(ref.jnp.asarray(jl))
    for f in thf.Codebook._fields:
        _eq(getattr(tcb, f), getattr(jcb, f), f)

    table = thf.build_decode_table(tl)
    max_len = int(tcb.max_len)
    jtab = ref.hf.build_decode_table(ref.jnp.asarray(jl),
                                     thf.bucket_max_len(max(1, max_len)))
    for f in thf.Codebook._fields:
        _eq(getattr(table.cb, f), getattr(jtab.cb, f), f"table.cb.{f}")
    _eq(table.thresh, jtab.thresh, "thresh")
    _eq(table.lmask, jtab.lmask, "lmask")
    if 1 <= max_len <= thf.LUT_BITS:
        # the reference's dense LUT, where every prefix starts a codeword
        jsym, jlen = ref.hf._build_lut(jcb, thf.LUT_BITS)
        used = tl[tl > 0].long()
        covered = int((1 << (thf.LUT_BITS - used)).sum())
        lut = table.lut.long()[:covered]
        assert bool((lut != 0).all())
        _eq((lut >> 6).to(torch.int32), np.asarray(jsym)[:covered], "sym")
        _eq((lut & 63).to(torch.int32), np.asarray(jlen)[:covered], "len")


@pytest.mark.parametrize("kind,k", CASES)
def test_plain_stage_matches_reference(ref, kind, k):
    check_stage(ref, _case(kind, k))


@settings(max_examples=40, deadline=None)
@given(st.sampled_from(KINDS), st.sampled_from(KS),
       st.integers(0, 2 ** 32 - 1))
def test_plain_stage_matches_reference_drawn(ref, kind, k, seed):
    check_stage(ref, make_hist(kind, k, seed))


def test_fibonacci_reaches_max_len_31(ref):
    freq = np.zeros(1024, np.int32)
    freq[100:132] = _fib(32)
    check_stage(ref, freq)
    assert int(thf.canonical_codebook(thf.codeword_lengths(
        torch.from_numpy(freq))).max_len) == 31


def _wrapping_hist() -> np.ndarray:
    freq = np.full(16, (1 << 28) + 12345, np.int32)
    freq[3] = 7
    return freq


def test_int32_sums_wrap_as_in_the_reference(ref):
    """Totals past 2^31 wrap in the reference's int32 merge; the port's
    picks follow them."""
    freq = _wrapping_hist()
    tl = thf.codeword_lengths(torch.from_numpy(freq))
    _eq(tl, np.asarray(ref.hf.codeword_lengths(ref.jnp.asarray(freq))))


def any_lengths(k: int, seed: int) -> np.ndarray:
    """An int32 lengths vector of no tree: unused (<= 0), every length up
    to 32, 33 (which the canonical order keys like an unused symbol) and
    beyond (sorted after it by raw value), up to k - 1 as wrapping sums
    can give."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        return rng.integers(-3, 48, k).astype(np.int32)
    if kind == 1:                             # around the 32 / 33 edge
        return rng.integers(30, 37, k).astype(np.int32)
    return rng.integers(0, max(k, 2), k).astype(np.int32)


@pytest.mark.parametrize("k", [1, 33, 1000, 4097])
def test_plain_codebook_matches_reference_on_any_lengths(ref, k):
    for seed in range(3):
        lengths = any_lengths(k, seed)
        tcb = thf.canonical_codebook(torch.from_numpy(lengths))
        jcb = ref.hf.canonical_codebook(ref.jnp.asarray(lengths))
        for f in thf.Codebook._fields:
            _eq(getattr(tcb, f), getattr(jcb, f), f"{f} (seed {seed})")


def short_lengths(k: int, seed: int) -> np.ndarray:
    """An int32 lengths vector with max_len <= 12, whose codewords the
    LUT alone decodes: over-full codes, incomplete codes (a few symbols,
    or every one at 12 bits), complete ones and a single active symbol.
    Where the code is incomplete, `peek_decode`'s clamped index fills LUT
    entries that start no codeword with real symbols."""
    rng = np.random.default_rng(seed)
    kind = seed % 5
    if kind == 0:                             # over-full, unused included
        return rng.integers(-1, 13, k).astype(np.int32)
    lengths = np.zeros(k, np.int32)
    if kind == 1:                             # incomplete: a few symbols
        m = int(rng.integers(1, min(k, 40) + 1))
        lengths[rng.choice(k, m, replace=False)] = rng.integers(1, 13, m)
    elif kind == 2:                           # one active symbol
        lengths[rng.integers(k)] = rng.integers(1, 13)
    elif kind == 3:                           # complete: 2^b symbols of b
        b = int(rng.integers(0, min(12, int(np.log2(k))) + 1))
        lengths[rng.choice(k, 1 << b, replace=False)] = max(b, 1)
    else:                                     # every symbol at 12 bits
        lengths[:] = 12
    return lengths


DRAW_KS = (1, 33, 1000, 4097, 16384)


def lut_draws():
    """(k, seed, lengths) of the decode table's draws: lengths vectors of
    no tree, and short ones."""
    for k in DRAW_KS:
        for seed in range(6):
            yield k, seed, any_lengths(k, seed)
            yield k, seed, short_lengths(k, seed)


def edge_codebooks(n: int = 60, k: int = 64):
    """Codebooks whose first codes are drawn at random (no lengths vector
    gives them), with length 32's threshold, the only one that can end in
    20 or 25 one bits, exactly at an entry's last peek, at the last peek
    of 32 entries, at an entry's first peek or one above it: the edges of
    the kernel's marks and split bits.  max_len is above 32, so every
    threshold is masked; most entries then have a length above 12."""
    rng = np.random.default_rng(25)
    for i in range(n):
        lengths = rng.integers(1, 48, k).astype(np.int32)
        lengths[0] = 40
        cb = thf.canonical_codebook(torch.from_numpy(lengths))
        e = int(rng.integers(0, 1024))
        target = ((e << 20) | 0xFFFFF, ((e - e % 32) << 20) | 0x1FFFFFF,
                  e << 20, (e << 20) | 1)[i % 4]
        fc = rng.integers(0, 1 << 32, thf.MAXLEN + 1, dtype=np.int64)
        fc[thf.MAXLEN] = (target - int((lengths >= thf.MAXLEN).sum())
                          ) & 0xFFFFFFFF
        yield cb._replace(first_code=thf.as_u32(torch.from_numpy(fc)))


def decode_table_model(cb) -> tuple:
    """The decode-table kernel's arithmetic in numpy: (thresh, lmask,
    lut).  Each masked threshold (in no particular order) marks the entry
    whose span of peeks holds it and, above that span's lowest peek, sets
    the entry's split bit; an entry's length is 1 + the marks at or before
    it, and only an entry of length <= 12 with no split bit gathers a
    symbol."""
    m32 = 0xFFFFFFFF
    lengths = cb.lengths.numpy().astype(np.int64)
    fc = cb.first_code.view(torch.int32).numpy().view(np.uint32).astype(
        np.int64)
    st = cb.start_idx.numpy().astype(np.int64)
    sym = cb.sym_canon.numpy().astype(np.int64)
    k, mx = lengths.size, int(cb.max_len)
    cnt = np.bincount(np.clip(lengths, 0, thf.MAXLEN),
                      minlength=thf.MAXLEN + 1)
    ell = np.arange(1, thf.MAXLEN + 1)
    th = ((fc[1:] + cnt[1:]) & m32) << (31 - np.arange(thf.MAXLEN)) & m32
    masked = ell < mx
    span, n = 32 - thf.LUT_BITS, 1 << thf.LUT_BITS
    p, inside = th >> span, (th & ((1 << span) - 1)) != 0
    marks = np.bincount(p[masked], minlength=n)
    split = np.zeros(n, bool)
    split[p[masked & inside]] = True
    ln = np.cumsum(marks) + 1
    lc = np.minimum(ln, thf.LUT_BITS)
    code = (np.arange(n, dtype=np.int64) << span) >> (32 - lc)
    diff = (((code - fc[lc]) & m32) ^ (1 << 31)) - (1 << 31)
    idx = np.clip(st[lc] + diff, 0, k - 1)
    ok = ~split & (ln <= thf.LUT_BITS)
    lut = np.where(ok, ((sym[idx] << 6) | ln) & m32, 0)
    thresh = np.concatenate([[(fc[0] << 31) & m32], th])
    lmask = np.concatenate([[0], masked]).astype(np.int32)
    return (thresh.astype(np.uint32), lmask,
            lut.astype(np.uint32).view(np.int32))


def test_decode_table_model_equals_plain_on_draws():
    """The kernel's marks, split bits and gather, modelled in numpy, equal
    the plain decode table on lengths of no tree, short codes, the edge
    codebooks and the seeded histograms' codebooks."""
    from repro_torch.kernels.huffman import ref as href

    def check(cb, what):
        for name, got, want in zip(("thresh", "lmask", "lut"),
                                   decode_table_model(cb),
                                   href.decode_table_ref(cb)):
            _eq(want, got, f"{name} ({what})")

    def codebook(lengths):
        return thf.canonical_codebook(torch.from_numpy(lengths))

    for k, seed, lengths in lut_draws():
        check(codebook(lengths), f"k {k}, seed {seed}")
    for i, cb in enumerate(edge_codebooks()):
        check(cb, f"edge codebook {i}")
    for kind, k in CASES:
        lengths = thf.codeword_lengths(torch.from_numpy(_case(kind, k)))
        check(codebook(lengths.numpy()), f"{kind} {k}")


@pytest.mark.parametrize("fn", ["codeword_lengths", "canonical_codebook",
                                "build_decode_table", "decode_table"])
def test_explicit_cuda_on_cpu_raises(fn):
    x = torch.from_numpy(_case("random", 256))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(thf, fn)(x, impl="cuda")
    with dispatch.kernel_policy("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            getattr(thf, fn)(x)


def test_plain_stage_keeps_the_device_and_launches_nothing():
    dispatch.reset_launches()
    freq = torch.from_numpy(_case("skewed", 1024))
    lengths = thf.codeword_lengths(freq)
    table = thf.build_decode_table(lengths)
    assert all(t.device.type == "cpu"
               for t in (*table.cb, table.thresh, table.lmask, table.lut))
    assert set(dispatch.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# containers under the plain stage, byte for byte with the reference's
# ---------------------------------------------------------------------------

CODEC_KW = {"cusz": dict(eb=1e-4, eb_mode="valrel"),
            "cusz-i": dict(eb=1e-4, eb_mode="valrel", outlier_frac=1.0)}


@pytest.mark.parametrize("field", ["nyx", "cesm", "hacc"])
@pytest.mark.parametrize("name", sorted(CODEC_KW))
def test_containers_byte_identical_under_plain_policy(ref, name, field):
    f = ref.sci.all_fields(small=True)[field]
    rc = ref.codecs.get(name, **CODEC_KW[name])
    rh, ra = ref.codecs.to_arrays(rc.pack(rc.encode(ref.jnp.asarray(f))))
    tc = tcodecs.get(name, **CODEC_KW[name])
    with dispatch.kernel_policy("torch"):
        packed = tc.pack(tc.encode(f, device="cpu"))
        th, ta = tcodecs.to_arrays(packed)
        y = tcodecs.decode(packed, device="cpu")
    assert th == rh
    assert sorted(ta) == sorted(ra)
    for key in ta:
        x, w = np.asarray(ta[key]), np.asarray(ra[key])
        assert x.dtype == w.dtype and x.tobytes() == w.tobytes(), key
    np.testing.assert_array_equal(
        y.numpy().view(np.int32),
        np.asarray(ref.codecs.decode(rc.pack(rc.encode(
            ref.jnp.asarray(f)))), np.float32).view(np.int32))


# ---------------------------------------------------------------------------
# the last public helpers of dualquant, compressor and zfp_like
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((300,), (0,)), ((17, 23), (0, 1)),
                                        ((17, 23), (1, 0)), ((17, 23), (1,)),
                                        ((5, 6, 7), (0, 1, 2)),
                                        ((5, 6, 7), (2, 0))])
def test_lorenzo_delta_and_reconstruct_match_reference(ref, shape, axes):
    rng = np.random.default_rng(len(shape) * 10 + axes[0])
    q = rng.integers(-2 ** 20, 2 ** 20, shape).astype(np.int32)
    td = tdq.lorenzo_delta(torch.from_numpy(q), axes)
    jd = ref.dq.lorenzo_delta(ref.jnp.asarray(q), axes)
    _eq(td, jd, "delta")
    assert td.dtype == torch.int32
    tr = tdq.lorenzo_reconstruct(td, axes)
    _eq(tr, ref.dq.lorenzo_reconstruct(jd, axes), "reconstruct")
    _eq(tr, q, "inverse")


@pytest.mark.parametrize("shape,block", [((1000,), (256,)),
                                         ((40, 70), (16, 16)),
                                         ((20, 19, 9), (8, 8, 8))])
def test_blocked_delta_and_reconstruct_match_reference(ref, shape, block):
    rng = np.random.default_rng(sum(shape))
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    eb = 1e-3
    # the reference's pipeline runs these under jit (its PREQUANT is the
    # compiled multiply); the port follows the compiled form
    jdelta = ref.jax.jit(ref.dq.blocked_delta, static_argnums=(1, 2))(
        ref.jnp.asarray(x), eb, block)
    tdelta = tdq.blocked_delta(torch.from_numpy(x), eb, block)
    _eq(tdelta, jdelta, "blocked delta")
    jrec = ref.jax.jit(ref.dq.blocked_reconstruct,
                       static_argnums=(1, 2, 3))(jdelta, eb, block, shape)
    trec = tdq.blocked_reconstruct(tdelta, eb, block, shape)
    _eq(trec.view(torch.int32), np.asarray(jrec).view(np.int32), "recon")
    assert float((trec - torch.from_numpy(x)).abs().max()) <= eb * 1.001


def test_packed_nbytes_matches_reference(ref):
    f = ref.sci.all_fields(small=True)["cesm"]
    cfg = dict(eb=1e-4, eb_mode="valrel")
    jblob, _ = ref.CZ.compress(ref.jnp.asarray(f),
                               ref.CZ.CompressorConfig(**cfg))
    tblob, _ = TCZ.compress(torch.from_numpy(f), TCZ.CompressorConfig(**cfg))
    want = ref.CZ.packed_nbytes(ref.CZ.pack_blob(jblob))
    assert TCZ.packed_nbytes(TCZ.pack_blob(tblob)) == want > 0


@pytest.mark.parametrize("shape", [(300,), (33, 21), (9, 10, 11),
                                   (2, 5, 6, 7)])
@pytest.mark.parametrize("rate", [4.0, 10.4, 14])
def test_zfp_compress_decompress_matches_reference(ref, shape, rate):
    rng = np.random.default_rng(len(shape) + int(rate))
    x = (np.cumsum(rng.standard_normal(shape), axis=-1)
         * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
    jrec, jrate = ref.zfp.compress_decompress(ref.jnp.asarray(x), rate)
    trec, trate = tzfp.compress_decompress(torch.from_numpy(x), rate)
    assert trate == jrate
    assert tuple(trec.shape) == shape
    _eq(trec.view(torch.int32), np.asarray(jrec).view(np.int32), "recon")


# ---------------------------------------------------------------------------
# the card: each kernel against its plain version, the cusz path
# ---------------------------------------------------------------------------

def check_kernels_on_card(freq: np.ndarray, dev: torch.device) -> None:
    f = torch.from_numpy(freq).to(dev)
    kl = thf.codeword_lengths(f, impl="cuda")
    pl = thf.codeword_lengths(f, impl="torch")
    assert kl.is_cuda and torch.equal(kl, pl)
    kcb = thf.canonical_codebook(kl, impl="cuda")
    pcb = thf.canonical_codebook(kl, impl="torch")
    for name, a, b in zip(thf.Codebook._fields, kcb, pcb):
        assert a.dtype == b.dtype and a.is_cuda, name
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    kt = thf.build_decode_table(kl, impl="cuda")
    pt = thf.build_decode_table(kl, impl="torch")
    assert torch.equal(kt.thresh.view(torch.int32),
                       pt.thresh.view(torch.int32))
    assert torch.equal(kt.lmask, pt.lmask)
    assert torch.equal(kt.lut, pt.lut)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k", CASES)
def test_kernels_equal_plain_on_card(cuda_dev, kind, k):
    check_kernels_on_card(_case(kind, k), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [256, 1024, 4096, 16384])
def test_kernels_equal_plain_on_card_random(cuda_dev, nbins):
    """200 seeded histograms per width; 16384 bins take the global
    scratch in place of shared memory."""
    before = dispatch.launch_counts()
    for seed in range(200):
        kind = KINDS[seed % len(KINDS)]
        check_kernels_on_card(make_hist(kind, nbins, seed), cuda_dev)
    after = dispatch.launch_counts()
    assert after["huffman.tree"] - before["huffman.tree"] == 200
    assert after["huffman.codebook"] - before["huffman.codebook"] == 400
    assert after["huffman.decode_table"] - before[
        "huffman.decode_table"] == 200


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1000, 4097])
def test_kernels_equal_plain_on_card_odd_widths(cuda_dev, kind, k):
    """Widths that are not powers of two, nor whole tiles of the CTA."""
    for seed in range(4):
        check_kernels_on_card(make_hist(kind, k, seed), cuda_dev)


@pytest.mark.cuda
def test_kernels_equal_plain_on_card_16384_all_active(cuda_dev):
    """Every one of 16,384 bins active: the tree's workspace takes the
    global scratch."""
    from repro_torch.kernels.huffman import ops
    assert ops._scratch_bytes("tree", 16384) > 0
    for seed in range(3):
        freq = np.random.default_rng(seed).integers(1, 1 << 16, 16384)
        check_kernels_on_card(freq.astype(np.int32), cuda_dev)


@pytest.mark.cuda
def test_int32_sums_wrap_on_card(cuda_dev):
    check_kernels_on_card(_wrapping_hist(), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 1000, 4097, 16384])
def test_codebook_equals_plain_on_card_on_any_lengths(cuda_dev, k):
    for seed in range(6):
        lengths = torch.from_numpy(any_lengths(k, seed)).to(cuda_dev)
        kcb = thf.canonical_codebook(lengths, impl="cuda")
        pcb = thf.canonical_codebook(lengths, impl="torch")
        for name, a, b in zip(thf.Codebook._fields, kcb, pcb):
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("k", DRAW_KS)
def test_decode_table_equals_plain_on_card_on_any_lengths(cuda_dev, k):
    """Lengths vectors of no tree (unordered thresholds) and short ones
    (max_len <= 12: incomplete, over-full, one active symbol), whose LUT
    entries the clamped symbol index fills."""
    for _, seed, lengths in (d for d in lut_draws() if d[0] == k):
        x = torch.from_numpy(lengths).to(cuda_dev)
        kt = thf.build_decode_table(x, impl="cuda")
        pt = thf.build_decode_table(x, impl="torch")
        for name, a, b in zip((*thf.Codebook._fields, "thresh", "lmask",
                               "lut"), (*kt.cb, *kt[1:]), (*pt.cb, *pt[1:])):
            assert a.is_cuda and a.dtype == b.dtype, name
            assert a.shape == b.shape, name
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, seed)


@pytest.mark.cuda
def test_decode_table_equals_plain_on_card_on_edge_codebooks(cuda_dev):
    """Length 32's threshold at an entry's last peek, a warp span's last
    peek and an entry's first peek (first codes of no lengths vector)."""
    from repro_torch.kernels.huffman import ops

    for i, cb in enumerate(edge_codebooks()):
        cb = thf.Codebook(*(t.to(cuda_dev) for t in cb))
        got = ops.decode_table_cuda(cb)
        for name, a, b in zip(("thresh", "lmask", "lut"), got,
                              ops.ref.decode_table_ref(cb)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["codeword_lengths", "canonical_codebook",
                                "build_decode_table"])
def test_no_fallback_when_the_kernel_fails(cuda_dev, monkeypatch, fn):
    """A refused launch or a missing library raises; the plain version
    does not step in.  For the decode table only its own entry point
    refuses, so the codebook kernel before it runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.huffman import ops

    x = torch.from_numpy(_case("random", 1024)).to(cuda_dev)
    if fn != "codeword_lengths":
        x = thf.codeword_lengths(x, impl="torch")
    real = _build.lib()
    only = "rt_huffman_decode_table" if fn == "build_decode_table" else None
    refused = "huffman.decode_table" if only else "huffman"

    class Refusing:                           # error 1 from every entry
        def __getattr__(self, name):          # point, or from `only`
            if only is None or name == only:
                return lambda *args: 1
            return getattr(real, name)

    def missing():
        raise RuntimeError("nvcc not found")

    ops._scratch_bytes.cache_clear()
    try:
        monkeypatch.setattr(_build, "lib", Refusing)
        with pytest.raises(RuntimeError, match=f"{refused}.* failed to "
                           "launch"):
            getattr(thf, fn)(x, impl="cuda")
        monkeypatch.setattr(_build, "lib", missing)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            getattr(thf, fn)(x, impl="cuda")
    finally:
        ops._scratch_bytes.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODEC_KW))
def test_nyx_containers_from_kernels_equal_plain(cuda_dev, name):
    from repro_torch.data import scidata

    x = scidata.nyx_like((64, 64, 64), seed=3, device=cuda_dev)
    codec = tcodecs.get(name, **CODEC_KW[name])
    dispatch.reset_launches()
    kern = codec.pack(codec.encode(x))
    y = tcodecs.decode(kern, device=cuda_dev)
    counts = dispatch.launch_counts()
    assert all(counts[k] >= 1 for k in ("huffman.tree", "huffman.codebook",
                                         "huffman.decode_table")), counts
    with dispatch.kernel_policy("torch"):
        plain = codec.pack(codec.encode(x))
        y_plain = tcodecs.decode(plain, device=cuda_dev)
    assert kern.header == plain.header
    ka, pa = tcodecs.to_arrays(kern)[1], tcodecs.to_arrays(plain)[1]
    assert sorted(ka) == sorted(pa)
    for key in ka:
        assert np.asarray(ka[key]).tobytes() == np.asarray(pa[key]).tobytes()
    assert torch.equal(y.view(torch.int32), y_plain.view(torch.int32))


@pytest.mark.cuda
def test_cusz_path_reads_nothing_inside_the_stage(cuda_dev):
    """Encode and decode on the card: no read (waived or not) inside
    core/huffman.py or the codebook kernels' module."""
    from tools.lint import waived_spans

    from repro_torch.data import scidata
    from repro_torch.debug import host_sync_guard

    allowed = waived_spans(_port_root())
    x = scidata.nyx_like((64, 64, 64), seed=3, device=cuda_dev)
    codec = tcodecs.get("cusz", **CODEC_KW["cusz"])
    want = tcodecs.decode(codec.encode(x))
    with host_sync_guard(allowed, strict=False) as log:
        c = codec.encode(x)
        y = tcodecs.decode(c)
    assert log.violations == []
    stage = [h for h in log.allowed_hits
             if "core/huffman.py" in h or "kernels/huffman" in h]
    assert stage == [], stage
    assert torch.equal(y, want)


def _port_root() -> str:
    import os

    import repro_torch
    return os.path.dirname(repro_torch.__file__)
