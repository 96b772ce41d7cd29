"""Port parity, per kernel: each plain PyTorch version in `repro_torch`
against the reference JAX function on the same numpy-seeded inputs, with
tolerance 0 (integers, codewords, bitstreams and floats alike).  Every
kernel also gets one case against the reference's Pallas kernel run in
interpret mode.

The `cuda` tests hold each CUDA kernel against its plain version on the
card; they decide inside a fixture whether a card is present and skip
without one.  On the card: `python -m pytest -m cuda tests/test_torch_*.py`.
"""
from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import dualquant as tdq
from repro_torch.core import huffman as thf
from repro_torch.kernels.deflate import ops as t_deflate
from repro_torch.kernels.encode import ops as t_encode
from repro_torch.kernels.histogram import ops as t_hist
from repro_torch.kernels.inflate import ops as t_inflate
from repro_torch.kernels.lorenzo import ops as t_lorenzo

NBINS = 1024


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported on first use (so the card tests run
    where JAX is absent).  `import repro.core` fails the first time in a
    fresh process, because `repro.dist` imports a `chaos` module that the
    checkout lacks; the failed import leaves the partly initialised
    modules behind and the second attempt succeeds.  Hence one retry."""
    try:
        importlib.import_module("repro.core")
    except ImportError:
        importlib.import_module("repro.core")
    names = {"jnp": "jax.numpy", "dq": "repro.core.dualquant",
             "hf": "repro.core.huffman",
             "lorenzo": "repro.kernels.lorenzo.ops",
             "hist": "repro.kernels.histogram.ops",
             "encode": "repro.kernels.encode.ops",
             "deflate": "repro.kernels.deflate.ops",
             "inflate": "repro.kernels.inflate.ops"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":                       # compare float bits
        a, b = a.view(np.int32), b.astype(np.float32).view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _field(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(shape), axis=-1)
            * scale).astype(np.float32)


# (data shape, block): odd shapes, both block tables, 1-D to 4-D
BLOCK_CASES = [
    ((1000,), (256,)),
    ((9000,), (4096,)),
    ((50, 37), (16, 16)),
    ((70, 130), (64, 128)),
    ((9, 17, 20), (8, 8, 8)),
    ((9, 20, 130), (8, 16, 128)),
    ((3, 9, 10, 11), (1, 8, 8, 8)),
]


# the blocks with a warp-per-block kernel in both directions
DEFAULT_BLOCKS = [(256,), (16, 16), (8, 8, 8)]


def _blocked_pair(ref, shape, block, seed=0, scale=1.0):
    x = _field(shape, seed, scale)
    jb = ref.dq.block_split(ref.dq.pad_to_blocks(ref.jnp.asarray(x), block),
                            block)
    tb = tdq.block_split(tdq.pad_to_blocks(torch.from_numpy(x), block), block)
    return jb, tb


# ---------------------------------------------------------------------------
# Lorenzo dual-quant and its inverse
# ---------------------------------------------------------------------------

class TestLorenzo:
    @pytest.mark.parametrize("shape,block", BLOCK_CASES)
    def test_pad_and_block_split_match_reference(self, ref, shape, block):
        jb, tb = _blocked_pair(ref, shape, block)
        _eq(tb.numpy(), jb, "blocked")
        merged = tdq.block_merge(tb, block)
        _eq(merged.numpy(), ref.dq.block_merge(jb, block), "merged")

    @pytest.mark.parametrize("shape,block", BLOCK_CASES)
    @pytest.mark.parametrize("eb", [1e-2, 1e-3])
    def test_dualquant_matches_reference(self, ref, shape, block, eb):
        jb, tb = _blocked_pair(ref, shape, block, seed=len(shape))
        jc, jd = ref.lorenzo.dualquant_blocks(jb, eb, NBINS, impl="jax")
        tc, td = t_lorenzo.dualquant_blocks(tb, eb, NBINS)
        _eq(tc.numpy(), jc, "codes")
        _eq(td.numpy(), jd, "delta")

    @pytest.mark.parametrize("shape,block", BLOCK_CASES)
    def test_reverse_matches_reference(self, ref, shape, block):
        rng = np.random.default_rng(1)
        nb = tuple(-(-s // b) for s, b in zip(shape, block))
        delta = rng.integers(-500, 500, nb + block).astype(np.int32)
        jr = ref.lorenzo.reverse_blocks(ref.jnp.asarray(delta), 1e-3,
                                        impl="jax")
        tr = t_lorenzo.reverse_blocks(torch.from_numpy(delta), 1e-3)
        _eq(tr.numpy(), jr, "reverse")

    def test_rint_ties_match_reference(self, ref):
        """Values on exact rint ties of x / (2 eb).  The reference's
        compiled PREQUANT multiplies by the f32 reciprocal of 2 eb (XLA's
        form of a division by a constant), and the port follows it, not an
        IEEE division."""
        eb = 1e-4
        two = np.float32(2 * eb)
        k = np.arange(-2000, 2000, dtype=np.float32)
        x = ((k + np.float32(0.5)) * two).astype(np.float32).reshape(1, 4000)
        jc, jd = ref.lorenzo.dualquant_blocks(ref.jnp.asarray(x), eb, NBINS,
                                              impl="jax")
        tc, td = t_lorenzo.dualquant_blocks(torch.from_numpy(x), eb, NBINS)
        _eq(td.numpy(), jd, "delta on ties")

    def test_pallas_interpret_dualquant_and_reverse(self, ref):
        jb, tb = _blocked_pair(ref, (40, 24), (16, 16), seed=5)
        jc, jd = ref.lorenzo.dualquant_blocks(jb, 1e-3, NBINS,
                                              impl="pallas-interpret")
        tc, td = t_lorenzo.dualquant_blocks(tb, 1e-3, NBINS)
        _eq(tc.numpy(), jc, "codes")
        _eq(td.numpy(), jd, "delta")
        jr = ref.lorenzo.reverse_blocks(jd, 1e-3, impl="pallas-interpret")
        _eq(t_lorenzo.reverse_blocks(td, 1e-3).numpy(), jr, "reverse")


# (field shape, block): the field entry `dualquant_field` against the
# reference's pad + block split + dual-quant.  1-D ragged tails (HACC's
# remainder of 75 last), 2-D with a ragged first axis (CESM-like) and
# both axes ragged, 3-D with one, two and three ragged axes and an
# interior 64^3, 4-D under (1,8,8,8), and the TPU blocks
FIELD_CASES = [
    ((256 * 21 + 3,), (256,)), ((1,), (256,)), ((255,), (256,)),
    ((257,), (256,)), ((256 * 4096 + 75,), (256,)),
    ((40, 3600), (16, 16)), ((50, 37), (16, 16)),
    ((16, 24, 19), (8, 8, 8)), ((17, 24, 19), (8, 8, 8)),
    ((9, 17, 20), (8, 8, 8)), ((64, 64, 64), (8, 8, 8)),
    ((2, 17, 17, 9), (1, 8, 8, 8)),
    ((9000,), (4096,)), ((70, 130), (64, 128)), ((9, 20, 130), (8, 16, 128)),
]

# the field as a view: "offset" starts one value (4 B) into its storage,
# "transposed" has a last axis that is not unit-stride
FIELD_VIEWS = [((256 * 21 + 3,), (256,), "offset"),
               ((40, 3600), (16, 16), "offset"),
               ((9, 17, 20), (8, 8, 8), "offset"),
               ((64, 64, 64), (8, 8, 8), "offset"),
               ((37, 50), (16, 16), "transposed"),
               ((16, 24, 19), (8, 8, 8), "transposed")]


def _field_view(shape, layout, seed=6, device="cpu"):
    """A float32 field of `shape` laid out as `layout` ("contiguous",
    "offset" or "transposed"), and its values as a numpy array."""
    x = _field(shape, seed, 10.0)
    n = x.size
    if layout == "offset":
        flat = torch.zeros(n + 1, dtype=torch.float32, device=device)
        flat[1:] = torch.from_numpy(x.reshape(-1)).to(device)
        t = flat[1:].view(shape)
    elif layout == "transposed":
        t = torch.from_numpy(np.ascontiguousarray(x.swapaxes(-1, -2))
                             ).to(device).transpose(-1, -2)
    else:
        t = torch.from_numpy(x).to(device)
    return t, x


def _addressed(x, block):
    """What the dual-quant kernels read for `dualquant_field(x, block)`,
    worked out from the kernel layout the wrapper hands them (grid
    coordinates times steps, in-block coordinates clamped per axis):
    a blocked [nb..., b...] tensor."""
    block = tuple(block)
    axes = t_lorenzo.field_axes(x.shape, x.stride(), block)
    grid, inner = t_lorenzo.kernel_layout(axes, block)
    nblocks = int(np.prod([nb for nb, _ in grid]))
    total = int(np.prod([a[0] for a in inner]))
    r = torch.arange(nblocks, dtype=torch.int64)
    base = torch.zeros(nblocks, dtype=torch.int64)
    last = [torch.full((nblocks,), a[0] - 1, dtype=torch.int64)
            for a in inner]
    for g in reversed(range(len(grid))):
        nb, step = grid[g]
        c = r % nb
        r = r // nb
        base += c * step
        for a, (size, axis, _, extent) in enumerate(inner):
            if axis == g:
                last[a] = torch.minimum(last[a], extent - 1 - c * size)
    i = torch.arange(total, dtype=torch.int64)
    at = base[:, None].expand(nblocks, total).clone()
    inner_stride = total
    for a, (size, _, stride, _) in enumerate(inner):
        inner_stride //= size
        coord = (i // inner_stride) % size
        at += torch.minimum(coord[None, :], last[a][:, None]) * stride
    storage = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,),
                               (1,), 0)
    nb = tuple(a[0] for a in axes)
    return storage[x.storage_offset() + at].reshape(nb + block)


class TestLorenzoField:
    """`dualquant_field`: the plain path against the reference, and the
    kernel's addressing worked out on the CPU."""

    @pytest.mark.parametrize("shape,block,layout", [
        (s, b, "contiguous") for s, b in FIELD_CASES] + FIELD_VIEWS)
    def test_plain_matches_reference(self, ref, shape, block, layout):
        xt, x = _field_view(shape, layout)
        jb = ref.dq.block_split(ref.dq.pad_to_blocks(ref.jnp.asarray(x),
                                                     block), block)
        jc, jd = ref.lorenzo.dualquant_blocks(jb, 1e-3, NBINS, impl="jax")
        tc, td = t_lorenzo.dualquant_field(xt, block, 1e-3, NBINS,
                                           impl="torch")
        _eq(tc.numpy(), jc, "codes")
        _eq(td.numpy(), jd, "delta")

    @pytest.mark.parametrize("shape,block,layout", [
        (s, b, "contiguous") for s, b in FIELD_CASES] + FIELD_VIEWS + [
        ((3, 2, 17, 17, 9), (1, 1, 8, 8, 8), "contiguous"),
        ((5, 300), (1, 256), "contiguous"), ((300, 5), (256, 1), "offset"),
        ((3, 5, 9, 17), (2, 4, 4, 8), "transposed")])
    def test_kernel_addressing_is_pad_and_split(self, shape, block, layout):
        """The layout `kernel_layout` gives the kernels (merged leading
        axes, clamped edges, strides of views) reads exactly the values
        of `block_split(pad_to_blocks(x))`."""
        xt, _ = _field_view(shape, layout)
        want = tdq.block_split(tdq.pad_to_blocks(xt, block), block)
        got = _addressed(xt, block)
        assert torch.equal(got, want)

    def test_layout_merges_leading_axes_and_refuses_what_it_cannot_take(
            self):
        axes = t_lorenzo.field_axes((3, 2, 17, 17, 9), (5202, 2601, 153, 9,
                                                         1), (1, 1, 8, 8, 8))
        grid, inner = t_lorenzo.kernel_layout(axes, (1, 1, 8, 8, 8))
        assert grid[0] == (6, 2601) and len(grid) == 4
        assert [a[1] for a in inner] == [-1, 1, 2, 3]
        with pytest.raises(ValueError, match="four non-unit"):
            t_lorenzo.kernel_layout(t_lorenzo.field_axes(
                (4,) * 5, (256, 64, 16, 4, 1), (2,) * 5), (2,) * 5)
        with pytest.raises(ValueError, match="more than 8"):
            # nine unit-block axes in reversed strides: none merge
            t_lorenzo.kernel_layout(t_lorenzo.field_axes(
                (2,) * 9, tuple(2 ** a for a in range(9)), (1,) * 9),
                (1,) * 9)

    def test_plain_path_counts_a_host_copy_per_call(self):
        k = t_lorenzo.DUALQUANT
        x = torch.from_numpy(_field((50, 37), 2))
        before, launches = k.host_copies, k.launches
        for i in range(3):
            t_lorenzo.dualquant_field(x, (16, 16), 1e-3, NBINS)
            assert k.host_copies == before + i + 1
        xb = tdq.block_split(tdq.pad_to_blocks(x, (16, 16)), (16, 16))
        t_lorenzo.dualquant_blocks(xb, 1e-3, NBINS)
        assert k.host_copies == before + 3 and k.launches == launches

    @pytest.mark.parametrize("shape,block", [
        ((256 * 21 + 3,), None), ((40, 3600), None), ((9, 17, 20), None),
        ((2, 17, 17, 9), None), ((9, 20, 130), (8, 16, 128))])
    def test_predict_matches_the_old_composition(self, shape, block):
        """`LorenzoPredictor.predict` through the field entry gives the
        codes and the outlier store that pad + split + `dualquant_blocks`
        + `extract_outliers` gave."""
        from repro_torch.core import compressor as tcz
        from repro_torch.core import stages as tst
        from repro_torch.kernels import dispatch as tdisp

        cfg = tcz.CompressorConfig(eb=1e-3, eb_mode="abs", block=block,
                                   outlier_frac=0.01)
        x = torch.from_numpy(_field(shape, 8, 10.0))
        pp = tdisp.pipeline_policy(x.device, "torch")
        codes, pay = tst.get_predictor("lorenzo").predict(x, cfg, 1e-3, pp)
        blk = cfg.block_for(len(shape))
        xb = tdq.block_split(tdq.pad_to_blocks(x, blk), blk)
        oc, od = t_lorenzo.dualquant_blocks(xb, 1e-3, cfg.nbins)
        cap = tst.shape_meta(shape, cfg)[4]
        oi, ov, on = tdq.extract_outliers(od.reshape(-1),
                                          (oc != 0).reshape(-1), cap)
        assert torch.equal(codes, oc)
        assert torch.equal(pay["out_idx"], oi)
        assert torch.equal(pay["out_val"], ov)
        assert int(pay["n_outliers"]) == int(on) > 0


class TestOutliers:
    @pytest.mark.parametrize("capacity", [16, 300, 5000])
    def test_extract_outliers_matches_reference(self, ref, capacity):
        """capacity 16 overflows: n_outliers still counts every outlier."""
        rng = np.random.default_rng(2)
        delta = rng.integers(-2000, 2000, 4096).astype(np.int32)
        in_cap = np.abs(delta) < 512
        ji, jv, jn = ref.dq.extract_outliers(ref.jnp.asarray(delta),
                                             ref.jnp.asarray(in_cap), capacity)
        ti, tv, tn = tdq.extract_outliers(torch.from_numpy(delta),
                                          torch.from_numpy(in_cap), capacity)
        _eq(ti.numpy(), ji, "idx")
        _eq(tv.numpy(), jv, "val")
        assert int(tn) == int(jn) == int((~in_cap).sum())

    def test_scatter_and_codes_to_delta_match_reference(self, ref):
        rng = np.random.default_rng(3)
        codes = rng.integers(0, NBINS, 2000).astype(np.int32)
        idx = np.array([5, 17, 2000, 2 ** 31 - 1, 1999], np.int32)
        val = np.array([-900, 901, 7, 8, 1234], np.int32)
        jd = ref.dq.codes_to_delta(ref.jnp.asarray(codes), NBINS)
        td = tdq.codes_to_delta(torch.from_numpy(codes), NBINS)
        _eq(td.numpy(), jd, "codes_to_delta")
        js = ref.dq.scatter_outliers(jd, ref.jnp.asarray(idx),
                                     ref.jnp.asarray(val))
        ts = tdq.scatter_outliers(td, torch.from_numpy(idx),
                                  torch.from_numpy(val))
        _eq(ts.numpy(), js, "scatter")


# ---------------------------------------------------------------------------
# Histogram, tree build, canonical codebook
# ---------------------------------------------------------------------------

def _skewed_codes(n, nbins, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    c = np.rint(rng.standard_normal(n) * spread).astype(np.int64) + nbins // 2
    return np.clip(c, 0, nbins - 1).astype(np.int32)


class TestHistogram:
    @pytest.mark.parametrize("n,nbins", [(1, 1024), (1000, 256),
                                         (50_000, 1024)])
    def test_matches_reference(self, ref, n, nbins):
        codes = _skewed_codes(n, nbins, seed=n)
        codes[::7] = nbins                       # the pad symbol: not counted
        jh = ref.hist.histogram(ref.jnp.asarray(codes), nbins, impl="jax")
        th = t_hist.histogram(torch.from_numpy(codes), nbins)
        _eq(th.numpy(), jh, "hist")

    def test_pallas_interpret(self, ref):
        codes = _skewed_codes(3000, 256, seed=9)
        jh = ref.hist.histogram(ref.jnp.asarray(codes), 256,
                                impl="pallas-interpret")
        _eq(t_hist.histogram(torch.from_numpy(codes), 256).numpy(), jh)


def _fib(k):
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return f[:k]


FREQ_CASES = {
    "single_symbol": lambda: np.eye(1, NBINS, 512, dtype=np.int64)[0] * 77,
    "two_symbols": lambda: np.bincount([3, 3, 9], minlength=NBINS),
    "all_ties": lambda: np.where(np.arange(NBINS) % 3 == 0, 5, 0),
    "skewed": lambda: np.bincount(_skewed_codes(100_000, NBINS, 4),
                                  minlength=NBINS),
    "fibonacci_deep": lambda: np.pad(np.array(_fib(30)), (0, NBINS - 30)),
    "dense_uniformish": lambda: np.random.default_rng(6).integers(
        1, 50, NBINS),
}


class TestCodebook:
    @pytest.mark.parametrize("case", sorted(FREQ_CASES))
    def test_codeword_lengths_match_reference(self, ref, case):
        freq = FREQ_CASES[case]().astype(np.int32)
        jl = ref.hf.codeword_lengths(ref.jnp.asarray(freq))
        tl = thf.codeword_lengths(torch.from_numpy(freq))
        _eq(tl.numpy(), jl, "lengths")
        assert tl.device.type == "cpu"

    @pytest.mark.parametrize("case", sorted(FREQ_CASES))
    def test_canonical_codebook_matches_reference(self, ref, case):
        freq = FREQ_CASES[case]().astype(np.int32)
        lengths = np.array(ref.hf.codeword_lengths(ref.jnp.asarray(freq)))
        jcb = ref.hf.canonical_codebook(ref.jnp.asarray(lengths))
        tcb = thf.canonical_codebook(torch.from_numpy(lengths))
        for f in thf.Codebook._fields:
            _eq(getattr(tcb, f).numpy(), getattr(jcb, f), f)
        jt, jm = ref.hf._length_bounds(jcb)
        tt, tm = thf._length_bounds(tcb)
        _eq(tt.numpy(), jt, "thresh")
        _eq(tm.numpy(), jm, "lmask")

    @pytest.mark.parametrize("max_len", [1, 7, 8, 9, 12, 13, 16, 17, 32])
    def test_bucket_max_len_matches_reference(self, ref, max_len):
        assert thf.bucket_max_len(max_len) == ref.hf.bucket_max_len(max_len)


# ---------------------------------------------------------------------------
# Encode, deflate, inflate
# ---------------------------------------------------------------------------

def _book(ref, codes, nbins):
    """(port codebook, reference codebook) from the codes' histogram."""
    freq = np.bincount(codes[(codes >= 0) & (codes < nbins)],
                       minlength=nbins).astype(np.int32)
    lengths = thf.codeword_lengths(torch.from_numpy(freq))
    return (thf.canonical_codebook(lengths),
            ref.hf.canonical_codebook(ref.jnp.asarray(lengths.numpy())))


class TestEncode:
    @pytest.mark.parametrize("n", [1, 777, 20_000])
    def test_matches_reference(self, ref, n):
        codes = _skewed_codes(n, NBINS, seed=n + 1)
        tcb, jcb = _book(ref, codes, NBINS)
        jcw, jbw = ref.encode.encode(ref.jnp.asarray(codes), jcb, impl="jax")
        tcw, tbw = t_encode.encode(torch.from_numpy(codes), tcb)
        _eq(tcw.numpy(), jcw, "cw")
        _eq(tbw.numpy(), jbw, "bw")

    def test_pallas_interpret_and_out_of_range(self, ref):
        """A symbol outside [0, nbins) encodes to (0, 0), as in the
        reference kernel."""
        codes = _skewed_codes(600, NBINS, seed=12)
        tcb, jcb = _book(ref, codes, NBINS)
        codes[::50] = NBINS
        codes[1::50] = -3
        jcw, jbw = ref.encode.encode(ref.jnp.asarray(codes), jcb,
                                     impl="pallas-interpret")
        tcw, tbw = t_encode.encode(torch.from_numpy(codes), tcb)
        _eq(tcw.numpy(), jcw, "cw")
        _eq(tbw.numpy(), jbw, "bw")
        assert int(tbw[0::50].abs().sum()) == 0


def _streams(ref, n, chunk, sub, seed, spread=3.0):
    codes = _skewed_codes(n, NBINS, seed, spread)
    tcb, jcb = _book(ref, codes, NBINS)
    tcw, tbw = t_encode.encode(torch.from_numpy(codes), tcb)
    return codes, tcb, jcb, tcw, tbw


DEFLATE_CASES = [(1000, 256, 64), (5000, 512, 128), (9000, 4096, 128),
                 (4096, 4096, 4096), (300, 64, 64)]


class TestDeflate:
    @pytest.mark.parametrize("n,chunk,sub", DEFLATE_CASES)
    def test_matches_reference(self, ref, n, chunk, sub):
        _, _, _, tcw, tbw = _streams(ref, n, chunk, sub, seed=n)
        jout = ref.deflate.deflate(ref.jnp.asarray(tcw.numpy()),
                                   ref.jnp.asarray(tbw.numpy()), chunk, sub,
                                   impl="jax")
        tout = t_deflate.deflate(tcw, tbw, chunk, sub)
        for name, t, j in zip(("words", "bits", "gap_bits", "gap_syms"),
                              tout, jout):
            _eq(t.numpy(), j, name)

    def test_pallas_interpret(self, ref):
        _, _, _, tcw, tbw = _streams(ref, 700, 256, 64, seed=21)
        jout = ref.deflate.deflate(ref.jnp.asarray(tcw.numpy()),
                                   ref.jnp.asarray(tbw.numpy()), 256, 64,
                                   impl="pallas-interpret")
        for t, j in zip(t_deflate.deflate(tcw, tbw, 256, 64), jout):
            _eq(t.numpy(), j)


def _fib_codes(n_sym, seed):
    """Codes whose Huffman code has max_len = n_sym - 1 (Fibonacci
    frequencies build the deepest tree)."""
    counts = _fib(n_sym)
    codes = np.repeat(np.arange(n_sym) * 7 + 100, counts).astype(np.int32)
    return np.random.default_rng(seed).permutation(codes)


class TestInflate:
    @pytest.mark.parametrize("n_sym,bucket", [(8, 8), (12, 12), (16, 16),
                                              (22, 32)])
    def test_every_max_len_bucket_matches_reference(self, ref, n_sym, bucket):
        """The port's single length-interval decoder against the
        reference's LUT (buckets 8/12/16) and bit-interval (32) decoders."""
        codes = _fib_codes(n_sym, seed=n_sym)
        chunk, sub = 512, 64
        tcb, jcb = _book(ref, codes, NBINS)
        assert thf.bucket_max_len(int(tcb.max_len)) == bucket
        tcw, tbw = t_encode.encode(torch.from_numpy(codes), tcb)
        words, bits, gbits, _ = t_deflate.deflate(tcw, tbw, chunk, sub)
        nc = words.shape[0]
        n_valid = np.minimum(chunk, np.maximum(
            len(codes) - np.arange(nc) * chunk, 0)).astype(np.int32)
        jtab = ref.hf.decode_table(jcb.lengths, bucket)
        jdec = ref.inflate.inflate(
            ref.jnp.asarray(words.numpy()), ref.jnp.asarray(bits.numpy()),
            ref.jnp.asarray(n_valid), jtab, bucket,
            gaps=ref.jnp.asarray(gbits.numpy()), impl="jax")
        tdec = t_inflate.inflate(words, torch.from_numpy(n_valid),
                                 thf.decode_table(tcb.lengths), gaps=gbits)
        _eq(tdec.numpy(), jdec, "decoded")
        _eq(tdec.reshape(-1)[:len(codes)].numpy(), codes, "roundtrip")

    def test_pallas_interpret(self, ref):
        codes = _skewed_codes(900, NBINS, seed=31)
        tcb, jcb = _book(ref, codes, NBINS)
        tcw, tbw = t_encode.encode(torch.from_numpy(codes), tcb)
        words, bits, gbits, _ = t_deflate.deflate(tcw, tbw, 256, 64)
        nc = words.shape[0]
        n_valid = np.minimum(256, np.maximum(
            900 - np.arange(nc) * 256, 0)).astype(np.int32)
        ml = ref.hf.bucket_max_len(int(jcb.max_len))
        jdec = ref.inflate.inflate(
            ref.jnp.asarray(words.numpy()), ref.jnp.asarray(bits.numpy()),
            ref.jnp.asarray(n_valid), ref.hf.decode_table(jcb.lengths, ml),
            ml, gaps=ref.jnp.asarray(gbits.numpy()), impl="pallas-interpret")
        tdec = t_inflate.inflate(words, torch.from_numpy(n_valid),
                                 thf.decode_table(tcb.lengths), gaps=gbits)
        _eq(tdec.numpy(), jdec, "decoded")

    def test_gapless_stream_raises(self):
        codes = _skewed_codes(300, NBINS, seed=2)
        lengths = thf.codeword_lengths(torch.from_numpy(
            np.bincount(codes, minlength=NBINS).astype(np.int32)))
        table = thf.decode_table(lengths)
        words = torch.zeros((2, 256), dtype=torch.uint32)
        nv = torch.tensor([256, 44], dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="gap array"):
            t_inflate.inflate(words, nv, table, gaps=None, impl="cuda")
        with pytest.raises(ValueError, match="sequential"):
            t_inflate.inflate(words, nv, table, gaps=None)


def _lut_plus_compare(table, peek):
    """The inflate kernel's step decode: the LUT entry of the peek's first
    LUT_BITS bits, or the interval compare where the entry is 0."""
    e = table.lut.long()[peek >> (32 - thf.LUT_BITS)]
    sym, ln = thf.peek_decode(peek, table.cb, table.thresh, table.lmask)
    esc = e == 0
    return torch.where(esc, sym, (e >> 6).to(torch.int32)), \
        torch.where(esc, ln, e & 63)


# codebooks for the LUT: the codebook cases above, and Fibonacci
# frequencies whose Huffman code reaches max_len 8, 12, 16 and 32 (the
# buckets of LUT_BUCKETS and MAXLEN)
LUT_CASES = {**FREQ_CASES, **{
    f"fibonacci_max_len_{m}": (lambda m=m: np.pad(np.array(_fib(m + 1)),
                                                  (0, NBINS - m - 1)))
    for m in (*thf.LUT_BUCKETS, thf.MAXLEN)},
    "skewed_short": lambda: np.bincount(_skewed_codes(3000, NBINS, 9, 2.0),
                                        minlength=NBINS)}
# the cases whose max_len is at most LUT_BITS (12)
SHORT_LUT_CASES = ("all_ties", "fibonacci_max_len_8", "fibonacci_max_len_12",
                   "single_symbol", "skewed_short", "two_symbols")


class TestInflateLut:
    """The decode LUT that the inflate kernel reads (`DecodeTable.lut`)."""

    @staticmethod
    def _table(case):
        freq = LUT_CASES[case]().astype(np.int32)
        return thf.build_decode_table(thf.codeword_lengths(
            torch.from_numpy(freq)))

    @pytest.mark.parametrize("case", SHORT_LUT_CASES)
    def test_matches_reference_build_lut(self, ref, case):
        """Where max_len <= LUT_BITS every prefix that starts with a
        codeword resolves, to the reference's dense (symbol, length)."""
        table = self._table(case)
        lengths = table.cb.lengths
        assert 1 <= int(table.cb.max_len) <= thf.LUT_BITS
        jcb = ref.hf.canonical_codebook(ref.jnp.asarray(lengths.numpy()))
        jsym, jlen = ref.hf._build_lut(jcb, thf.LUT_BITS)
        # canonical codewords cover the left-aligned prefixes [0, covered)
        used = lengths[lengths > 0].long()
        covered = int((1 << (thf.LUT_BITS - used)).sum())
        lut = table.lut.long()[:covered]
        assert bool((lut != 0).all())
        _eq((lut >> 6).to(torch.int32).numpy(), np.asarray(jsym)[:covered],
            "symbol")
        _eq((lut & 63).to(torch.int32).numpy(), np.asarray(jlen)[:covered],
            "length")

    @pytest.mark.parametrize("case", sorted(LUT_CASES))
    def test_lut_plus_compare_equals_interval_decode(self, case):
        """For every 32-bit peek the LUT path gives exactly the interval
        compare's (symbol, length): checked at both ends of every LUT_BITS
        prefix and on random peeks."""
        table = self._table(case)
        span = 32 - thf.LUT_BITS
        prefix = torch.arange(1 << thf.LUT_BITS, dtype=torch.int64) << span
        rand = torch.from_numpy(np.random.default_rng(7).integers(
            0, 1 << 32, 1 << 16, dtype=np.int64))
        for peek in (prefix, prefix | ((1 << span) - 1), rand):
            want_sym, want_len = thf.peek_decode(peek, table.cb, table.thresh,
                                                 table.lmask)
            got_sym, got_len = _lut_plus_compare(table, peek)
            assert torch.equal(got_sym, want_sym)
            assert torch.equal(got_len, want_len)
        resolved = table.lut != 0
        assert bool(((table.lut & 63)[resolved] <= thf.LUT_BITS).all())
        if int(table.cb.max_len) > thf.LUT_BITS:
            assert not bool(resolved.all())


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version, exactly
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("shape,block", BLOCK_CASES + [
        ((8, 16, 128), (8, 16, 128)), ((5, 300), (64, 128)),
        # the warp-per-block kernels (both directions): block counts that
        # do not fill the last CTA of eight, and a single block
        ((256 * 21 + 3,), (256,)), ((256,), (256,)),
        ((16 * 9 + 1, 16 * 5), (16, 16)), ((16, 16), (16, 16)),
        ((8 * 5, 8 * 3 + 2, 8 * 7), (8, 8, 8)), ((8, 8, 8), (8, 8, 8)),
        # four non-unit block axes (the generic kernel)
        ((3, 5, 9, 17), (2, 4, 4, 8))])
    def test_lorenzo(self, cuda_dev, shape, block):
        x = torch.from_numpy(_field(shape, 3, 10.0)).to(cuda_dev)
        xb = tdq.block_split(tdq.pad_to_blocks(x, block), block)
        if block in DEFAULT_BLOCKS:     # reaches the warp-per-block kernels
            assert xb.data_ptr() % 16 == 0
        kc, kd = t_lorenzo.dualquant_blocks(xb, 1e-3, NBINS, impl="cuda")
        pc, pd = t_lorenzo.dualquant_blocks(xb, 1e-3, NBINS, impl="torch")
        assert torch.equal(kc, pc) and torch.equal(kd, pd)
        kr = t_lorenzo.reverse_blocks(kd, 1e-3, impl="cuda")
        pr = t_lorenzo.reverse_blocks(kd, 1e-3, impl="torch")
        assert torch.equal(kr.view(torch.int32), pr.view(torch.int32))

    @pytest.mark.parametrize("direction", ["dualquant", "reverse"])
    @pytest.mark.parametrize("block", DEFAULT_BLOCKS)
    def test_reverse_unaligned_view(self, cuda_dev, block, direction):
        """A contiguous view that starts 4 B into its storage cannot take
        16 B loads: the reverse takes the generic kernel, dual-quant the
        scalar loads of its warp-per-block kernels, and both give the
        same bits."""
        size = int(np.prod(block))
        shape = (11,) + (1,) * (len(block) - 1) + block
        rng = np.random.default_rng(4)
        if direction == "reverse":
            flat = torch.from_numpy(rng.integers(
                -500, 500, 1 + 11 * size).astype(np.int32)).to(cuda_dev)
            delta = flat[1:].view(shape)
            assert delta.data_ptr() % 16 != 0
            kr = t_lorenzo.reverse_blocks(delta, 1e-3, impl="cuda")
            pr = t_lorenzo.reverse_blocks(delta, 1e-3, impl="torch")
            assert torch.equal(kr.view(torch.int32), pr.view(torch.int32))
        else:
            flat = torch.from_numpy(_field((1 + 11 * size,), 4, 10.0)
                                    ).to(cuda_dev)
            xb = flat[1:].view(shape)
            assert xb.data_ptr() % 16 != 0
            kc, kd = t_lorenzo.dualquant_blocks(xb, 1e-3, NBINS, impl="cuda")
            pc, pd = t_lorenzo.dualquant_blocks(xb, 1e-3, NBINS,
                                                impl="torch")
            assert torch.equal(kc, pc) and torch.equal(kd, pd)

    @pytest.mark.parametrize("shape,block,layout", [
        (s, b, "contiguous") for s, b in FIELD_CASES] + FIELD_VIEWS)
    def test_dualquant_field(self, cuda_dev, shape, block, layout):
        """The field entry reads the field in place, ragged edges and
        views included, with no host copy, and gives the bits of the
        plain pad + block split + dual-quant."""
        xt, _ = _field_view(shape, layout, device=cuda_dev)
        copies = t_lorenzo.DUALQUANT.host_copies
        kc, kd = t_lorenzo.dualquant_field(xt, block, 1e-3, NBINS,
                                           impl="cuda")
        assert t_lorenzo.DUALQUANT.host_copies == copies
        xb = tdq.block_split(tdq.pad_to_blocks(xt, block), block)
        pc, pd = t_lorenzo.ref.dualquant_blocks_ref(xb, 1e-3, NBINS)
        assert torch.equal(kc, pc) and torch.equal(kd, pd)

    @pytest.mark.parametrize("shape,block,step", [
        ((256 * 8,), (256,), 2), ((48, 32), (16, 16), 1),
        ((48, 32), (16, 16), 2), ((16, 24, 32), (8, 8, 8), 1),
        ((16, 24, 32), (8, 8, 8), 2), ((16, 32, 256), (8, 16, 128), 1)])
    def test_dualquant_blocks_strided_view(self, cuda_dev, shape, block,
                                           step):
        """The blocked entry reads a blocked view in its own strides: the
        field's permuted view [nb..., b...] (no copy), of every `step`-th
        value along the last axis, gives the bits of its contiguous
        copy."""
        wide = shape[:-1] + (shape[-1] * step,)
        x = torch.from_numpy(_field(wide, 9, 10.0)).to(cuda_dev)
        split = []
        for d, b in zip(shape, block):
            split += [d // b, b]
        nd = len(shape)
        view = x[..., ::step].reshape(split).permute(
            list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
        assert not view.is_contiguous()
        kc, kd = t_lorenzo.dualquant_blocks(view, 1e-3, NBINS, impl="cuda")
        pc, pd = t_lorenzo.dualquant_blocks(view.contiguous(), 1e-3, NBINS,
                                            impl="torch")
        assert torch.equal(kc, pc) and torch.equal(kd, pd)

    @pytest.mark.parametrize("shape,block", [
        ((256 * 21 + 3,), None), ((40, 3600), None), ((9, 17, 20), None),
        ((2, 17, 17, 9), None), ((9000,), (4096,)), ((70, 130), (64, 128)),
        ((9, 20, 130), (8, 16, 128))])
    def test_predict_makes_no_host_copy(self, cuda_dev, monkeypatch, shape,
                                        block):
        """On the card `LorenzoPredictor.predict` calls neither
        `pad_to_blocks` nor `block_split`, for the default and the TPU
        blocks, and gives the plain path's codes and outlier store."""
        from repro_torch.core import compressor as tcz
        from repro_torch.core import stages as tst
        from repro_torch.kernels import dispatch as tdisp

        cfg = tcz.CompressorConfig(eb=1e-3, eb_mode="abs", block=block,
                                   outlier_frac=0.01)
        x = torch.from_numpy(_field(shape, 8, 10.0)).to(cuda_dev)
        pred = tst.get_predictor("lorenzo")
        want = pred.predict(x, cfg, 1e-3,
                            tdisp.pipeline_policy(x.device, "torch"))

        def refuse(*args, **kwargs):
            raise AssertionError("predict copied the field on the host")

        monkeypatch.setattr(tdq, "pad_to_blocks", refuse)
        monkeypatch.setattr(tdq, "block_split", refuse)
        copies = t_lorenzo.DUALQUANT.host_copies
        got = pred.predict(x, cfg, 1e-3,
                           tdisp.pipeline_policy(x.device, "cuda"))
        assert t_lorenzo.DUALQUANT.host_copies == copies
        assert torch.equal(got[0], want[0])
        for key in ("out_idx", "out_val", "n_outliers"):
            assert torch.equal(got[1][key], want[1][key]), key

    @pytest.mark.parametrize("n,nbins", [(1, 1024), (777, 256),
                                         (300_001, 1024)])
    def test_histogram(self, cuda_dev, n, nbins):
        codes = _skewed_codes(n, nbins, seed=n, spread=0.3)
        codes[::11] = nbins
        c = torch.from_numpy(codes).to(cuda_dev)
        assert torch.equal(t_hist.histogram(c, nbins, impl="cuda"),
                           t_hist.histogram(c, nbins, impl="torch"))

    @pytest.mark.parametrize("n,chunk,sub", DEFLATE_CASES)
    def test_encode_deflate_inflate(self, cuda_dev, n, chunk, sub):
        codes = _skewed_codes(n, NBINS, seed=n + 5)
        freq = np.bincount(codes, minlength=NBINS).astype(np.int32)
        cb = thf.canonical_codebook(
            thf.codeword_lengths(torch.from_numpy(freq))).to(cuda_dev)
        c = torch.from_numpy(codes).to(cuda_dev)
        c[::97] = NBINS                            # out of range: (0, 0)
        kcw, kbw = t_encode.encode(c, cb, impl="cuda")
        pcw, pbw = t_encode.encode(c, cb, impl="torch")
        assert torch.equal(kcw.view(torch.int32), pcw.view(torch.int32))
        assert torch.equal(kbw, pbw)
        kout = t_deflate.deflate(kcw, kbw, chunk, sub, impl="cuda")
        pout = t_deflate.deflate(kcw, kbw, chunk, sub, impl="torch")
        for k, p in zip(kout, pout):
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
        words, _, gbits, _ = kout
        nc = words.shape[0]
        nv = (n - torch.arange(nc, device=cuda_dev) * chunk).clamp(
            0, chunk).to(torch.int32)
        table = thf.decode_table(cb.lengths)
        kdec = t_inflate.inflate(words, nv, table, gaps=gbits, impl="cuda")
        pdec = t_inflate.inflate(words, nv, table, gaps=gbits, impl="torch")
        assert torch.equal(kdec, pdec)

    @pytest.mark.parametrize("n_sym", [8, 12, 16, 22, 33])
    @pytest.mark.parametrize("cut_last", [False, True])
    def test_inflate_every_bucket(self, cuda_dev, n_sym, cut_last):
        """Fibonacci codebooks up to max_len 32 (n_sym 33), against the
        plain version; `cut_last` ends the last chunk's n_valid short of
        its symbols, so its later cursors decode nothing."""
        codes_np = _fib_codes(n_sym, seed=1)
        codes = torch.from_numpy(codes_np).to(cuda_dev)
        freq = np.bincount(codes_np, minlength=NBINS)
        cb = thf.canonical_codebook(thf.codeword_lengths(
            torch.from_numpy(freq.astype(np.int32)))).to(cuda_dev)
        assert int(cb.max_len) == n_sym - 1
        cw, bw = t_encode.encode(codes, cb, impl="cuda")
        words, _, gbits, _ = t_deflate.deflate(cw, bw, 4096, 128, impl="cuda")
        nc = words.shape[0]
        nv = (codes.numel() - torch.arange(nc, device=cuda_dev) * 4096
              ).clamp(0, 4096).to(torch.int32)
        if cut_last:
            nv[-1] = int(nv[-1]) // 2 + 1
        table = thf.decode_table(cb.lengths)
        dec = t_inflate.inflate(words, nv, table, gaps=gbits, impl="cuda")
        plain = t_inflate.inflate(words, nv, table, gaps=gbits, impl="torch")
        assert torch.equal(dec, plain)
        n = int(nv.sum())
        assert torch.equal(dec.reshape(-1)[:n], codes[:n])
        assert not bool(dec.reshape(-1)[n:].any())
