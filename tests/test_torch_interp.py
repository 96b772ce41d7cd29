"""Port parity for cusz-i: the interpolation kernels, the interp
predictor and `repro_torch.codecs.get("cusz-i")` against the reference
package on the same numpy inputs, with tolerance 0.

  * kernel level: the plain versions of `interp.predict` /
    `interp.reconstruct` against the reference's `ref.py` on odd row
    shapes (one long row, one odd column, me = mo + 1), one case against
    the reference's Pallas kernel in interpret mode;
  * the level plan, PREQUANT (the reference's compiled form), dequant and
    POSTQUANT; the decode's deltas without a host read against the two
    steps they replace;
  * codec level on the six small scidata fields: packed containers
    byte-identical (header included), decodes bit-identical, ratios equal
    BENCH_quality.json's cusz-i rows, containers cross-decode both ways.

The `cuda` tests hold each kernel against its plain version on a card,
and hold the predictor's side of a decode to no synchronizing call.
"""
from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch.core import compressor as TCZ
from repro_torch.core import dualquant as tdq
from repro_torch.core import interp as tinterp
from repro_torch.core import metrics as TM
from repro_torch.data import scidata as tsci
from repro_torch.kernels import dispatch
from repro_torch.kernels.interp import ops as t_interp

FIELDS = ("hacc", "cesm", "hurricane", "hurricane_cloud", "nyx", "qmcpack")
# BENCH_quality.json's cusz-i rows
BENCH_RATIOS = {"hacc": 10.48, "cesm": 8.801, "hurricane": 5.038,
                "hurricane_cloud": 11.577, "nyx": 14.926, "qmcpack": 1.188}
QUALITY_KW = dict(eb=1e-4, eb_mode="valrel", outlier_frac=1.0)


@pytest.fixture(scope="module")
def ref():
    """The reference modules, imported on first use.  `import repro.core`
    fails the first time in a fresh process, because `repro.dist` imports
    a `chaos` module that the checkout lacks; the second attempt
    succeeds.  Hence one retry."""
    try:
        importlib.import_module("repro.core")
    except ImportError:
        importlib.import_module("repro.core")
    names = {"jax": "jax", "jnp": "jax.numpy", "codecs": "repro.codecs",
             "CZ": "repro.core.compressor", "dq": "repro.core.dualquant",
             "interp": "repro.core.interp", "sci": "repro.data.scidata",
             "ops": "repro.kernels.interp.ops"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        _eq(a[k], b[k], k)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _rows(rows, me, mo, seed):
    rng = np.random.default_rng(seed)
    pe = rng.integers(-(2 ** 22), 2 ** 22, (rows, me + 3)).astype(np.int32)
    odd = rng.integers(-(2 ** 22), 2 ** 22, (rows, mo)).astype(np.int32)
    return pe, odd


# (R, me, mo): one long row, a single odd column, me = mo + 1, square
ROW_CASES = [(1, 5001, 5000), (40, 1, 1), (9, 13, 12), (16, 64, 64),
             (3, 2, 1)]


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------

class TestInterpRows:
    @pytest.mark.parametrize("rows,me,mo", ROW_CASES)
    def test_residual_and_odd_match_reference(self, ref, rows, me, mo):
        pe, odd = _rows(rows, me, mo, seed=rows + me)
        want = ref.ops.residual_rows(ref.jnp.asarray(pe),
                                     ref.jnp.asarray(odd), impl="jax")
        got = t_interp.residual_rows(torch.from_numpy(pe),
                                     torch.from_numpy(odd))
        _eq(got.numpy(), want, "residual")
        back = ref.ops.odd_rows(ref.jnp.asarray(pe), want, impl="jax")
        tback = t_interp.odd_rows(torch.from_numpy(pe), got)
        _eq(tback.numpy(), back, "odd")
        _eq(tback.numpy(), odd, "exact inverse")

    def test_pallas_interpret(self, ref):
        pe, odd = _rows(11, 20, 19, seed=4)
        want = ref.ops.residual_rows(ref.jnp.asarray(pe),
                                     ref.jnp.asarray(odd),
                                     impl="pallas-interpret")
        got = t_interp.residual_rows(torch.from_numpy(pe),
                                     torch.from_numpy(odd))
        _eq(got.numpy(), want, "residual")
        back = ref.ops.odd_rows(ref.jnp.asarray(pe), want,
                                impl="pallas-interpret")
        _eq(t_interp.odd_rows(torch.from_numpy(pe), got).numpy(), back,
            "odd")

    def test_negative_predictions_floor(self):
        """`>>` is an arithmetic shift: (-1 >> 4) == -1, as in jnp."""
        pe = torch.full((1, 4), -1, dtype=torch.int32)
        odd = torch.zeros((1, 1), dtype=torch.int32)
        # p = (9 * -2 + 2 + 8) >> 4 = -8 >> 4 = -1
        assert int(t_interp.residual_rows(pe, odd)) == 1

    def test_cuda_on_cpu_tensor_raises(self):
        pe, odd = _rows(2, 4, 4, seed=0)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            t_interp.residual_rows(torch.from_numpy(pe),
                                   torch.from_numpy(odd), impl="cuda")


# ---------------------------------------------------------------------------
# Level plan and the unfused dual-quant steps
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1,), (3,), (5,), (1, 1, 1), (2, 1), (1000,), (37, 5),
               (9, 17, 20), (3, 9, 10, 11), (12, 24, 24, 24)]


class TestPlanAndQuant:
    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_plan_matches_reference(self, ref, shape):
        assert tinterp.interp_plan(shape) == ref.interp.interp_plan(shape)
        assert tinterp.ANCHOR == ref.interp.ANCHOR

    @pytest.mark.parametrize("shape,levels", [((280_953_867,), 27),
                                              ((1800, 3600), 19),
                                              ((512, 512, 512), 21)])
    def test_paper_field_level_counts(self, ref, shape, levels):
        assert len(tinterp.interp_plan(shape)[0]) == levels
        assert tinterp.interp_plan(shape) == ref.interp.interp_plan(shape)

    def test_prequant_is_the_compiled_reference(self, ref):
        """The reference's jitted PREQUANT multiplies by the f32
        reciprocal of 2 eb; the port does the same, ties included."""
        eb = 1e-4
        two = np.float32(2 * eb)
        k = np.arange(-3000, 3000, dtype=np.float32)
        ties = ((k + np.float32(0.5)) * two).astype(np.float32)
        field = tsci.all_fields(small=True)["cesm"].reshape(-1)
        jit_prequant = ref.jax.jit(ref.dq.prequant, static_argnums=1)
        for x in (ties, field):
            _eq(tdq.prequant(torch.from_numpy(x), eb).numpy(),
                jit_prequant(ref.jnp.asarray(x), eb), "prequant")

    def test_dequant_and_postquant_match_reference(self, ref):
        rng = np.random.default_rng(7)
        q = rng.integers(-(2 ** 22), 2 ** 22, 3000).astype(np.int32)
        _eq(tdq.dequant(torch.from_numpy(q), 3e-3).numpy(),
            ref.dq.dequant(ref.jnp.asarray(q), 3e-3), "dequant")
        delta = rng.integers(-700, 700, 3000).astype(np.int32)
        tc, tin = tdq.postquant_codes(torch.from_numpy(delta), 1024)
        jc, jin = ref.dq.postquant_codes(ref.jnp.asarray(delta), 1024)
        _eq(tc.numpy(), jc, "codes")
        _eq(tin.numpy(), jin, "in_cap")


#: (n, capacity, outliers, a fill that is not n): none, some, a full
#: capacity, a negative fill, a fill past int32's positives
OUTLIER_CASES = [(1, 1, 0, None), (3000, 64, 0, None), (3000, 64, 17, None),
                 (3000, 40, 40, None), (4096, 300, 9, -5),
                 (4096, 300, 299, 2 ** 31 - 1)]


@pytest.mark.parametrize("n,cap,k,odd_fill", OUTLIER_CASES)
def test_outlier_deltas_equal_scatter(n, cap, k, odd_fill):
    """The decode's deltas without a host read are the two steps' values,
    for codes of any integer dtype."""
    rng = np.random.default_rng(n + cap + k)
    codes = torch.from_numpy(rng.integers(0, 1024, n).astype(np.int32))
    idx = np.full(cap, n, np.int32)
    idx[:k] = rng.choice(n, size=k, replace=False)
    if odd_fill is not None:
        idx[-1] = odd_fill
    idx = torch.from_numpy(idx)
    val = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, cap)
                           .astype(np.int32))
    want = tdq.scatter_outliers(tdq.codes_to_delta(codes, 1024), idx, val)
    for dt in (torch.int32, torch.int64, torch.int16):
        got = tdq.outlier_deltas(codes.to(dt), 1024, idx, val)
        assert got.dtype == want.dtype
        _eq(got.numpy(), want.numpy(), str(dt))


# ---------------------------------------------------------------------------
# Codec level: the six scidata fields
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fields(ref):
    return ref.sci.all_fields(small=True)


@pytest.fixture(scope="module")
def reference_runs(ref, fields):
    out = {}
    for name, f in fields.items():
        codec = ref.codecs.get("cusz-i", **QUALITY_KW)
        c = codec.pack(codec.encode(ref.jnp.asarray(f)))
        hdr, arrays = ref.codecs.to_arrays(c)
        out[name] = (hdr, arrays, np.asarray(ref.codecs.decode(c)))
    return out


@pytest.fixture(scope="module")
def port_runs(fields):
    out = {}
    for name, f in fields.items():
        codec = tcodecs.get("cusz-i", **QUALITY_KW)
        c = codec.pack(codec.encode(f, device="cpu"))
        hdr, arrays = tcodecs.to_arrays(c)
        out[name] = (hdr, arrays, tcodecs.decode(c, device="cpu").numpy())
    return out


class TestCuszInterpFields:
    @pytest.mark.parametrize("name", FIELDS)
    def test_container_is_byte_identical(self, reference_runs, port_runs,
                                         name):
        rh, ra, _ = reference_runs[name]
        ph, pa, _ = port_runs[name]
        assert ph == rh
        _same_arrays(pa, ra)

    @pytest.mark.parametrize("name", FIELDS)
    def test_decode_matches_reference_bitwise(self, reference_runs,
                                              port_runs, name):
        np.testing.assert_array_equal(_bits(port_runs[name][2]),
                                      _bits(reference_runs[name][2]))

    @pytest.mark.parametrize("name", FIELDS)
    def test_ratio_and_bound_match_reference(self, fields, port_runs, name):
        f = fields[name]
        hdr, arrays, rec = port_runs[name]
        c = tcodecs.from_arrays(hdr, arrays)
        ratio = f.nbytes / tcodecs.get("cusz-i").stored_nbytes(c)
        assert round(ratio, 3) == BENCH_RATIOS[name]
        assert TM.verify_error_bound(f, rec, float(hdr["params"]["eb"]))

    @pytest.mark.parametrize("name", FIELDS)
    def test_containers_cross_decode(self, ref, reference_runs, port_runs,
                                     name):
        hdr, arrays, mine = port_runs[name]
        got = ref.codecs.decode(ref.codecs.from_arrays(hdr, arrays),
                                verify=True)
        np.testing.assert_array_equal(_bits(got), _bits(mine))
        rhdr, rarrays, want = reference_runs[name]
        got = tcodecs.decode(tcodecs.from_arrays(rhdr, rarrays), verify=True,
                             device="cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


class TestCuszInterpSurface:
    def test_header_matches_reference(self, ref, reference_runs):
        hdr = reference_runs["cesm"][0]
        assert hdr["codec"] == "cusz-i" and hdr["version"] == 1
        assert {k for k in hdr["params"] if k not in ("packed", "checksum")} \
            == {"block", "chunk_size", "eb", "nbins", "outlier_frac",
                "predictor", "sub_size"}
        assert hdr["params"]["predictor"] == "interp"
        f = ref.sci.all_fields(small=True)["cesm"]
        mine = tcodecs.get("cusz-i", **QUALITY_KW).encode(f, device="cpu")
        theirs = ref.codecs.get("cusz-i", **QUALITY_KW).encode(
            ref.jnp.asarray(f))
        assert mine.header.to_json() == theirs.header.to_json()

    def test_make_forces_the_interp_predictor(self):
        c = tcodecs.get("cusz-i", predictor="lorenzo")
        assert c.cfg.predictor == "interp"
        assert tcodecs.get("cusz-i").cfg.predictor == "interp"

    @pytest.mark.parametrize("shape", [(1,), (1, 1), (3,), (7, 1, 5),
                                       (33, 47)])
    def test_roundtrip_and_compressed_bytes_match_reference(self, ref,
                                                            shape):
        """Tiny and degenerate shapes (the one-symbol dummy stream), and
        the blob's byte accounting, which counts the anchor grid."""
        x = np.cumsum(np.random.default_rng(len(shape)).standard_normal(
            shape), 0).astype(np.float32)
        cfg = dict(eb=1e-3, chunk_size=512, sub_size=128, predictor="interp",
                   outlier_frac=1.0)
        recon, blob, eb, ratio = TCZ.roundtrip(torch.from_numpy(x),
                                               TCZ.CompressorConfig(**cfg))
        rrecon, rblob, reb, rratio = ref.CZ.roundtrip(
            ref.jnp.asarray(x), ref.CZ.CompressorConfig(**cfg))
        assert (eb, ratio) == (reb, rratio)
        assert blob.anchor is not None
        assert TCZ.compressed_bytes(blob, 1024) == ref.CZ.compressed_bytes(
            rblob, 1024)
        np.testing.assert_array_equal(_bits(recon.numpy()), _bits(rrecon))

    def test_outlier_overflow_is_invalid_like_reference(self, ref):
        x = (np.random.default_rng(0).standard_normal((64, 64)) * 100
             ).astype(np.float32)
        kw = dict(eb=1e-3, outlier_frac=0.001)
        pdev = tcodecs.get("cusz-i", **kw).encode(x, device="cpu")
        rdev = ref.codecs.get("cusz-i", **kw).encode(ref.jnp.asarray(x))
        assert not tcodecs.get("cusz-i", **kw).valid(pdev)
        assert not ref.codecs.get("cusz-i", **kw).valid(rdev)
        assert int(pdev.payload["n_outliers"]) == int(
            rdev.payload["n_outliers"])

    def test_plain_path_launches_no_kernel(self):
        dispatch.reset_launches()
        codec = tcodecs.get("cusz-i", eb=1e-2)
        tcodecs.decode(codec.encode(np.ones((20, 20), np.float32),
                                    device="cpu"))
        assert set(dispatch.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestInterpOnCard:
    @pytest.mark.parametrize("rows,me,mo", ROW_CASES + [(262_144, 256, 256),
                                                        (1, 3_000_001,
                                                         3_000_000)])
    def test_kernels_match_plain(self, cuda_dev, rows, me, mo):
        pe, odd = (torch.from_numpy(a).to(cuda_dev)
                   for a in _rows(rows, me, mo, seed=mo))
        k = t_interp.residual_rows(pe, odd, impl="cuda")
        assert torch.equal(k, t_interp.residual_rows(pe, odd, impl="torch"))
        back = t_interp.odd_rows(pe, k, impl="cuda")
        assert torch.equal(back, t_interp.odd_rows(pe, k, impl="torch"))
        assert torch.equal(back, odd)

    def test_reconstruct_reads_nothing_on_the_host(self, cuda_dev,
                                                   monkeypatch):
        """The predictor's side of a decode (deltas, outliers, the level
        loop, dequant) makes no synchronizing call, so the host runs
        ahead of the card through it; the decode is unchanged."""
        plain = tinterp.InterpPredictor.reconstruct

        def strict(self, *args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return plain(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        codec = tcodecs.get("cusz-i", eb=1e-4, eb_mode="valrel")
        f = tsci.all_fields(small=True)["nyx"]
        c = codec.encode(f, device=cuda_dev)
        want = tcodecs.decode(c, device=cuda_dev)
        monkeypatch.setattr(tinterp.InterpPredictor, "reconstruct", strict)
        got = tcodecs.decode(c, device=cuda_dev)
        assert int(c.payload["n_outliers"]) > 0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def test_codec_on_card_matches_cpu(self, cuda_dev):
        codec = tcodecs.get("cusz-i", **QUALITY_KW)
        for name, f in tsci.all_fields(small=True).items():
            dispatch.reset_launches()
            on_card = codec.pack(codec.encode(f, device=cuda_dev))
            levels = len(tinterp.interp_plan(f.shape)[0])
            assert dispatch.launch_counts()["interp.predict"] == levels
            on_cpu = codec.pack(codec.encode(f, device="cpu"))
            assert on_card.header == on_cpu.header, name
            _same_arrays(on_card.payload, on_cpu.payload)
            y = tcodecs.decode(on_card, device=cuda_dev)
            assert dispatch.launch_counts()["interp.reconstruct"] == levels
            np.testing.assert_array_equal(
                _bits(y.cpu().numpy()),
                _bits(tcodecs.decode(on_cpu, device="cpu").numpy()))
