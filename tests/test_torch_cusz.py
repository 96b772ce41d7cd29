"""Port parity for the whole cusz slice: `repro_torch.codecs.get("cusz")`
against the reference package on the same numpy inputs.

  * the committed golden fixture: header JSON and every packed array
    reproduced byte for byte;
  * the six small scidata fields: the numpy generator copy is
    byte-identical, containers are byte-identical, decode equals the
    reference's reconstruction bit for bit, ratios equal the reference's
    and BENCH_quality.json's cusz rows;
  * containers cross-decode in both directions;
  * the dispatch, container and compressor surfaces of the port.

Everything runs on the CPU through the plain PyTorch versions; the
`cuda` test at the end runs the codec through the kernels on a card.
"""
from __future__ import annotations

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch.core import compressor as TCZ
from repro_torch.core import metrics as TM
from repro_torch.data import scidata as tsci
from repro_torch.kernels import dispatch

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
FIELDS = ("hacc", "cesm", "hurricane", "hurricane_cloud", "nyx", "qmcpack")
BENCH_RATIOS = {"hacc": 9.709, "cesm": 4.844, "hurricane": 5.334,
                "hurricane_cloud": 11.692, "nyx": 14.447, "qmcpack": 4.122}
GOLDEN_KW = dict(eb=1e-3, eb_mode="abs", chunk_size=256, sub_size=64,
                 outlier_frac=1.0)


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
             "CZ": "repro.core.compressor", "M": "repro.core.metrics",
             "sci": "repro.data.scidata"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def fields(ref):
    return ref.sci.all_fields(small=True)


@pytest.fixture(scope="module")
def reference_runs(ref, fields):
    """Per field: the reference's packed container and reconstruction."""
    out = {}
    for name, f in fields.items():
        codec = ref.codecs.get("cusz", eb=1e-4, eb_mode="valrel")
        c = codec.pack(codec.encode(ref.jnp.asarray(f)))
        hdr, arrays = ref.codecs.to_arrays(c)
        out[name] = (hdr, arrays, np.asarray(ref.codecs.decode(c)))
    return out


@pytest.fixture(scope="module")
def port_runs(fields):
    out = {}
    for name, f in fields.items():
        codec = tcodecs.get("cusz", eb=1e-4, eb_mode="valrel")
        c = codec.pack(codec.encode(f, device="cpu"))
        hdr, arrays = tcodecs.to_arrays(c)
        out[name] = (hdr, arrays, tcodecs.decode(c, device="cpu").numpy())
    return out


def _same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# Golden fixture
# ---------------------------------------------------------------------------

def _golden():
    z = np.load(DATA / "cusz_v2_golden.npz")
    hdr = json.loads((DATA / "cusz_v2_golden_header.json").read_text())
    return z, hdr


class TestGolden:
    def test_reencode_is_byte_identical(self):
        z, hdr = _golden()
        codec = tcodecs.get("cusz", cfg=TCZ.CompressorConfig(**GOLDEN_KW))
        c = codec.pack(codec.encode(torch.from_numpy(z["field"])))
        assert c.header.to_json() == hdr
        _same_arrays(c.payload, {k: z[k] for k in z.files if k != "field"})

    def test_lorenzo_header_records_no_predictor(self):
        """The header is written as the reference writes it: `block` and
        `outlier_frac` always, `predictor` only when it is not lorenzo,
        so the golden header stays as it was."""
        z, hdr = _golden()
        c = tcodecs.get("cusz", cfg=TCZ.CompressorConfig(**GOLDEN_KW)
                        ).encode(torch.from_numpy(z["field"]))
        params = c.header.to_json()["params"]
        assert "predictor" not in params and "predictor" not in \
            hdr["params"]
        assert params == {k: v for k, v in hdr["params"].items()
                          if k not in ("packed", "checksum")}

    def test_stored_fixture_decodes_like_reference(self, ref):
        z, hdr = _golden()
        arrays = {k: z[k] for k in z.files if k != "field"}
        got = tcodecs.decode(tcodecs.from_arrays(hdr, arrays), device="cpu")
        want = ref.codecs.decode(ref.codecs.from_arrays(hdr, arrays))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert np.abs(got.numpy() - z["field"]).max() <= 1e-3 * 1.0001


# ---------------------------------------------------------------------------
# The six scidata fields
# ---------------------------------------------------------------------------

class TestScidataFields:
    @pytest.mark.parametrize("name", FIELDS)
    def test_generator_copy_is_byte_identical(self, fields, name):
        mine = tsci.all_fields(small=True)[name]
        assert mine.dtype == fields[name].dtype
        assert mine.tobytes() == fields[name].tobytes()

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
    def test_ratio_and_bound_match_reference(self, ref, fields, port_runs,
                                             name):
        f = fields[name]
        hdr, arrays, rec = port_runs[name]
        c = tcodecs.from_arrays(hdr, arrays)
        ratio = f.nbytes / tcodecs.get("cusz").stored_nbytes(c)
        assert round(ratio, 3) == BENCH_RATIOS[name]
        eb = float(hdr["params"]["eb"])
        assert TM.verify_error_bound(f, rec, eb)
        assert TM.verify_error_bound(f, rec, eb) == bool(
            ref.M.verify_error_bound(f, rec, eb))
        assert abs(TM.psnr(f, rec) - float(ref.M.psnr(f, rec))) < 1e-2

    @pytest.mark.parametrize("name", FIELDS)
    def test_reference_decodes_port_container(self, ref, reference_runs,
                                              port_runs, name):
        hdr, arrays, _ = port_runs[name]
        got = ref.codecs.decode(ref.codecs.from_arrays(hdr, arrays),
                                verify=True)
        np.testing.assert_array_equal(_bits(got), _bits(port_runs[name][2]))

    @pytest.mark.parametrize("name", FIELDS)
    def test_port_decodes_reference_container(self, reference_runs, name):
        hdr, arrays, want = reference_runs[name]
        got = tcodecs.decode(tcodecs.from_arrays(hdr, arrays), verify=True,
                             device="cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# Other configurations against the reference
# ---------------------------------------------------------------------------

CONFIGS = {
    "tpu_blocks_3d": ((20, 40, 130), dict(use_tpu_blocks=True)),
    "tpu_blocks_1d": ((10_000,), dict(use_tpu_blocks=True)),
    "small_chunks": ((60, 70), dict(chunk_size=512, sub_size=64)),
    "sub_equals_chunk": ((3000,), dict(chunk_size=256, sub_size=256)),
    "four_d": ((3, 9, 10, 11), {}),
    "nbins_256": ((40, 50), dict(nbins=256)),
    "outlier_heavy": ((30, 30), dict(eb=1e-5, outlier_frac=1.0)),
}


class TestConfigs:
    @pytest.mark.parametrize("case", sorted(CONFIGS))
    def test_container_and_decode_match_reference(self, ref, case):
        shape, kw = CONFIGS[case]
        rng = np.random.default_rng(len(shape))
        x = np.cumsum(rng.standard_normal(shape), -1).astype(np.float32)
        kw = {"eb": 1e-3, **kw}
        rc = ref.codecs.get("cusz", **kw)
        pc = tcodecs.get("cusz", **kw)
        rpacked = rc.pack(rc.encode(ref.jnp.asarray(x)))
        ppacked = pc.pack(pc.encode(x, device="cpu"))
        assert ppacked.header.to_json() == rpacked.header.to_json()
        _same_arrays(ppacked.payload, ref.codecs.to_arrays(rpacked)[1])
        np.testing.assert_array_equal(
            _bits(tcodecs.decode(ppacked, device="cpu").numpy()),
            _bits(ref.codecs.decode(rpacked)))

    def test_outlier_overflow_is_invalid_like_reference(self, ref):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((64, 64)) * 100).astype(np.float32)
        rc = ref.codecs.get("cusz", eb=1e-3, outlier_frac=0.001)
        pc = tcodecs.get("cusz", eb=1e-3, outlier_frac=0.001)
        rdev, pdev = rc.encode(ref.jnp.asarray(x)), pc.encode(x, device="cpu")
        assert not pc.valid(pdev) and not rc.valid(rdev)
        assert int(pdev.payload["n_outliers"]) == int(
            rdev.payload["n_outliers"])
        np.testing.assert_array_equal(pdev.payload["out_idx"].numpy(),
                                      np.asarray(rdev.payload["out_idx"]))

    def test_resolve_eb_matches_reference_and_guards(self, ref):
        x = np.linspace(-3.0, 5.0, 1000, dtype=np.float32)
        for kw in (dict(eb=1e-4, eb_mode="valrel"), dict(eb=2e-3)):
            assert TCZ.resolve_eb(TCZ.CompressorConfig(**kw),
                                  torch.from_numpy(x)) == \
                ref.CZ.resolve_eb(ref.CZ.CompressorConfig(**kw),
                                  ref.jnp.asarray(x))
        with pytest.raises(ValueError, match="below float32 resolution"):
            TCZ.resolve_eb(TCZ.CompressorConfig(eb=1e-9),
                           torch.from_numpy(x))

    def test_roundtrip_and_compressed_bytes_match_reference(self, ref):
        x = np.cumsum(np.random.default_rng(4).standard_normal((33, 47)),
                      0).astype(np.float32)
        cfg = dict(eb=1e-3, chunk_size=512, sub_size=128)
        recon, blob, eb, ratio = TCZ.roundtrip(torch.from_numpy(x),
                                               TCZ.CompressorConfig(**cfg))
        rrecon, rblob, reb, rratio = ref.CZ.roundtrip(
            ref.jnp.asarray(x), ref.CZ.CompressorConfig(**cfg))
        assert (eb, ratio) == (reb, rratio)
        assert TCZ.compressed_bytes(blob, 1024) == ref.CZ.compressed_bytes(
            rblob, 1024)
        np.testing.assert_array_equal(_bits(recon.numpy()), _bits(rrecon))


# ---------------------------------------------------------------------------
# Codec surface
# ---------------------------------------------------------------------------

class TestCodecSurface:
    def test_registry(self):
        assert tcodecs.names() == ["cusz", "cusz-i", "fz", "int16", "int8",
                                   "int8-block", "lossless", "zfp"]
        assert tcodecs.get("cusz") is tcodecs.get("cusz")
        with pytest.raises(KeyError, match="unknown codec"):
            tcodecs.get("sz3")

    def test_devices_follow_the_input(self):
        x = np.random.default_rng(1).standard_normal((40, 40)).astype(
            np.float32)
        codec = tcodecs.get("cusz", eb=1e-2)
        c = codec.encode(torch.from_numpy(x))            # CPU tensor
        assert c.payload["words"].device.type == "cpu"
        assert codec.encode(x, device="cpu").payload["words"].device.type \
            == "cpu"
        y = tcodecs.decode(c)                             # device form: CPU
        assert y.device.type == "cpu" and y.shape == (40, 40)

    def test_dtype_and_like_ride_the_header(self):
        x = torch.linspace(0, 1, 300).reshape(10, 30).to(torch.bfloat16)
        codec = tcodecs.get("cusz", eb=1e-3)
        c = codec.encode(x)
        assert c.header.dtype == "bfloat16"
        y = tcodecs.decode(codec.pack(c), device="cpu")
        assert y.dtype == torch.bfloat16 and y.shape == (10, 30)
        like = torch.empty((30, 10), dtype=torch.float32)
        z = tcodecs.decode(c, like=like)
        assert z.dtype == torch.float32 and z.shape == (30, 10)

    def test_checksum_detects_corruption(self):
        x = np.random.default_rng(2).standard_normal((50, 20)).astype(
            np.float32)
        codec = tcodecs.get("cusz", eb=1e-3)
        c = codec.pack(codec.encode(x, device="cpu"))
        assert tcodecs.verify_container(c)
        bad = dict(c.payload)
        words = bad["words_packed"].copy()
        words[3] ^= 1
        bad["words_packed"] = words
        corrupt = tcodecs.Container(c.header, bad)
        assert not tcodecs.verify_container(corrupt)
        with pytest.raises(tcodecs.ChecksumError):
            tcodecs.decode(corrupt, verify=True, device="cpu")

    def test_header_json_roundtrip_and_version_gate(self):
        z, hdr = _golden()
        h = tcodecs.Header.from_json(hdr)
        assert h.to_json() == hdr
        newer = dict(hdr, version=3)
        c = tcodecs.from_arrays(newer, {k: z[k] for k in z.files})
        with pytest.raises(ValueError, match="installed codec is v2"):
            tcodecs.decode(c, device="cpu")
        with pytest.raises(ValueError, match="newer than this reader"):
            tcodecs.Header.from_json(dict(hdr, format=2))


class TestStagesAndMetrics:
    def test_stage_registry_contract(self):
        from repro_torch.core import stages
        assert stages.predictor_names() == ("interp", "lorenzo")
        assert stages.encoder_names() == ("bitshuffle", "huffman")
        pred, enc = stages.get_predictor("lorenzo"), stages.get_encoder(
            "huffman")
        assert pred is stages.get_predictor("lorenzo")
        assert not set(pred.payload_keys) & set(enc.payload_keys)
        kernels = set()
        for p in stages.predictor_names():
            kernels |= set(stages.get_predictor(p).kernels)
        for e in stages.encoder_names():
            kernels |= set(stages.get_encoder(e).kernels)
        assert kernels == set(dispatch.PIPELINE_STAGES)
        with pytest.raises(KeyError, match="unknown predictor"):
            stages.get_predictor("spline")
        with pytest.raises(KeyError, match="unknown encoder"):
            stages.get_encoder("ans")

    def test_metrics_match_reference(self, ref):
        rng = np.random.default_rng(8)
        a = rng.standard_normal(5000).astype(np.float32)
        b = a + rng.uniform(-1e-3, 1e-3, 5000).astype(np.float32)
        for name in ("rmse", "psnr", "nrmse", "max_abs_err"):
            got = getattr(TM, name)(a, b)
            want = float(getattr(ref.M, name)(a, b))
            assert got == pytest.approx(want, rel=1e-5), name
        assert TM.bitrate(1000, 250) == ref.M.bitrate(1000, 250) == 2.0


class TestDispatch:
    def test_auto_follows_the_device(self):
        cpu = torch.device("cpu")
        assert dispatch.resolve("histogram", cpu) == "torch"
        assert dispatch.resolve("histogram", torch.device("cuda")) == "cuda"

    def test_explicit_cuda_on_cpu_raises(self):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve("encode", torch.device("cpu"), "cuda")
        cfg = TCZ.CompressorConfig(eb=1e-2, kernel_impl="cuda")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            TCZ.compress(torch.zeros(300), cfg)

    def test_policy_context_env_and_overrides(self, monkeypatch):
        # the context sets every stage; a per-call impl beats it; the
        # context beats the configured default
        cuda = torch.device("cuda")
        with dispatch.kernel_policy("torch"):
            assert dispatch.current_policy() == "torch"
            assert dispatch.resolve("histogram", cuda) == "torch"
            assert dispatch.resolve("inflate", cuda, "cuda") == "cuda"
            pp = dispatch.pipeline_policy(cuda, "cuda")
            assert {pp.for_kernel(k) for k in dispatch.PIPELINE_STAGES} \
                == {"torch"}
        assert dispatch.current_policy() is None
        pp = dispatch.pipeline_policy(cuda, "torch")
        assert pp.for_kernel("encode") == "torch"
        # no environment variable moves the path, and the policy carries
        # one impl with no per-kernel overrides
        monkeypatch.setenv("REPRO_TORCH_KERNEL_IMPL", "torch")
        assert dispatch.resolve("inflate", cuda) == "cuda"
        assert dispatch.pipeline_policy(cuda).for_kernel("encode") == "cuda"
        with pytest.raises(TypeError):
            with dispatch.kernel_policy("torch", {"lorenzo": "cuda"}):
                pass

    def test_unknown_names_raise(self):
        with pytest.raises(ValueError, match="unknown kernel impl"):
            with dispatch.kernel_policy("pallas"):
                pass
        with pytest.raises(ValueError, match="unknown kernel impl"):
            dispatch.pipeline_policy(torch.device("cpu"), "jax")
        with pytest.raises(KeyError, match="not registered"):
            dispatch.resolve("zfp.encode", torch.device("cpu"))
        assert sorted(dispatch.registered()) == sorted(
            dispatch.PIPELINE_STAGES)

    def test_plain_path_launches_no_kernel(self):
        dispatch.reset_launches()
        codec = tcodecs.get("cusz", eb=1e-2)
        tcodecs.decode(codec.encode(np.ones((20, 20), np.float32),
                                    device="cpu"))
        assert set(dispatch.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# Package boundaries and the card smoke script
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in files}
    assert {"codecs/int8.py", "codecs/lossless.py", "codecs/zfp.py",
            "core/zfp_like.py", "core/kvcache.py", "dist/sharding.py",
            "io/async_writer.py", "io/checkpoint.py"} <= names
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, m)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        run = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(cuda_dev):
    for name, f in tsci.all_fields(small=True).items():
        codec = tcodecs.get("cusz", eb=1e-4, eb_mode="valrel")
        dispatch.reset_launches()
        on_card = codec.pack(codec.encode(f, device=cuda_dev))
        counts = dispatch.launch_counts()
        assert all(counts[k] >= 1 for k in ("lorenzo.dualquant", "histogram",
                                             "encode", "deflate")), counts
        on_cpu = codec.pack(codec.encode(f, device="cpu"))
        assert on_card.header == on_cpu.header, name
        _same_arrays(on_card.payload, on_cpu.payload)
        y = tcodecs.decode(on_card, device=cuda_dev)
        np.testing.assert_array_equal(
            _bits(y.cpu().numpy()),
            _bits(tcodecs.decode(on_cpu, device="cpu").numpy()))
