"""The port's runtime sanitizers (`repro_torch.debug`), the counterpart of
tests/test_guards.py, at ``configs.reduced("qwen3-4b", n_periods=1)`` on
the CPU.

The contract: the serve step and the scheduler's batch step are built
once across requests; the steady-state decode loop (the engine's and the
scheduler's) makes no tensor from host data; the cusz checkpoint save and
the codec roundtrips read the device only at statically waived sites
(``# repro-lint: allow[host-sync]``), and the waived reads do happen.
Every guarded run gives the tokens, containers and checkpoint bytes of
the same run without guards.  The allowlist is built here from the port's
waivers (``tools.lint.waived_spans``, pure AST); the port never imports
``tools``.  One `cuda` test holds the card's sync-debug path.
"""
from __future__ import annotations

import ast
import glob
import os

import numpy as np
import pytest
import torch

from repro_torch import codecs, configs
from repro_torch.core import compressor as CZ
from repro_torch.core import dualquant
from repro_torch.debug import (HostSyncError, RecompileError, TransferError,
                               host_sync_guard, no_implicit_transfers,
                               no_recompiles, note_build)
from repro_torch.io import checkpoint as CK
from repro_torch.models import model as M
from repro_torch.serve import engine as E
from repro_torch.serve import scheduler as S

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC_PORT = os.path.join(REPO, "src", "repro_torch")
SRC_REF = os.path.join(REPO, "src", "repro")


@pytest.fixture(scope="module")
def waived():
    """{abs path: [(start, end, reason)]} of the port's host-sync
    waivers: the guards' allowlist."""
    from tools.lint import waived_spans

    return waived_spans(SRC_PORT)


@pytest.fixture
def sync_guard(waived):
    """``with sync_guard() as log:`` fails on any port-code read outside
    the waived sites."""
    def make(**kwargs):
        return host_sync_guard(waived, **kwargs)
    return make


@pytest.fixture(scope="module")
def model():
    cfg = configs.reduced("qwen3-4b", n_periods=1)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return cfg, params


def _scfg(s_max: int) -> E.ServeConfig:
    # a distinct s_max per test: a fresh step-cache key
    return E.ServeConfig(s_max=s_max, compressed_kv=True,
                         compute_dtype=torch.float32)


def _requests(n: int, seed: int, max_new: int = 6):
    rng = np.random.default_rng(seed)
    return [S.Request(rid=i, prompt=rng.integers(
        1, 200, size=int(rng.integers(5, 40))).astype(np.int32),
        max_new=max_new, arrival=int(rng.integers(0, 3)))
        for i in range(n)]


_REAL = (torch.from_numpy, torch.cuda.synchronize)


def _guards_unwound():
    return (not torch.overrides._get_current_function_mode_stack()
            and (torch.from_numpy, torch.cuda.synchronize) == _REAL)


# ---------------------------------------------------------------------------
# guard mechanics
# ---------------------------------------------------------------------------

def test_no_recompiles_counts_and_raises():
    with no_recompiles(max_compiles=1, match=r"^f2$") as log:
        note_build("f2")
        note_build("other")
    assert log.compiles == ["f2"]
    with pytest.raises(RecompileError, match="no_recompiles"):
        with no_recompiles(max_compiles=0, match=r"^f3$"):
            note_build("f3")
    note_build("f2")                        # no scope open: nothing counts
    assert log.compiles == ["f2"]


def test_host_sync_guard_attributes_library_syncs():
    x = torch.linspace(0.0, 1.0, 4096).reshape(64, 64)
    blob, _eb = CZ.compress(x, CZ.CompressorConfig())
    with pytest.raises(HostSyncError, match="compressor.py"):
        with host_sync_guard({}):           # empty allowlist: all trip
            CZ.compressed_bytes(blob, CZ.CompressorConfig().nbins)
    assert _guards_unwound()


def test_host_sync_guard_ignores_test_code_syncs():
    with host_sync_guard({}) as log:
        torch.ones(4).sum().item()          # issued by the harness: fine
        bool(torch.ones(()) > 0)
    assert log.violations == [] and log.allowed_hits == []


def test_guards_restore_on_error():
    with pytest.raises(ZeroDivisionError):
        with no_implicit_transfers("log"), host_sync_guard({}):
            1 / 0
    assert _guards_unwound()


def test_no_implicit_transfers_flags_library_host_data():
    from repro_torch.codecs.base import as_tensor

    with no_implicit_transfers("log") as log:
        torch.tensor([1, 2])                # harness: not flagged
        torch.from_numpy(np.ones(3))
        as_tensor(np.ones(3), device="cpu")     # library: flagged
    assert len(log.transfers) == 1 and "base.py" in log.transfers[0]
    with pytest.raises(TransferError, match="base.py"):
        with no_implicit_transfers("disallow"):
            as_tensor([1.0, 2.0], device="cpu")
    with pytest.raises(ValueError, match="level"):
        with no_implicit_transfers("log_explicit"):
            pass
    assert _guards_unwound()


# ---------------------------------------------------------------------------
# serve: each step built once; the steady-state decode loop transfer-free
# ---------------------------------------------------------------------------

def test_serve_step_built_exactly_once(model):
    cfg, params = model
    prompt = torch.zeros((2, 8), dtype=torch.int32)
    scfg = _scfg(256)
    E.STEP_TRACES.pop((cfg, scfg), None)
    E.get_serve_step.cache_clear()
    with no_recompiles(max_compiles=1, match=r"^step$") as log:
        a = E.generate(params, cfg, prompt, 4, scfg)
        b = E.generate(params, cfg, prompt, 4, scfg)
    assert log.compiles == ["step"]         # built once, reused once
    assert E.STEP_TRACES[(cfg, scfg)] == 1
    assert torch.equal(a, b)


def test_decode_steady_state_builds_nothing(model):
    cfg, params = model
    prompt = torch.zeros((2, 8), dtype=torch.int32)
    scfg = _scfg(512)
    E.generate(params, cfg, prompt, 4, scfg)            # warm-up
    with no_recompiles(max_compiles=0):
        E.generate(params, cfg, prompt, 6, scfg)        # longer decode
    assert E.STEP_TRACES[(cfg, scfg)] == 1


def test_batch_step_built_once_across_runs(model):
    cfg, params = model
    scfg = _scfg(384)
    key = (cfg, scfg, 2)
    S.BATCH_STEP_TRACES.pop(key, None)
    S.get_batch_step.cache_clear()
    reqs = _requests(5, 0)
    sc = S.SchedulerConfig(max_batch=2, pool_pages=12)
    with no_recompiles(max_compiles=1, match=r"^batch_step$") as log:
        fin, _ = S.run_continuous(params, cfg, scfg, sc, reqs)
    assert log.compiles == ["batch_step"]
    assert len(fin) == 5
    with no_recompiles(max_compiles=0):
        again, _ = S.run_continuous(params, cfg, scfg, sc, reqs)
    assert S.BATCH_STEP_TRACES[key] == 1
    assert {r: f["tokens"] for r, f in again.items()} == \
        {r: f["tokens"] for r, f in fin.items()}


def test_decode_loop_makes_no_tensor_from_host_data(model, sync_guard):
    """The steady-state decode loop keeps its position on the device: no
    host scalar becomes a tensor per step, and it reads nothing back."""
    cfg, params = model
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    scfg = _scfg(256)
    last, caches, plen = E.prefill(params, cfg, prompt, scfg)
    want = E.decode_tokens(params, cfg, scfg, last, caches, plen, 6)
    with no_implicit_transfers("disallow") as moves, \
            sync_guard() as log:
        got = E.decode_tokens(params, cfg, scfg, last, caches, plen, 6)
    assert moves.transfers == []
    assert log.violations == [] and log.allowed_hits == []
    assert torch.equal(got, want)


def test_scheduler_steady_state_reads_only_its_tokens(model, sync_guard):
    """The scheduler's decode steps keep cache_len on the device; the one
    read per step is the waived token readback."""
    cfg, params = model
    scfg = _scfg(256)
    reqs = _requests(3, 1, max_new=12)

    def start():
        sched = S.ContinuousScheduler(params, cfg, scfg, S.SchedulerConfig(
            max_batch=2, pool_pages=8))
        for r in reqs:
            sched.submit(r)
        sched._admit(10)
        sched._step()
        return sched

    plain = start()
    for _ in range(4):
        plain._step()
    sched = start()
    with no_implicit_transfers("disallow") as moves, sync_guard() as log:
        for _ in range(4):
            sched._step()
    assert moves.transfers == []
    assert log.violations == []
    sites = {h.split(" ")[0] for h in log.allowed_hits}
    assert len(sites) == 1 and "scheduler.py" in sites.pop()
    assert [s["generated"] for s in sched.slots] == \
        [s["generated"] for s in plain.slots]
    assert sched.lens_dev.tolist() == sched.lens.tolist()


# ---------------------------------------------------------------------------
# checkpoint encode and codec roundtrips under the host-sync guard
# ---------------------------------------------------------------------------

def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((64, 64))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((64,))
                                  .astype(np.float32)),
            "step": torch.tensor(3, dtype=torch.int32)}


def _saved(d: str):
    """{file: {array name: array}} of a saved step (npz members) and the
    manifest text."""
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "**", "*"), recursive=True)):
        if f.endswith(".npz"):
            with np.load(f) as z:
                out[os.path.relpath(f, d)] = {k: z[k] for k in z.files}
        elif os.path.isfile(f):
            with open(f, "rb") as fh:
                out[os.path.relpath(f, d)] = fh.read()
    return out


def test_checkpoint_encode_zero_unwaived_syncs(tmp_path, sync_guard):
    tree = _tree(0)
    policy = CK.CheckpointPolicy(codec="cusz")
    CK.save_checkpoint(str(tmp_path / "plain"), 0, tree, policy=policy)
    with sync_guard() as log:
        CK.save_checkpoint(str(tmp_path / "guarded"), 0, tree,
                           policy=policy)
    assert log.violations == []
    # the boundary crossings that did happen are the waived ones
    assert log.allowed_hits
    a, b = _saved(str(tmp_path / "plain")), _saved(str(tmp_path / "guarded"))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys()
            for n in a[k]:
                np.testing.assert_array_equal(a[k][n], b[k][n])
        else:
            assert a[k] == b[k], k


def test_cusz_valid_sync_is_waived(sync_guard):
    x = torch.linspace(-2.0, 2.0, 4096).reshape(32, 128)
    codec = codecs.get("cusz")
    c = codec.encode(x)
    with sync_guard() as log:
        assert codec.valid(c)
    assert log.violations == []
    assert [h.split(" ")[0].split(os.sep)[-1] for h in log.allowed_hits] \
        and all("stages.py" in h for h in log.allowed_hits)
    p = codec.pack(c)                   # packed: post-validation, no read
    with sync_guard() as log2:
        assert codec.valid(p)
    assert log2.violations == [] and log2.allowed_hits == []


@pytest.mark.parametrize("name", ["int8-block", "cusz", "lossless"])
def test_codec_roundtrip_sync_clean(name, sync_guard):
    x = torch.linspace(-1.0, 1.0, 8192).reshape(64, 128)
    codec = codecs.get(name)
    want_c = codec.encode(x)
    want = codec.decode(want_c, like=x)
    with sync_guard() as log:
        c = codec.encode(x)
        y = codec.decode(c, like=x)
    assert log.violations == [], name
    assert torch.equal(y, want)
    for k, v in c.payload.items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(
            want_c.payload[k])), k


# ---------------------------------------------------------------------------
# the waivers: every reference site has a port counterpart or a reason
# ---------------------------------------------------------------------------

#: reference waiver sites (module, function) with no waiver in the port
#: function of the same name, and why
NO_PORT_COUNTERPART = {
    ("codecs/base.py", "Codec.pack"):
        "reads through codecs/container.py to_numpy (waived there)",
    ("codecs/container.py", "to_arrays"):
        "reads through to_numpy (waived there)",
    ("codecs/container.py", "payload_crc32"):
        "reads through to_numpy (waived there)",
    ("codecs/container.py", "Container.nbytes"):
        "no read: the port sizes a tensor from numel x element_size",
    ("codecs/cusz.py", "CuszCodec.valid"):
        "delegates to core/stages.py _outlier_valid (waived there)",
    ("codecs/lossless.py", "LosslessCodec.pack"):
        "reads through _storage_array in the same module (waived there)",
    ("io/checkpoint.py", "CheckpointPolicy._eligible"):
        "the bool is read in CheckpointPolicy.spans (waived there)",
    ("io/checkpoint.py", "_assemble_v3"):
        "no read: the value-space fallback concatenates decoded tensors "
        "on the device",
    ("io/checkpoint.py", "_load_step.place"):
        "no read: a restored leaf is decoded on its device and placed",
    ("launch/serve.py", "main"):
        "the wall-clock fence is the helper _sync (waived there)",
    ("launch/train.py", "main"):
        "the step loop is _run; its step-time fence is waived there",
}
#: port waiver sites with no reference waiver in a function of the same
#: name, and why
PORT_ONLY = {
    ("codecs/container.py", "to_numpy"):
        "the one host copy behind pack(), to_arrays() and the crc32",
    ("codecs/lossless.py", "_storage_array"):
        "lossless pack's host copy (the reference waives pack itself)",
    ("kernels/huffman/ref.py", "codeword_lengths_ref"):
        "plain version, CPU tensors only: the tree kernel builds the "
        "lengths on the card, as the reference does on its device",
    ("core/dualquant.py", "extract_outliers"):
        "torch.nonzero sizes the outlier compaction (a read inside the "
        "operator; the reference gathers into a fixed capacity under jit)",
    ("core/dualquant.py", "scatter_outliers"):
        "a boolean mask compacts the filled capacity (a read inside the "
        "operator)",
    ("core/compressor.py", "to_tensor"):
        "unpack()'s pageable copies to the card (card runs only)",
    ("core/metrics.py", "max_abs_err"):
        "a host float metric; the reference's is a device scalar",
    ("io/checkpoint.py", "CheckpointPolicy.spans"):
        "the reference's _eligible bool (see above)",
    ("launch/serve.py", "_sync"):
        "the reference's wall-clock fence in main",
    ("launch/train.py", "_run"):
        "the reference's step-time fence in main",
}


def _sites(root: str):
    """{(module path, function qualname)} of every host-sync waiver under
    `root`."""
    from tools.lint import waived_spans

    out = set()
    for path, spans in waived_spans(root).items():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        defs = []

        def walk(node, prefix):
            for ch in ast.iter_child_nodes(node):
                if isinstance(ch, ast.ClassDef):
                    walk(ch, prefix + ch.name + ".")
                elif isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.append((ch.lineno, ch.end_lineno, prefix + ch.name))
                    walk(ch, prefix + ch.name + ".")
                else:
                    walk(ch, prefix)
        walk(tree, "")
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        for lo, _hi, _reason in spans:
            inner = [d for d in defs if d[0] <= lo <= d[1]]
            name = max(inner)[2] if inner else "<module>"
            out.add((rel, name))
    return out


def test_every_reference_waiver_has_a_port_counterpart_or_reason():
    ref, port = _sites(SRC_REF), _sites(SRC_PORT)
    assert len(ref) >= 20
    missing = {s for s in ref if s not in port
               and s not in NO_PORT_COUNTERPART}
    assert missing == set(), f"reference waivers with no port site: {missing}"
    extra = {s for s in port if s not in ref and s not in PORT_ONLY}
    assert extra == set(), f"port waivers with no reference site: {extra}"
    # the tables name real sites only
    assert set(NO_PORT_COUNTERPART) <= ref - port
    assert set(PORT_ONLY) <= port - ref


# ---------------------------------------------------------------------------
# the card: the sync-debug mode sees reads inside C++ operators
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sync_debug_mode_attributes_copies_on_card(waived):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    delta = torch.arange(-600, 600, dtype=torch.int32, device="cuda")
    in_cap = delta.abs() < 512

    def outliers():
        return dualquant.extract_outliers(delta, in_cap, 256)

    want = outliers()
    before = torch.cuda.get_sync_debug_mode()
    with host_sync_guard({}, strict=False) as log:
        got = outliers()
    # torch.nonzero's count is a cudaMemcpy + stream sync inside the C++
    # operator that no Python hook sees; the sync-debug mode's warning is
    # attributed
    assert any("sync-debug" in v and "dualquant.py" in v
               for v in log.violations), log.violations
    with host_sync_guard(waived) as log:
        outliers()
    assert log.violations == [] and log.allowed_hits
    assert torch.cuda.get_sync_debug_mode() == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
