"""The port's async writer and sharded checkpoints
(`repro_torch.io.{async_writer,checkpoint}`): the reference's writer,
crash-consistency, shard-layout, format-gate and quarantine tests, run on
the port, and the checkpoint format held across packages on the CPU:

  * a checkpoint saved by the reference loads in the port and the
    reverse, bit for bit;
  * both packages write the same manifest and the same shard files, and
    every stored container is bit-identical to the reference codec's
    ``pack(encode(leaf))``.

The reference's save consults `repro.dist.chaos`, a module the checkout
lacks; the cross-package tests put an unarmed stand-in (``current()``
returns None) into ``sys.modules`` for their own duration only.

The `cuda` test at the end saves and loads on a card.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import codecs as tcodecs
from repro_torch.io import checkpoint as CK
from repro_torch.io.async_writer import AsyncWriter
from repro_torch.kernels import dispatch


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": np.cumsum(rng.standard_normal((64, 128)), axis=-1
                       ).astype(np.float32),
        "bias": rng.standard_normal(8).astype(np.float32),
        "step": np.int32(7),
        "opt": {"m": rng.standard_normal((64, 128)).astype(np.float32)},
        "embed": rng.standard_normal((256, 128)).astype(np.float32),
        "bf": rng.standard_normal((32, 256)).astype(np.float32),
        "layers": [rng.standard_normal((16, 512)).astype(np.float32),
                   rng.standard_normal(512).astype(np.float32)],
    }


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: (_torch_tree(v) if k != "bf"
                    else torch.from_numpy(v).to(torch.bfloat16))
                for k, v in t.items()}
    if isinstance(t, list):
        return [_torch_tree(v) for v in t]
    return torch.as_tensor(np.asarray(t))


def _tree(seed=0):
    return _torch_tree(_np_tree(seed))


POLICY = CK.CheckpointPolicy(codec="cusz", eb_valrel=1e-4,
                             rules=(("opt", "int8"), ("embed", "int8-block")))


def _leaves(tree):
    return [leaf for _, leaf in CK._leaves_with_path(tree)]


def _assert_trees_bitwise_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu().view(torch.uint8) if x.dim() else x.cpu(),
                           y.cpu().view(torch.uint8) if y.dim() else y.cpu())


def _load(d, template, **kw):
    return CK.load_checkpoint(d, template, device="cpu", **kw)


# ---------------------------------------------------------------------------
# AsyncWriter
# ---------------------------------------------------------------------------

class TestAsyncWriter:
    def test_runs_tasks_in_order_and_waits(self):
        out = []
        with AsyncWriter(max_pending=2) as w:
            for i in range(5):
                w.submit(out.append, i)
            w.wait()
            assert out == [0, 1, 2, 3, 4]

    def test_exception_reraised_at_wait(self):
        w = AsyncWriter()
        w.submit(lambda: (_ for _ in ()).throw(IOError("disk gone")))
        with pytest.raises(IOError, match="disk gone"):
            w.wait()
        w.wait()                  # error is consumed, writer still usable
        w.close()

    def test_exception_reraised_at_next_submit(self):
        w = AsyncWriter()
        w.submit(lambda: 1 / 0)
        w._q.join()               # let the failure land
        with pytest.raises(ZeroDivisionError):
            w.submit(print, "never runs")
        w.close()

    def test_first_error_wins(self):
        w = AsyncWriter()
        w.submit(lambda: (_ for _ in ()).throw(IOError("first")))
        w.submit(lambda: (_ for _ in ()).throw(ValueError("second")))
        with pytest.raises(IOError, match="first"):
            w.wait()
        w.close()

    def test_bounded_queue_applies_backpressure(self):
        release = threading.Event()
        w = AsyncWriter(max_pending=1)
        w.submit(release.wait)            # running (blocks the worker)
        w.submit(lambda: None)            # fills the queue
        t0 = time.perf_counter()
        blocker = threading.Thread(target=lambda: w.submit(lambda: None))
        blocker.start()
        blocker.join(timeout=0.15)
        assert blocker.is_alive()         # still blocked on the full queue
        release.set()
        blocker.join(timeout=5)
        assert not blocker.is_alive()
        assert time.perf_counter() - t0 >= 0.15
        w.wait()
        w.close()

    def test_closed_writer_rejects_submits(self):
        w = AsyncWriter()
        w.close()
        with pytest.raises(RuntimeError, match="closed"):
            w.submit(lambda: None)

    def test_retries_transient_errors_then_succeeds(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("blip")

        with AsyncWriter(retries=2, backoff_s=0.001) as w:
            w.submit(flaky)
            w.wait()
            assert w.n_retries == 2 and calls["n"] == 3
        w2 = AsyncWriter(retries=5, backoff_s=0.001)
        w2.submit(lambda: 1 / 0)          # not retryable: fails fast
        with pytest.raises(ZeroDivisionError):
            w2.wait()
        assert w2.n_retries == 0
        w2.close()


# ---------------------------------------------------------------------------
# Crash consistency
# ---------------------------------------------------------------------------

class TestCrashConsistency:
    def _failing_shard_writer(self, monkeypatch, fail_after: int):
        real = CK._write_shard
        calls = {"n": 0}

        def failing(path, arrays):
            calls["n"] += 1
            if calls["n"] > fail_after:
                raise IOError("injected: writer died mid-save")
            real(path, arrays)

        monkeypatch.setattr(CK, "_write_shard", failing)
        return calls

    def test_interrupted_save_never_shadows_previous_step(self, tmp_path,
                                                          monkeypatch):
        d = str(tmp_path)
        tree = _tree()
        CK.save_checkpoint(d, 0, tree, policy=POLICY, nshards=3)
        self._failing_shard_writer(monkeypatch, fail_after=1)
        with pytest.raises(IOError, match="injected"):
            CK.save_checkpoint(d, 1, _tree(seed=1), policy=POLICY, nshards=3)
        assert CK.latest_step(d) == 0          # tmp dir is invisible
        restored, step = _load(d, tree)
        assert step == 0
        assert torch.equal(restored["step"], tree["step"])

    def test_async_failure_reraises_at_wait_and_prior_step_survives(
            self, tmp_path, monkeypatch):
        d = str(tmp_path)
        tree = _tree()
        CK.save_checkpoint(d, 0, tree, policy=POLICY, nshards=2)
        self._failing_shard_writer(monkeypatch, fail_after=0)
        w = AsyncWriter()
        assert CK.save_checkpoint(d, 1, _tree(seed=1), policy=POLICY,
                                  nshards=2, writer=w) is w
        with pytest.raises(IOError, match="injected"):
            w.wait()
        assert CK.latest_step(d) == 0
        assert _load(d, tree)[1] == 0
        w.close()

    def test_background_failures_surface(self, tmp_path, monkeypatch):
        self._failing_shard_writer(monkeypatch, fail_after=0)
        monkeypatch.setattr(CK, "_default_writer", None)  # fresh writer
        ret = CK.save_checkpoint(str(tmp_path), 0, _tree(), background=True)
        assert isinstance(ret, AsyncWriter)
        with pytest.raises(IOError, match="injected"):
            CK.wait_for_writes()

    def test_crashed_tmp_dir_is_cleaned_on_retry(self, tmp_path,
                                                 monkeypatch):
        d = str(tmp_path)
        tree = _tree()
        self._failing_shard_writer(monkeypatch, fail_after=1)
        with pytest.raises(IOError):
            CK.save_checkpoint(d, 5, tree, policy=POLICY, nshards=3)
        assert os.path.isdir(os.path.join(d, ".tmp_step_00000005"))
        monkeypatch.undo()
        CK.save_checkpoint(d, 5, tree, policy=POLICY, nshards=3)
        assert CK.latest_step(d) == 5
        assert not os.path.isdir(os.path.join(d, ".tmp_step_00000005"))

    def test_async_snapshot_survives_in_place_updates(self, tmp_path):
        """Lossless parts that alias the live leaf (or a view of it) are
        copied before the write runs, so an in-place update after
        `save_checkpoint` returns cannot leak into the checkpoint."""
        d = str(tmp_path)
        tree = _tree()
        want = {k: v.clone() for k, v in tree.items() if k != "opt"
                and k != "layers"}
        release = threading.Event()
        with AsyncWriter(max_pending=2) as w:
            w.submit(release.wait)
            CK.save_checkpoint(d, 0, tree, nshards=2, writer=w)
            for k in want:
                tree[k].add_(1) if tree[k].dtype != torch.int32 \
                    else tree[k].fill_(0)
            release.set()
            w.wait()
        restored, _ = _load(d, _tree())
        for k, v in want.items():
            assert torch.equal(restored[k], v), k


# ---------------------------------------------------------------------------
# Shard layout and format
# ---------------------------------------------------------------------------

class TestShardedLayout:
    @pytest.mark.parametrize("codec", ("lossless", "int8", "cusz-policy"))
    def test_sharded_save_matches_single_file_bit_for_bit(self, tmp_path,
                                                          codec):
        tree = _tree()
        pol = POLICY if codec == "cusz-policy" \
            else CK.CheckpointPolicy(codec=codec)
        d1, d4 = str(tmp_path / "one"), str(tmp_path / "four")
        CK.save_checkpoint(d1, 0, tree, policy=pol, nshards=1)
        with AsyncWriter(max_pending=1) as w:
            CK.save_checkpoint(d4, 0, tree, policy=pol, nshards=4, writer=w)
            w.wait()
        a, _ = _load(d1, tree)
        b, _ = _load(d4, tree)
        _assert_trees_bitwise_equal(a, b)
        assert CK.LAST_RESTORE_STATS["saved_nshards"] == 4
        assert CK.LAST_RESTORE_STATS["leaves"] == len(_leaves(tree))

    def test_manifest_v3_layout(self, tmp_path):
        final = CK.save_checkpoint(str(tmp_path), 0, _tree(), policy=POLICY,
                                   nshards=4)
        man = json.load(open(os.path.join(final, "manifest.json")))
        assert man["format"] == CK.MANIFEST_FORMAT == 3
        assert man["nshards"] == 4
        for h in range(4):
            assert os.path.exists(os.path.join(final,
                                               CK._SHARD_FMT.format(h)))
        w = man["tensors"]["w"]
        assert w["codec"] == "cusz" and w["axis"] is None
        assert len(w["shards"]) == 1
        m = man["tensors"]["opt::m"]
        assert m["codec"] == "int8" and m["axis"] is not None
        assert [s["shard"] for s in m["shards"]] == [0, 1, 2, 3]
        e = man["tensors"]["embed"]
        assert e["codec"] == "int8-block" and e["axis"] == 0
        assert man["tensors"]["layers::1"]["codec"] == "lossless"
        for e in man["tensors"].values():
            for sh in e["shards"]:
                assert sh["header"]["codec"] == e["codec"]

    def test_pinned_scale_makes_int8_split_stable(self):
        x = torch.linspace(-3, 11, 64 * 32).reshape(64, 32)
        codec = tcodecs.get("int8")
        whole = codec.decode(codec.encode(x))
        axis = codec.shard_axis(x.shape, 4)
        parts = codec.encode_parts(x, axis, 4)
        merged = tcodecs.concat_containers(parts, axis,
                                           codec.payload_axes(axis))
        assert torch.equal(whole, codec.decode(merged))


class TestManifestFormatGate:
    def _v2_checkpoint(self, d, key, value):
        sd = os.path.join(d, "step_00000003")
        os.makedirs(sd)
        codec = tcodecs.get("lossless")
        c = codec.pack(codec.encode(value))
        header, fields = tcodecs.to_arrays(c)
        arrays = {f"{key}::__c__::{f}": v for f, v in fields.items()}
        man = {"step": 3, "format": 2, "policy": "lossless",
               "tensors": {key: {"codec": "lossless", "version": 1,
                                 "header": header}}}
        np.savez(os.path.join(sd, "arrays.npz"), **arrays)
        with open(os.path.join(sd, "manifest.json"), "w") as f:
            json.dump(man, f)

    def test_v2_still_loads_behind_gate(self, tmp_path):
        v = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        self._v2_checkpoint(str(tmp_path), "x", v)
        out, step = _load(str(tmp_path), {"x": torch.zeros(3, 4)})
        assert step == 3
        assert torch.equal(out["x"], v)
        assert CK.LAST_RESTORE_STATS["format"] == 2

    def _manifest_only(self, d, fmt):
        sd = os.path.join(d, "step_00000000")
        os.makedirs(sd)
        with open(os.path.join(sd, "manifest.json"), "w") as f:
            json.dump({"step": 0, "format": fmt, "tensors": {}}, f)

    def test_v1_rejected_with_actionable_error(self, tmp_path):
        self._manifest_only(str(tmp_path), 1)
        with pytest.raises(ValueError, match="predates"):
            _load(str(tmp_path), {})

    def test_future_format_rejected(self, tmp_path):
        self._manifest_only(str(tmp_path), 4)
        with pytest.raises(ValueError, match="supports formats 2"):
            _load(str(tmp_path), {})

    def test_latest_step_ignores_tmp_dirs(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(os.path.join(d, ".tmp_step_00000009"))
        assert CK.latest_step(d) is None
        CK.save_checkpoint(d, 4, {"x": torch.zeros(3)})
        assert CK.latest_step(d) == 4

    def test_load_without_cuda_needs_a_device(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        CK.save_checkpoint(str(tmp_path), 0, {"x": torch.ones(3)})
        with pytest.raises(RuntimeError, match='device="cpu"'):
            CK.load_checkpoint(str(tmp_path), {"x": torch.zeros(3)})
        with pytest.raises(RuntimeError, match='device="cpu"'):
            CK.save_checkpoint(str(tmp_path), 1, {"x": np.ones(3)})


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------

def _small(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(np.cumsum(rng.standard_normal((32, 64)),
                                            axis=-1).astype(np.float32)),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _save_steps(d, steps, nshards=2):
    for s in steps:
        CK.save_checkpoint(d, s, _small(seed=s),
                           policy=CK.CheckpointPolicy(codec="lossless"),
                           nshards=nshards)


def _corrupt_shard(d, step, shard=0, seed=0):
    """Flip one payload byte of a stored shard file."""
    path = os.path.join(d, f"step_{step:08d}", CK._SHARD_FMT.format(shard))
    raw = bytearray(open(path, "rb").read())
    pos = len(raw) // 2 + seed
    raw[pos] ^= 0xFF
    open(path, "wb").write(bytes(raw))


class TestQuarantine:
    def test_corrupted_latest_falls_back_to_last_good(self, tmp_path):
        d = str(tmp_path)
        _save_steps(d, [10, 20, 30])
        _corrupt_shard(d, 30)
        restored, step = _load(d, _small())
        assert step == 20
        assert int(restored["step"]) == 20
        reports = CK.LAST_RESTORE_STATS["quarantine"]
        assert len(reports) == 1 and reports[0]["step"] == 30
        assert reports[0]["error_type"]
        assert os.path.exists(os.path.join(d, "step_00000030",
                                           CK._QUARANTINE_MARK))
        assert CK.available_steps(d) == [10, 20]
        assert CK.latest_step(d) == 20

    def test_two_corrupt_steps_fall_back_twice(self, tmp_path):
        d = str(tmp_path)
        _save_steps(d, [10, 20, 30])
        _corrupt_shard(d, 30)
        _corrupt_shard(d, 20, shard=1, seed=1)
        _, step = _load(d, _small())
        assert step == 10
        assert [r["step"] for r in
                CK.LAST_RESTORE_STATS["quarantine"]] == [30, 20]

    def test_quarantine_false_raises_immediately(self, tmp_path):
        d = str(tmp_path)
        _save_steps(d, [10, 20])
        _corrupt_shard(d, 20)
        with pytest.raises(CK.CheckpointCorruptionError) as ei:
            _load(d, _small(), quarantine=False)
        assert ei.value.reports[0]["step"] == 20
        assert CK.available_steps(d) == [10, 20]

    def test_all_steps_corrupt_raises_with_full_report(self, tmp_path):
        d = str(tmp_path)
        _save_steps(d, [10, 20])
        _corrupt_shard(d, 10)
        _corrupt_shard(d, 20, seed=1)
        with pytest.raises(CK.CheckpointCorruptionError) as ei:
            _load(d, _small())
        assert sorted(r["step"] for r in ei.value.reports) == [10, 20]

    def test_explicit_step_falls_back_below_it(self, tmp_path):
        d = str(tmp_path)
        _save_steps(d, [10, 20, 30])
        _corrupt_shard(d, 20)
        _, step = _load(d, _small(), step=20)
        assert step == 10                    # never forward to 30

    def test_format_gate_errors_still_propagate(self, tmp_path):
        sd = os.path.join(str(tmp_path), "step_00000000")
        os.makedirs(sd)
        with open(os.path.join(sd, "manifest.json"), "w") as f:
            json.dump({"step": 0, "format": 1, "tensors": {}}, f)
        with pytest.raises(ValueError, match="predates"):
            _load(str(tmp_path), {})


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

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
             "CK": "repro.io.checkpoint"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture
def unarmed_chaos(ref, monkeypatch):
    """An unarmed stand-in for the missing `repro.dist.chaos`, for this
    test only: the reference's save and load import `repro.dist`, whose
    package init imports `chaos`."""
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    had_dist = "repro.dist" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.dist.chaos", stub)
    yield stub
    if not had_dist:
        sys.modules.pop("repro.dist", None)


def _ref_tree(ref, t):
    if isinstance(t, dict):
        return {k: (_ref_tree(ref, v) if k != "bf"
                    else ref.jnp.asarray(v).astype(ref.jnp.bfloat16))
                for k, v in t.items()}
    if isinstance(t, list):
        return [_ref_tree(ref, v) for v in t]
    return ref.jnp.asarray(t)


XPOLICIES = {
    "cusz-int8": dict(codec="cusz", eb_valrel=1e-4,
                      rules=(("opt", "int8"), ("embed", "int8-block"))),
    "fz": dict(codec="fz", eb_valrel=1e-3),
    "zfp": dict(codec="zfp"),
}


@pytest.mark.parametrize("nshards", (1, 4))
@pytest.mark.parametrize("policy", sorted(XPOLICIES))
def test_checkpoints_cross_packages(ref, unarmed_chaos, tmp_path, policy,
                                    nshards):
    """Both packages write the same manifest and shard files; each loads
    the other's checkpoint bit for bit; every stored container equals
    the reference codec's pack(encode(leaf))."""
    src = _np_tree()
    mine = CK.save_checkpoint(str(tmp_path / "port"), 0, _torch_tree(src),
                              policy=CK.CheckpointPolicy(**XPOLICIES[policy]),
                              nshards=nshards)
    theirs = ref.CK.save_checkpoint(
        str(tmp_path / "ref"), 0, _ref_tree(ref, src),
        policy=ref.CK.CheckpointPolicy(**XPOLICIES[policy]), nshards=nshards)
    man = open(os.path.join(mine, "manifest.json")).read()
    assert man == open(os.path.join(theirs, "manifest.json")).read()
    for h in range(nshards):
        a = np.load(os.path.join(mine, CK._SHARD_FMT.format(h)))
        b = np.load(os.path.join(theirs, CK._SHARD_FMT.format(h)))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k
    # stored containers: the reference codec's pack(encode(leaf))
    flat = dict(ref.CK._flatten(_ref_tree(ref, src)))
    policy_obj = ref.CK.CheckpointPolicy(**XPOLICIES[policy])
    shards = [np.load(os.path.join(mine, CK._SHARD_FMT.format(h)))
              for h in range(nshards)]
    for key, entry in json.loads(man)["tensors"].items():
        if entry["axis"] is not None:
            continue                       # split leaves: checked above
        codec = policy_obj.make_codec(entry["codec"]) \
            if entry["codec"] != "lossless" else ref.codecs.get("lossless")
        hdr, want = ref.codecs.to_arrays(codec.pack(codec.encode(flat[key])))
        sh = entry["shards"][0]
        prefix = f"{key}::__c__::0::"
        got = {k[len(prefix):]: shards[sh["shard"]][k]
               for k in shards[sh["shard"]].files if k.startswith(prefix)}
        assert sh["header"] == hdr
        assert sorted(got) == sorted(want)
        for f in want:
            assert got[f].tobytes() == np.asarray(want[f]).tobytes(), f
    # each package loads the other's checkpoint
    tmpl = _torch_tree(src)
    from_ref, _ = _load(str(tmp_path / "ref"), tmpl)
    own, _ = _load(str(tmp_path / "port"), tmpl)
    _assert_trees_bitwise_equal(from_ref, own)
    from_port, _ = ref.CK.load_checkpoint(str(tmp_path / "port"),
                                          _ref_tree(ref, src))
    for (_, a), (_, b) in zip(CK._leaves_with_path(own),
                              CK._leaves_with_path(from_port)):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b.astype(ref.jnp.float32)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_checkpoint_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    tree = CK._rebuild(_tree(), iter([leaf.cuda()
                                      for leaf in _leaves(_tree())]))
    dispatch.reset_launches()
    with AsyncWriter() as w:
        CK.save_checkpoint(str(tmp_path), 0, tree, policy=POLICY,
                           nshards=4, writer=w)
        w.wait()
    assert dispatch.launch_counts()["lorenzo.dualquant"] >= 1
    out, _ = CK.load_checkpoint(str(tmp_path), tree, device="cuda")
    cpu, _ = _load(str(tmp_path), _tree())
    assert all(leaf.is_cuda for leaf in _leaves(out))
    _assert_trees_bitwise_equal(out, cpu)
    man = json.load(open(os.path.join(str(tmp_path), "step_00000000",
                                      "manifest.json")))
    assert man["tensors"]["w"]["codec"] == "cusz"
    assert dispatch.launch_counts()["lorenzo.reverse"] >= 1
