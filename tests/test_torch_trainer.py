"""The port's training loop and launcher (`repro_torch.train.trainer`,
`repro_torch.launch.train`) against the reference's, on the CPU:

  * `Trainer.run` with the reference's initial state injected, 4 steps at
    the default bf16 compute: the same steps and slow flags, losses within
    1e-2 relative (bf16 intermediates round at different points);
  * a checkpoint written by either trainer resumes in the other: the
    resumed histories of both trainers from the same files agree on steps
    and within 1e-2 relative on losses;
  * the NaN guard's host snapshot restores the live state bit for bit;
  * `launch.train --device cpu --reduced` runs, a rerun prints
    ``resumed from step N``, and with ``--weight-compress int8
    --grad-compress int8`` its losses equal the reference launcher's
    (``--mesh host``: a 1x1 mesh where neither flag changes the numbers)
    within 1e-2 relative.  The reference launcher runs in a subprocess
    with an unarmed `repro.dist.chaos` stand-in, since the checkout lacks
    that module.

The `ref` fixture imports the reference with the same stand-in for this
module's duration and removes every `repro*` module it added at
teardown.  The `cuda` test trains a few steps on the card and round-trips
the train state through a checkpoint there.
"""
from __future__ import annotations

import importlib
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.dist import chaos
from repro_torch.io import checkpoint as CK
from repro_torch.launch import train as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train import trainer as TR
from repro_torch.train.train_step import TrainConfig
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2.5-3b"
BF16_RTOL = 1e-2


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
    names = {"jax": "jax", "configs": "repro.configs",
             "M": "repro.models.model", "T": "repro.train.train_step",
             "TR": "repro.train.trainer", "A": "repro.optim.adamw"}
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


def _ref_init(ref, cfg, seed=0):
    """The reference's initial state, and the same state in the port."""
    p = ref.M.init_params(ref.jax.random.PRNGKey(seed), cfg)
    o = ref.A.init(p, ref.A.AdamWConfig())
    np_p = ref.jax.tree.map(np.asarray, p)
    return TM.params_from_numpy(np_p, device="cpu"), TA.opt_state_from_numpy(
        ref.jax.tree.map(np.asarray, o), device="cpu")


def _loop(**kw):
    base = dict(steps=4, batch=2, seq=32, log_every=100)
    base.update(kw)
    return base


def _port_trainer(ref, lcfg, inject=True):
    tr = TR.Trainer(tconfigs.reduced(ARCH, n_periods=1), TrainConfig(),
                    TR.LoopConfig(**lcfg), device="cpu")
    if inject:
        state = _ref_init(ref, ref.configs.reduced(ARCH, n_periods=1),
                          lcfg.get("seed", 0))
        tr.init_state = lambda: state
    return tr


def _ref_trainer(ref, lcfg):
    return ref.TR.Trainer(ref.configs.reduced(ARCH, n_periods=1),
                          ref.T.TrainConfig(), ref.TR.LoopConfig(**lcfg))


def _assert_histories_agree(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    assert [h["slow"] for h in got] == [h["slow"] for h in want]
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= BF16_RTOL * abs(b["loss"])


def test_trainer_history_matches_reference(ref):
    """4 steps from the reference's initial state: the same steps and
    slow flags, losses within 1e-2 relative."""
    want = _ref_trainer(ref, _loop()).run()
    got = _port_trainer(ref, _loop()).run()
    _assert_histories_agree(got, want)


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_checkpoint_resumes_across_trainers(ref, tmp_path, writer):
    """Steps 0-1 by one trainer, saved (default cusz policy, async); both
    trainers resume steps 2-3 from copies of those files: the same steps,
    losses within 1e-2 relative."""
    src = str(tmp_path / "src")
    first = _loop(steps=2, checkpoint_every=2, checkpoint_dir=src)
    if writer == "reference":
        _ref_trainer(ref, first).run()
    else:
        _port_trainer(ref, first).run()
    assert CK.latest_step(src) == 1
    runs = {}
    for who in ("reference", "port"):
        d = str(tmp_path / who)
        shutil.copytree(src, d)
        lcfg = _loop(steps=4, checkpoint_every=100, checkpoint_dir=d)
        runs[who] = (_ref_trainer(ref, lcfg) if who == "reference"
                     else _port_trainer(ref, lcfg, inject=False)).run()
    assert [h["step"] for h in runs["port"]] == [2, 3]
    _assert_histories_agree(runs["port"], runs["reference"])


def _guarded_run(ref, steps, nan_steps):
    """The port's trainer under a chaos NaN schedule: its history and the
    live state after its last step."""
    tr = _port_trainer(ref, _loop(steps=steps))
    seen = {}
    step_fn = tr.step_fn

    def spy(params, opt, toks):
        loss, params, opt = step_fn(params, opt, toks)
        seen["state"] = (params, opt)
        return loss, params, opt
    tr.step_fn = spy
    with chaos.use_chaos(chaos.ChaosConfig(nan_steps=nan_steps)):
        hist = tr.run()
    return hist, seen["state"]


def test_nan_guard_restores_the_host_snapshot_bit_for_bit(ref):
    """A NaN loss at step 1 (chaos) restores the snapshot taken after step
    0 into the live tensors: the state equals a 1-step run's, bit for
    bit, and step 1 is missing from the history.  `HostSnapshot` restores
    bit for bit, and a later `take` overwrites the same host buffers."""
    hist1, one = _guarded_run(ref, 1, ())
    hist2, guarded = _guarded_run(ref, 2, (1,))
    assert [h["step"] for h in hist2] == [0]
    for a, b in zip(leaves(guarded), leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    snap = TR.HostSnapshot()
    snap.take(one)
    before = [t.clone() for t in leaves(one)]
    bufs = [b.data_ptr() for b in snap.buffers]
    for t in leaves(one):
        if t.is_floating_point():
            t.add_(1)
    snap.restore(one)
    for a, b in zip(leaves(one), before):
        assert torch.equal(a, b)
    # a later snapshot overwrites the same buffers
    for t in leaves(one):
        if t.is_floating_point():
            t.mul_(2)
    moved = [t.clone() for t in leaves(one)]
    snap.take(one)
    assert [b.data_ptr() for b in snap.buffers] == bufs
    for t in leaves(one):
        t.zero_()
    snap.restore(one)
    for a, b in zip(leaves(one), moved):
        assert torch.equal(a, b)
    snap.close()
    assert snap.buffers is None


def test_nan_guard_restores_the_latest_snapshot(ref, monkeypatch):
    """With a snapshot every 2 steps the guard takes them after steps 0
    and 2; a NaN at step 3 restores the second, so the state equals a
    3-step run's bit for bit."""
    monkeypatch.setattr(TR, "SNAPSHOT_EVERY", 2)
    _, three = _guarded_run(ref, 3, ())
    hist, guarded = _guarded_run(ref, 4, (3,))
    assert [h["step"] for h in hist] == [0, 1, 2]
    for a, b in zip(leaves(guarded), leaves(three)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

_STEP_RE = re.compile(r"step\s+(\d+)\s+loss\s+([0-9.]+)")

_REF_LAUNCHER = """
import contextlib, runpy, sys, types
stub = types.ModuleType("repro.dist.chaos")
stub.current = lambda: None
stub.use_chaos = contextlib.contextmanager(lambda cfg: (yield None))
sys.modules["repro.dist.chaos"] = stub
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("repro.launch.train", run_name="__main__")
"""


def _losses(text):
    return {int(s): float(v) for s, v in _STEP_RE.findall(text)}


def _argv(*extra):
    return ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "32",
            *extra]


def test_launcher_runs_and_resumes(tmp_path, capsys):
    """`--device cpu --reduced` trains; a rerun resumes from the last
    checkpoint and prints ``resumed from step N``."""
    d = str(tmp_path / "ck")
    TL.main(_argv("--device", "cpu", "--steps", "3", "--checkpoint-dir", d,
                  "--checkpoint-every", "2"))
    out = capsys.readouterr().out
    assert sorted(_losses(out)) == [0, 2]
    TL.main(_argv("--device", "cpu", "--steps", "5", "--checkpoint-dir", d,
                  "--checkpoint-every", "2"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert sorted(_losses(out)) == [4]


def test_launcher_refuses_without_cuda():
    """The default device is the card: without one the launcher says to
    pass --device cpu instead of running on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        TL.main(_argv("--steps", "1"))


@pytest.mark.parametrize("flags", (("--mesh", "single"), ("--mesh", "multi"),
                                   ("--lower-only",)))
def test_launcher_mesh_paths_name_the_roadmap(flags, capsys):
    """The production meshes need 256 or 512 ranks (one process here);
    --lower-only builds the step under fake tensors on a fake group of
    256 ranks, prints the per-rank memory and leaves no group behind."""
    if flags[0] == "--lower-only":
        argv = _argv("--device", "cpu", *flags)
        argv[argv.index("--batch") + 1] = "32"      # rows over 16 ranks
        TL.main(argv)
        out = capsys.readouterr().out
        assert "on 256 ranks" in out and "per-rank memory" in out
        mem = float(out.split("per-rank memory ")[1].split(" GiB")[0])
        assert 0 < mem < 1
        import torch.distributed as dist
        assert not dist.is_initialized()
        return
    want = "512" if flags[1] == "multi" else "256"
    with pytest.raises(RuntimeError, match=f"needs {want} ranks"):
        TL.main(_argv("--device", "cpu", *flags))
    import torch.distributed as dist
    assert not dist.is_initialized()         # the group is torn down


def test_launcher_matches_reference_launcher(ref, monkeypatch, capsys):
    """With --weight-compress int8 --grad-compress int8 on one device,
    the port's losses equal the reference launcher's within 1e-2 relative
    (the reference's seed-0 weights injected into the port)."""
    flags = _argv("--steps", "3", "--weight-compress", "int8",
                  "--grad-compress", "int8")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", _REF_LAUNCHER, *flags],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    want = _losses(done.stdout)
    params, _ = _ref_init(ref, ref.configs.reduced(ARCH))
    monkeypatch.setattr(TL.M, "init_params", lambda gen, cfg, device: params)
    TL.main(flags + ["--device", "cpu"])
    got = _losses(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == [0, 2]
    for s in want:
        assert abs(got[s] - want[s]) <= BF16_RTOL * want[s]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_host_snapshot_on_card_is_page_locked():
    """`HostSnapshot` of card tensors: page-locked host buffers, restored
    bit for bit, overwritten in place by a second take, unregistered by
    `close`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    gen = torch.Generator("cuda").manual_seed(0)
    state = {"w": torch.randn((1000, 257), generator=gen, device="cuda"),
             "c": torch.zeros((), dtype=torch.int32, device="cuda")}
    snap = TR.HostSnapshot()
    snap.take(state)
    assert all(b.is_pinned() and b.device.type == "cpu"
               for b in snap.buffers)
    ptrs = [b.data_ptr() for b in snap.buffers]
    want = {k: v.clone() for k, v in state.items()}
    state["w"].add_(1)
    snap.restore(state)
    assert all(torch.equal(state[k], want[k]) for k in state)
    state["c"].add_(3)
    snap.take(state)
    assert [b.data_ptr() for b in snap.buffers] == ptrs
    assert int(snap.buffers[0]) == 3          # "c" sorts before "w"
    snap.close()
    assert snap.buffers is None


@pytest.mark.cuda
def test_trainer_and_train_state_checkpoint_on_card(tmp_path):
    """3 steps on the card with a cusz checkpoint after step 1; the saved
    state loads back on the card with its NamedTuples, equal to a CPU
    load of the same files bit for bit; a rerun resumes at step 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    cfg = tconfigs.reduced(ARCH, n_periods=1)
    d = str(tmp_path)
    lcfg = TR.LoopConfig(**_loop(steps=3, checkpoint_every=2,
                                 checkpoint_dir=d))
    hist = TR.Trainer(cfg, TrainConfig(), lcfg).run()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    tmpl = TR.state_template(cfg, TrainConfig())
    (p, o), step = CK.load_checkpoint(d, tmpl, device="cuda")
    (pc, oc), _ = CK.load_checkpoint(d, tmpl, device="cpu")
    assert step == 1 and type(o) is TA.AdamWState and int(o.count) == 2
    for a, b in zip(leaves((p, o)), leaves((pc, oc))):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    lcfg = TR.LoopConfig(**_loop(steps=4, checkpoint_every=100,
                                 checkpoint_dir=d))
    assert [h["step"] for h in TR.Trainer(cfg, TrainConfig(),
                                          lcfg).run()] == [2, 3]
