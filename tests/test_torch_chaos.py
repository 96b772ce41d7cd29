"""The port's fault layer (`repro_torch.dist.{chaos,fault}`) on the CPU.

`chaos` has no source in git to compare with, so it is held against the
contract of the reference's `tests/test_chaos.py`: the spec grammar, the
simulation ``dur[h] = compute·share[h]·n + delay·share[h]·n``, real
sleeps, the NaN schedule, exactly-n transient write errors, partial
truncation to 60%, a one-byte flip in the second half, the writer
faults through `io.checkpoint` (retried, surfaced, quarantined at
restore), and the trainer under chaos.  `fault` is held against the
reference's module on identical duration sequences: the same flags,
shares, exclusions and events, exactly (both are the same numpy code).

The reference's `repro.dist` package init imports the `chaos` module the
checkout lacks: the `ref` fixture puts an unarmed stand-in into
`sys.modules` for this module's duration and removes every `repro*`
module it added at teardown.
"""
from __future__ import annotations

import glob
import importlib
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.dist import chaos, fault
from repro_torch.io import checkpoint as CK
from repro_torch.io.async_writer import AsyncWriter
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import LoopConfig, Trainer


@pytest.fixture(scope="module")
def ref_fault():
    """The reference's `repro.dist.fault`, imported with an unarmed
    `repro.dist.chaos` stand-in."""
    before = set(sys.modules)
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    sys.modules["repro.dist.chaos"] = stub
    try:
        yield importlib.import_module("repro.dist.fault")
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]
                parent, _, child = name.rpartition(".")
                if parent in sys.modules:
                    sys.modules[parent].__dict__.pop(child, None)


# ---------------------------------------------------------------------------
# config and spec
# ---------------------------------------------------------------------------

def test_from_spec_full_grammar():
    cfg = chaos.from_spec(
        "straggler:host=3,delay=0.25,start=2,stop=9;"
        "writer:failures=2,kind=partial;nan:steps=7+8;corrupt:shards=1",
        seed=5, nhosts=8)
    assert cfg.straggler_host == 3 and cfg.straggler_delay_s == 0.25
    assert (cfg.straggler_start, cfg.straggler_stop) == (2, 9)
    assert cfg.writer_failures == 2 and cfg.writer_fault == "partial"
    assert cfg.nan_steps == (7, 8)
    assert cfg.corrupt_shards == 1
    assert cfg.seed == 5 and cfg.nhosts == 8


def test_from_spec_defaults_widening_and_errors():
    cfg = chaos.from_spec("writer:", nhosts=2)
    assert cfg.writer_failures == 1 and cfg.writer_fault == "raise"
    assert chaos.from_spec("straggler:host=5,delay=0.1").nhosts == 6
    with pytest.raises(ValueError, match="unknown chaos group"):
        chaos.from_spec("gremlin:count=3")
    with pytest.raises(ValueError, match="unknown key"):
        chaos.from_spec("writer:count=3")
    with pytest.raises(ValueError, match="writer fault"):
        chaos.from_spec("writer:kind=flood")


def test_use_chaos_none_is_noop_and_current_tracks_context():
    with chaos.use_chaos(None) as monkey:
        assert monkey is None and chaos.current() is None
    cfg = chaos.ChaosConfig(nhosts=4)
    with chaos.use_chaos(cfg) as monkey:
        assert chaos.current() is monkey
        with chaos.use_chaos(chaos.ChaosConfig()) as inner:
            assert chaos.current() is inner
        assert chaos.current() is monkey
    assert chaos.current() is None


# ---------------------------------------------------------------------------
# the monkey
# ---------------------------------------------------------------------------

def test_straggler_simulation_contract():
    """dur[h] = compute*share*n + delay*share*n on the straggler:
    shrinking the straggler's share genuinely shrinks its duration."""
    m = chaos.ChaosMonkey(chaos.ChaosConfig(nhosts=4, straggler_host=1,
                                            straggler_delay_s=0.4))
    durs = m.host_step_times(0, 0.1)
    np.testing.assert_allclose(durs, [0.1, 0.5, 0.1, 0.1])
    half = np.array([1.25, 0.25, 1.25, 1.25]) / 4.0
    durs2 = m.host_step_times(0, 0.1, shares=half)
    assert durs2[1] == pytest.approx((0.1 + 0.4) * 0.25 / 4 * 4)
    assert durs2[1] < durs[1]


def test_straggler_window():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(
        nhosts=2, straggler_host=0, straggler_delay_s=1.0,
        straggler_start=3, straggler_stop=5))
    assert [m.straggler_active(s) for s in range(6)] == \
        [False, False, False, True, True, False]


def test_inject_step_sleeps_the_modeled_extra():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(nhosts=2, straggler_host=0,
                                            straggler_delay_s=0.05))
    t0 = time.perf_counter()
    total, durs = m.inject_step(0, 0.0)
    wall = time.perf_counter() - t0
    assert total == pytest.approx(float(durs.max()))
    assert wall >= 0.04                      # the sleep is real
    assert m.events and m.events[0]["kind"] == "straggler-delay"


def test_nan_burst_schedule():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(nan_steps=(2, 5)))
    assert [m.nan_burst(s) for s in range(6)] == \
        [False, False, True, False, False, True]
    assert sum(e["kind"] == "nan-burst" for e in m.events) == 2


def test_pre_write_raises_exactly_n_transient_errors():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(writer_failures=2))
    for _ in range(2):
        with pytest.raises(chaos.TransientWriteError):
            m.pre_write("/nonexistent/x")
    m.pre_write("/nonexistent/x")            # budget exhausted
    assert isinstance(chaos.TransientWriteError("x"), OSError)


def test_post_write_partial_truncates(tmp_path):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:
        f.write(bytes(1000))
    m = chaos.ChaosMonkey(chaos.ChaosConfig(writer_failures=1,
                                            writer_fault="partial"))
    m.pre_write(p)                           # partial faults never raise
    m.post_write(p)
    assert os.path.getsize(p) == 600
    m.post_write(p)                          # budget exhausted
    assert os.path.getsize(p) == 600


def test_post_write_corrupt_flips_one_byte(tmp_path):
    p = str(tmp_path / "f.bin")
    payload = bytes(range(256)) * 8
    with open(p, "wb") as f:
        f.write(payload)
    m = chaos.ChaosMonkey(chaos.ChaosConfig(corrupt_shards=1, seed=3))
    m.post_write(p)
    got = open(p, "rb").read()
    assert len(got) == len(payload)
    diff = [i for i in range(len(payload)) if got[i] != payload[i]]
    assert len(diff) == 1 and diff[0] >= len(payload) // 2
    m.post_write(p)                          # budget exhausted
    assert open(p, "rb").read() == got


# ---------------------------------------------------------------------------
# writer faults through the port's checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(np.cumsum(rng.standard_normal((32, 64)),
                                            axis=-1).astype(np.float32)),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _save_steps(d, steps, nshards=2):
    for s in steps:
        CK.save_checkpoint(d, s, _tree(seed=s),
                           policy=CK.CheckpointPolicy(codec="lossless"),
                           nshards=nshards)


def test_transient_write_fault_retried_to_success(tmp_path):
    """'raise' faults are OSErrors: the AsyncWriter retries them and the
    checkpoint lands."""
    d = str(tmp_path)
    with chaos.use_chaos(chaos.ChaosConfig(writer_failures=1)) as monkey:
        with AsyncWriter(max_pending=1, retries=2, backoff_s=0.001) as w:
            CK.save_checkpoint(d, 0, _tree(), writer=w)
            w.wait()
            assert w.n_retries == 1
        assert [e["kind"] for e in monkey.events] == ["transient-write-error"]
    restored, step = CK.load_checkpoint(d, _tree(), device="cpu")
    assert step == 0 and torch.equal(restored["w"], _tree()["w"])


def test_transient_fault_without_retries_surfaces(tmp_path):
    d = str(tmp_path)
    with chaos.use_chaos(chaos.ChaosConfig(writer_failures=1)):
        w = AsyncWriter(max_pending=1, retries=0)
        CK.save_checkpoint(d, 0, _tree(), writer=w)
        with pytest.raises(chaos.TransientWriteError):
            w.wait()
        w.close()
    assert CK.latest_step(d) is None         # tmp dir never promoted


@pytest.mark.parametrize("kind", ("partial", "corrupt"))
def test_damaged_write_quarantined_at_restore(tmp_path, kind):
    """A silently truncated or bit-flipped shard passes the save, then
    trips the integrity check at restore, which falls back to the prior
    step."""
    d = str(tmp_path)
    _save_steps(d, [10])
    cfg = (chaos.ChaosConfig(writer_failures=1, writer_fault="partial")
           if kind == "partial" else chaos.ChaosConfig(corrupt_shards=1))
    with chaos.use_chaos(cfg) as monkey:
        _save_steps(d, [20])
    assert any(e["kind"] in ("partial-write", "corrupt-shard")
               for e in monkey.events)
    assert CK.latest_step(d) == 20           # the damage is silent...
    restored, step = CK.load_checkpoint(d, _tree(), device="cpu")
    assert step == 10                        # ...until restore catches it
    assert int(restored["step"]) == 10
    assert CK.LAST_RESTORE_STATS["quarantine"][0]["step"] == 20


def test_corrupt_file_falls_back_to_last_good(tmp_path):
    d = str(tmp_path)
    _save_steps(d, [10, 20, 30])
    shards = sorted(glob.glob(os.path.join(d, "step_00000030",
                                           "shard_*.npz")))
    chaos.corrupt_file(shards[0])
    _, step = CK.load_checkpoint(d, _tree(), device="cpu")
    assert step == 20 and CK.available_steps(d) == [10, 20]


# ---------------------------------------------------------------------------
# fault: the same decisions as the reference's
# ---------------------------------------------------------------------------

SCENARIOS = {
    # (nhosts, straggler host, delay s, straggler stop, steps)
    "rebalance": (8, 3, 0.4, None, 12),
    "slow-since-step-0": (4, 0, 0.5, None, 10),
    "exclusion": (4, 2, 50.0, None, 20),
    "heals": (8, 3, 0.4, 12, 37),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mitigation_policy_matches_reference(ref_fault, name):
    """The port's `MitigationPolicy` against the reference's on the same
    per-host duration sequences (the port's chaos simulation, shares fed
    back): identical reports, shares, exclusions and events."""
    nhosts, host, delay, stop, steps = SCENARIOS[name]
    monkey = chaos.ChaosMonkey(chaos.ChaosConfig(
        nhosts=nhosts, straggler_host=host, straggler_delay_s=delay,
        straggler_stop=stop))
    mine = fault.MitigationPolicy(nhosts)
    theirs = ref_fault.MitigationPolicy(nhosts)
    for s in range(steps):
        durs = monkey.host_step_times(s, 0.1, mine.shares)
        assert mine.observe(s, durs) == theirs.observe(s, durs)
        np.testing.assert_array_equal(mine.shares, theirs.shares)
    assert mine.excluded == theirs.excluded
    assert mine.events == theirs.events
    for loss in (1.25, float("nan"), float("inf")):
        assert mine.on_bad_loss(steps, loss) == \
            theirs.on_bad_loss(steps, loss)
    assert mine.events == theirs.events
    if name == "exclusion":
        mine.reset(host)
        theirs.reset(host)
        np.testing.assert_array_equal(mine.shares, theirs.shares)
        assert mine.events == theirs.events


def test_straggler_detector_matches_reference(ref_fault):
    """`StragglerDetector` on a duration sequence with a warmup
    straggler, spikes and a ~0 baseline: the same flags, penalty and
    counters, per host too."""
    rng = np.random.default_rng(0)
    durs = 0.1 + 0.01 * rng.standard_normal(40)
    durs[[2, 9, 10, 25]] = [0.9, 0.5, 0.6, 0.8]
    mine, theirs = fault.StragglerDetector(), ref_fault.StragglerDetector()
    for s, d in enumerate(durs):
        h = s % 3
        assert mine.observe(s, d) == theirs.observe(s, d)
        assert mine.observe(s, d, host=h) == theirs.observe(s, d, host=h)
    for attr in ("ema", "n_observed", "n_flagged", "penalty",
                 "consecutive_flags"):
        assert getattr(mine, attr) == getattr(theirs, attr)
        assert getattr(mine.host(1), attr) == getattr(theirs.host(1), attr)
    zero_m, zero_r = fault.StragglerDetector(warmup=1), \
        ref_fault.StragglerDetector(warmup=1)
    for s, d in enumerate([0.0, 0.0, 0.2, 0.2, 1.0]):
        assert zero_m.observe(s, d) == zero_r.observe(s, d)
    assert fault.loss_is_bad(float("nan")) and not fault.loss_is_bad(2.5)


# ---------------------------------------------------------------------------
# the trainer under chaos
# ---------------------------------------------------------------------------

def test_trainer_nan_burst_skipped_and_mitigation_wired():
    """As the reference's trainer test: the NaN step is skipped and
    logged, and the straggler simulation feeds the policy real per-host
    durations."""
    cfg = tconfigs.reduced("qwen2.5-3b", n_periods=1)
    policy = fault.MitigationPolicy(4)
    lcfg = LoopConfig(steps=6, batch=2, seq=16, mitigation=policy,
                      log_every=100)
    ccfg = chaos.ChaosConfig(nhosts=4, nan_steps=(3,), straggler_host=1,
                             straggler_delay_s=0.01)
    with chaos.use_chaos(ccfg):
        hist = Trainer(cfg, TrainConfig(), lcfg, device="cpu").run()
    steps = [h["step"] for h in hist]
    assert 3 not in steps and len(steps) == 5
    assert policy.n_skipped == 1
    assert policy.detector.host(1).n_observed > 0


def test_trainer_checkpoints_through_a_transient_write_fault(tmp_path):
    """A writer fault during the trainer's async save is retried on the
    writer thread; the run resumes from the saved step."""
    cfg = tconfigs.reduced("qwen2.5-3b", n_periods=1)
    d = str(tmp_path)
    lcfg = LoopConfig(steps=2, batch=2, seq=16, checkpoint_every=2,
                      checkpoint_dir=d, log_every=100)
    with chaos.use_chaos(chaos.from_spec("writer:failures=1")) as monkey:
        Trainer(cfg, TrainConfig(), lcfg, device="cpu").run()
    assert [e["kind"] for e in monkey.events] == ["transient-write-error"]
    assert CK.latest_step(d) == 1
    lcfg.steps = 3
    hist = Trainer(cfg, TrainConfig(), lcfg, device="cpu").run()
    assert [h["step"] for h in hist] == [2]
