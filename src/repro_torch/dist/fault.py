"""Fault detection *and mitigation* for the training loop.

Host-side numpy (the port's own copy of the reference's
`repro.dist.fault`): the trainer calls these between steps on host
values (a loss as a Python float).

  * ``StragglerDetector`` — flags steps that exceed ``threshold``x an
    EMA baseline (median-of-warmup seeded).  Grown per-host: pass
    ``host=`` to ``observe`` to keep one independent baseline per host,
    ``reset(host)`` to re-warm a recovered host's state, and read
    ``penalty(host)`` — a decaying flag score — instead of the raw
    cumulative ``n_flagged`` when deciding whether a host is *currently*
    misbehaving (the stale-EMA-penalty fix).
  * ``MitigationPolicy`` — consumes the detection and acts on it:
    rebalances work shares away from flagged hosts (proportional
    control toward ``target_ratio`` of the healthy-host median),
    excludes a persistently-flagged host/pod outright, restores shares
    (and resets the detector) once a host runs clean again, and
    skip-and-logs steps whose loss is NaN/Inf.  Every action lands in a
    structured ``events`` log.
  * ``loss_is_bad`` — the NaN/Inf guard feeding the restore-last-good
    path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class StragglerDetector:
    """Flag abnormally slow steps against an EMA baseline.

    The first ``warmup`` observations only establish the baseline and are
    never flagged.  The warmup baseline is the **median** of the warmup
    window, not an EMA over it: a straggler landing *during* warmup
    (steps 2..warmup) must not be folded into the baseline, or it would
    inflate it and suppress all later detection.  After warmup a flagged
    step does not poison the baseline either (its duration is excluded
    from the EMA), so a single straggler recovers immediately on the next
    normal step.

    ``penalty`` decays by ``penalty_decay`` on every clean step and bumps
    by 1 on every flagged one — a recency-weighted misbehavior score,
    unlike the monotone telemetry counter ``n_flagged``.
    """

    def __init__(self, threshold: float = 2.0, warmup: int = 5,
                 alpha: float = 0.2, penalty_decay: float = 0.5):
        assert threshold > 1.0, threshold
        assert 0.0 <= penalty_decay < 1.0, penalty_decay
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.penalty_decay = float(penalty_decay)
        self._hosts: Dict[Any, "StragglerDetector"] = {}
        self.reset()

    def reset(self, host=None) -> None:
        """Re-warm detection state.  ``reset()`` clears this detector
        (and every per-host child); ``reset(host)`` clears only that
        host's baseline/penalty — the recovered-host API the mitigation
        policy calls so stale EMA state stops penalizing it."""
        if host is not None:
            self._hosts.pop(host, None)
            return
        self.ema: Optional[float] = None
        self.n_observed = 0
        self.n_flagged = 0
        self.penalty = 0.0
        self.consecutive_flags = 0
        self._warmup_durations: list = []
        self._hosts.clear()

    def host(self, host) -> "StragglerDetector":
        """The per-host child detector (created on first observation)."""
        if host not in self._hosts:
            self._hosts[host] = StragglerDetector(
                self.threshold, self.warmup, self.alpha, self.penalty_decay)
        return self._hosts[host]

    def observe(self, step: int, duration_s: float, host=None) -> bool:
        """Record one step's wall-time; returns True iff it straggled.
        With ``host=`` the observation goes to that host's independent
        baseline (the multi-host form the mitigation policy uses)."""
        if host is not None:
            return self.host(host).observe(step, duration_s)
        duration_s = float(duration_s)
        self.n_observed += 1
        if self.ema is None or self.n_observed <= self.warmup:
            # warmup: outlier-robust baseline (median of the window)
            self._warmup_durations.append(duration_s)
            self.ema = float(np.median(self._warmup_durations))
            return False
        if self.ema <= 1e-12:
            # degenerate ~0 baseline (coarse timers): reseed instead of
            # flagging, or every later step would flag with the EMA frozen
            self.ema = duration_s
            return False
        slow = duration_s > self.threshold * self.ema
        if slow:
            self.n_flagged += 1
            self.penalty += 1.0
            self.consecutive_flags += 1
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * duration_s
            self.penalty *= self.penalty_decay
            self.consecutive_flags = 0
        return bool(slow)


def loss_is_bad(loss) -> bool:
    """True when the (concrete, scalar) loss is NaN/Inf."""
    return not bool(np.isfinite(np.asarray(loss)))


# ---------------------------------------------------------------------------
# Mitigation: act on the detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MitigationConfig:
    """Knobs for `MitigationPolicy` (see the README Resilience section).

    Rebalancing is proportional control: a detected host's work share is
    scaled by ``target_ratio * median(healthy) / duration`` each step it
    runs hot, so its modeled step time converges geometrically onto
    ``target_ratio``x the healthy median.  A host flagged
    ``exclude_after`` consecutive times *while already at the
    ``min_share`` floor* is excluded outright (share 0) — the
    persistently-bad-pod case where rebalancing cannot help."""
    threshold: float = 2.0           # StragglerDetector flag ratio
    warmup: int = 3                  # baseline steps per host
    alpha: float = 0.2               # baseline EMA weight
    penalty_decay: float = 0.5       # per-clean-step flag-score decay
    target_ratio: float = 1.1        # rebalance until within this of peers
    min_share: float = 0.01          # share floor before exclusion
    exclude_after: int = 3           # consecutive floor-flags -> exclude
    recover_after: int = 3           # clean steps before share restore
    restore_factor: float = 1.5      # share restore multiplier per step


class MitigationPolicy:
    """Turn per-host straggler flags into work-share decisions.

    ``observe(step, host_durations)`` updates the per-host detectors and
    ``shares`` (a simplex over hosts: each host's fraction of the global
    microbatch work).  ``shares`` starts uniform; the trainer feeds it to
    its data/microbatch assignment (and, under chaos, to the straggler
    simulation — see `dist.chaos`).  ``on_bad_loss`` is the skip-and-log
    guard for NaN/Inf losses.  Every decision appends a structured event
    to ``events``.
    """

    def __init__(self, nhosts: int,
                 cfg: MitigationConfig = MitigationConfig()):
        assert nhosts >= 1, nhosts
        self.nhosts = int(nhosts)
        self.cfg = cfg
        self.detector = StragglerDetector(
            threshold=cfg.threshold, warmup=cfg.warmup, alpha=cfg.alpha,
            penalty_decay=cfg.penalty_decay)
        self.shares = np.full(self.nhosts, 1.0 / self.nhosts)
        self.excluded: set = set()
        self.events: List[Dict[str, Any]] = []
        self.n_skipped = 0
        self._clean = np.zeros(self.nhosts, np.int64)
        self._consec = np.zeros(self.nhosts, np.int64)
        self._penalty = np.zeros(self.nhosts, np.float64)

    # -- loss guard ---------------------------------------------------------

    def on_bad_loss(self, step: int, loss) -> bool:
        """True when this step's loss is NaN/Inf — the trainer then skips
        the update (restoring last-good state) instead of training on
        garbage; the skip is logged as a structured event."""
        if not loss_is_bad(loss):
            return False
        self.n_skipped += 1
        # repro-lint: allow[host-sync] loss is a host scalar here (the
        # trainer calls this between steps)
        self.events.append({"kind": "skip-step", "step": int(step),
                            "loss": repr(np.asarray(loss).item()
                                         if np.asarray(loss).ndim == 0
                                         else loss)})
        return True

    # -- straggler mitigation ----------------------------------------------

    def observe(self, step: int, host_durations: Sequence[float]
                ) -> Dict[str, Any]:
        """Feed one step's per-host wall times; returns a step report
        ``{flags, shares, excluded}`` after updating the policy state.

        A host flags when it straggles *temporally* (its own EMA
        baseline, via the per-host `StragglerDetector`) **or**
        *relatively* (``threshold``x the active-host median this step) —
        the relative leg catches a host that has been slow since step 0,
        which its own baseline can never flag."""
        cfg = self.cfg
        durs = np.asarray(host_durations, np.float64)
        assert durs.shape == (self.nhosts,), (durs.shape, self.nhosts)
        uniform = 1.0 / self.nhosts
        flags = [False] * self.nhosts
        active = [h for h in range(self.nhosts) if h not in self.excluded]
        med = float(np.median(durs[active])) if active else 0.0
        for h in active:
            temporal = self.detector.observe(step, durs[h], host=h)
            relative = med > 0 and durs[h] > cfg.threshold * med
            flags[h] = bool(temporal or relative)
            if flags[h]:
                self._penalty[h] += 1.0
                self._consec[h] += 1
                self._clean[h] = 0
            else:
                self._penalty[h] *= cfg.penalty_decay
                self._consec[h] = 0
                self._clean[h] += 1
            if med <= 0:
                continue
            # proportional control, symmetric: scale the share by
            # target_ratio * med / dur each step.  Downward it shrinks a
            # hot host toward the target; upward it restores a cooled
            # host only as far as the model predicts stays under target
            # (rate-capped by restore_factor), so there is no blind
            # probe overshoot and the share settles at a fixed point.
            m = cfg.target_ratio * med / max(durs[h], 1e-12)
            if m < 1.0:
                at_floor = self.shares[h] <= cfg.min_share * 1.001
                if flags[h] and at_floor \
                        and self._consec[h] >= cfg.exclude_after:
                    self.excluded.add(h)
                    self.shares[h] = 0.0
                    self.events.append({
                        "kind": "exclude-host", "step": step, "host": h,
                        "penalty": round(float(self._penalty[h]), 3)})
                    continue
                new = max(cfg.min_share, self.shares[h] * m)
                if new < self.shares[h]:
                    self.events.append({"kind": "rebalance", "step": step,
                                        "host": h,
                                        "share": round(float(new), 5),
                                        "ratio": round(durs[h] / med, 3)})
                self.shares[h] = new
            elif (self.shares[h] < uniform * 0.999
                    and self._penalty[h] < 0.25
                    and self._clean[h] >= cfg.recover_after):
                self.shares[h] = min(uniform,
                                     self.shares[h]
                                     * min(m, cfg.restore_factor))
                if self.shares[h] >= uniform * 0.999:
                    self.detector.reset(h)
                    self.events.append({"kind": "host-recovered",
                                        "step": step, "host": h})
        total = float(self.shares.sum())
        if total > 0:
            self.shares = self.shares / total
        if (not self.excluded
                and np.all(np.abs(self.shares - uniform) < 1e-3)
                and np.all(self._penalty < 0.25)):
            # fully recovered: snap renormalization drift to exact uniform
            self.shares = np.full(self.nhosts, uniform)
        return {"step": int(step), "flags": flags,
                "shares": [round(float(s), 5) for s in self.shares],
                "excluded": sorted(self.excluded)}

    def reset(self, host: int) -> None:
        """Forgive a host entirely: re-admit it at the uniform share with
        fresh detection state (operator override / post-repair)."""
        self.excluded.discard(host)
        self.detector.reset(host)
        self._clean[host] = 0
        self._consec[host] = 0
        self._penalty[host] = 0.0
        self.shares[host] = 1.0 / self.nhosts
        self.shares = self.shares / self.shares.sum()
        self.events.append({"kind": "host-reset", "host": int(host)})
