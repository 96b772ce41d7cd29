"""Seeded fault injection for the training loop and the checkpoint
writer: deterministic chaos, so every recovery path is testable.

Armed with ``use_chaos(cfg)`` (``current()`` returns the active monkey,
None when disarmed), it injects:

  * **a straggler host**: per-host step times follow the simulation
    ``dur[h] = compute·share[h]·n + delay·share[h]·n`` (the delay only on
    the straggler host, inside ``[start, stop)``), so shrinking a host's
    work share genuinely shrinks its duration; ``inject_step`` really
    sleeps the modeled extra time;
  * **NaN bursts**: ``nan_burst(step)`` is True on the scheduled steps;
  * **writer faults**: ``pre_write`` raises exactly ``writer_failures``
    `TransientWriteError` (an `OSError`, so the `AsyncWriter` retries
    it), or with ``writer_fault="partial"`` ``post_write`` silently
    truncates that many shard files to 60% of their bytes;
  * **corruption**: ``post_write`` flips one byte in the second half of
    ``corrupt_shards`` shard files (caught by the container checksums at
    restore).

``from_spec`` parses the launcher's ``--chaos`` mini-language, e.g.
``"straggler:host=1,delay=0.05;writer:failures=2,kind=partial;
nan:steps=7+8;corrupt:shards=1"``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

_stack: List["ChaosMonkey"] = []

#: fraction of a shard file's bytes a "partial" write keeps
PARTIAL_KEEP = 0.6


class TransientWriteError(OSError):
    """An injected, retryable write failure."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    nhosts: int = 1
    seed: int = 0
    straggler_host: Optional[int] = None
    straggler_delay_s: float = 0.0
    straggler_start: int = 0
    straggler_stop: Optional[int] = None      # exclusive; None = forever
    writer_failures: int = 0
    writer_fault: str = "raise"               # "raise" | "partial"
    nan_steps: Tuple[int, ...] = ()
    corrupt_shards: int = 0

    def __post_init__(self):
        if self.writer_fault not in ("raise", "partial"):
            raise ValueError(f"unknown writer fault {self.writer_fault!r}; "
                             "expected 'raise' or 'partial'")


# group -> {spec key: (ChaosConfig field, parser)}
_GROUPS = {
    "straggler": {"host": ("straggler_host", int),
                  "delay": ("straggler_delay_s", float),
                  "start": ("straggler_start", int),
                  "stop": ("straggler_stop", int)},
    "writer": {"failures": ("writer_failures", int),
               "kind": ("writer_fault", str)},
    "nan": {"steps": ("nan_steps",
                      lambda v: tuple(int(s) for s in v.split("+") if s))},
    "corrupt": {"shards": ("corrupt_shards", int)},
}
# what naming a group alone arms
_GROUP_DEFAULTS = {"writer": {"writer_failures": 1},
                   "corrupt": {"corrupt_shards": 1}}


def from_spec(spec: str, seed: int = 0, nhosts: int = 1) -> ChaosConfig:
    """Parse ``group:key=value,...;group:...``.  Groups: straggler (host,
    delay, start, stop), writer (failures, kind), nan (steps, joined by
    '+'), corrupt (shards).  ``nhosts`` widens to cover the straggler
    host."""
    fields: Dict[str, Any] = {"seed": int(seed), "nhosts": int(nhosts)}
    for group in filter(None, (g.strip() for g in spec.split(";"))):
        name, _, body = group.partition(":")
        name = name.strip()
        if name not in _GROUPS:
            raise ValueError(f"unknown chaos group {name!r}; known: "
                             f"{sorted(_GROUPS)}")
        fields.update(_GROUP_DEFAULTS.get(name, {}))
        for item in filter(None, (i.strip() for i in body.split(","))):
            key, _, value = item.partition("=")
            if key.strip() not in _GROUPS[name]:
                raise ValueError(f"unknown key {key!r} in chaos group "
                                 f"{name!r}; known: {sorted(_GROUPS[name])}")
            field, parse = _GROUPS[name][key.strip()]
            fields[field] = parse(value.strip())
    if fields.get("straggler_host") is not None:
        fields["nhosts"] = max(fields["nhosts"], fields["straggler_host"] + 1)
    return ChaosConfig(**fields)


def corrupt_file(path: str, seed: int = 0) -> int:
    """Flip one byte in the second half of the file (where npz payloads
    live, past the zip headers).  Returns the byte's offset."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    pos = int(rng.integers(size // 2, size))
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return pos


class ChaosMonkey:
    """The armed injector of one `ChaosConfig`; every injection appends a
    structured event to ``events``.  The write hooks may run on the
    writer thread: their budgets are taken under a lock."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._write_budget = int(cfg.writer_failures)
        self._corrupt_budget = int(cfg.corrupt_shards)
        self._rng = np.random.default_rng(cfg.seed)

    # -- straggler ----------------------------------------------------------

    def straggler_active(self, step: int) -> bool:
        c = self.cfg
        return (c.straggler_host is not None and c.straggler_delay_s > 0
                and step >= c.straggler_start
                and (c.straggler_stop is None or step < c.straggler_stop))

    def host_step_times(self, step: int, compute_s: float,
                        shares: Optional[Sequence[float]] = None
                        ) -> np.ndarray:
        """Per-host durations of one step of `compute_s` whole-cluster
        compute: each host does its share of the work (and the straggler
        its share of the delay)."""
        n = self.cfg.nhosts
        sh = (np.full(n, 1.0 / n) if shares is None
              else np.asarray(shares, np.float64))
        durs = compute_s * sh * n
        if self.straggler_active(step):
            h = self.cfg.straggler_host
            durs[h] += self.cfg.straggler_delay_s * sh[h] * n
        return durs

    def inject_step(self, step: int, compute_s: float,
                    shares: Optional[Sequence[float]] = None
                    ) -> Tuple[float, np.ndarray]:
        """The simulated cluster's step: sleep the time it takes beyond
        the measured `compute_s`; returns (step seconds, per-host
        seconds)."""
        durs = self.host_step_times(step, compute_s, shares)
        total = float(durs.max())
        extra = total - float(compute_s)
        if extra > 0:
            time.sleep(extra)
        if self.straggler_active(step):
            self.events.append({"kind": "straggler-delay", "step": int(step),
                                "host": int(self.cfg.straggler_host),
                                "extra_s": extra})
        return total, durs

    # -- loss ---------------------------------------------------------------

    def nan_burst(self, step: int) -> bool:
        hit = int(step) in self.cfg.nan_steps
        if hit:
            self.events.append({"kind": "nan-burst", "step": int(step)})
        return hit

    # -- writer -------------------------------------------------------------

    def _take(self, budget: str) -> bool:
        with self._lock:
            if getattr(self, budget) <= 0:
                return False
            setattr(self, budget, getattr(self, budget) - 1)
            return True

    def pre_write(self, path: str) -> None:
        """Before a shard write: raise the next transient failure, if any
        is left."""
        if self.cfg.writer_fault == "raise" and self._take("_write_budget"):
            self.events.append({"kind": "transient-write-error",
                                "path": path})
            raise TransientWriteError(f"chaos: injected write failure "
                                      f"on {path}")

    def post_write(self, path: str) -> None:
        """After a shard write: truncate it (partial) or flip one byte
        (corrupt) while budget is left."""
        if self.cfg.writer_fault == "partial" \
                and self._take("_write_budget"):
            keep = int(os.path.getsize(path) * PARTIAL_KEEP)
            with open(path, "r+b") as f:
                f.truncate(keep)
            self.events.append({"kind": "partial-write", "path": path,
                                "kept_bytes": keep})
        if self._take("_corrupt_budget"):
            with self._lock:
                seed = int(self._rng.integers(2 ** 31))
            pos = corrupt_file(path, seed)
            self.events.append({"kind": "corrupt-shard", "path": path,
                                "offset": pos})


@contextmanager
def use_chaos(cfg: Optional[ChaosConfig]):
    """Arm `cfg` for the dynamic extent (yields its `ChaosMonkey`); None
    arms nothing and yields None."""
    if cfg is None:
        yield None
        return
    monkey = ChaosMonkey(cfg)
    _stack.append(monkey)
    try:
        yield monkey
    finally:
        _stack.remove(monkey)


def current() -> Optional[ChaosMonkey]:
    """The innermost armed monkey, or None."""
    return _stack[-1] if _stack else None
