"""Training loop with checkpoint/restart, NaN guard and straggler watchdog,
on one device (the reference's `repro.train.trainer` without a mesh).

The state lives where it is updated: `make_train_step` writes params and
AdamW moments in place.  So the NaN guard's last good state is a host
snapshot (a device copy of the 48 GB f32 state of a 4 B-parameter model
would not fit beside it) in page-locked buffers allocated once, restored
into the live tensors bit for bit.
Checkpoints go through `io.checkpoint` with one in-flight `AsyncWriter`;
a returned save owns its bytes, so the next steps' in-place updates
cannot tear it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.codecs.base import input_device
from repro_torch.data import pipeline
from repro_torch.dist import chaos, fault
from repro_torch.io import checkpoint as ckpt_io
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaves

from .train_step import TrainConfig, make_train_step


# the NaN guard's last good state is taken after every SNAPSHOT_EVERY-th
# step, as in the reference
SNAPSHOT_EVERY = 20


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    # error-bounded restart files: per-leaf codec selection via the
    # repro_torch.codecs registry
    checkpoint_policy: ckpt_io.CheckpointPolicy = \
        ckpt_io.CheckpointPolicy(codec="cusz", eb_valrel=1e-5)
    # async write phase: the step-N encode returns, the write overlaps the
    # next steps; a save blocks only when the writer falls behind
    checkpoint_async: bool = True
    checkpoint_nshards: Optional[int] = None   # None = 1 (one process)
    # transient write failures (OSError class) retry on the writer thread
    # with exponential backoff before surfacing
    writer_retries: int = 2
    # straggler mitigation: a `fault.MitigationPolicy` rebalances work
    # shares away from flagged hosts and skips NaN losses; None keeps
    # detection only
    mitigation: Optional[fault.MitigationPolicy] = None
    log_every: int = 10


class HostSnapshot:
    """The NaN guard's last good state in host memory: one buffer per leaf
    of the train state, allocated by the first `take` and overwritten by
    every later one, so the host never holds two snapshots.  The buffers
    of device leaves are page-locked (registered with the CUDA driver at
    their exact size), so the copies run at the link's DMA rate instead
    of through pageable staging."""

    def __init__(self):
        self.buffers: Optional[List[torch.Tensor]] = None
        self._registered: List[int] = []

    def take(self, state) -> None:
        """Copy every leaf of `state` into the buffers, in tree order."""
        src = leaves(state)
        if self.buffers is None:
            self.buffers = [self._buffer(t) for t in src]
        with torch.no_grad():
            for dst, t in zip(self.buffers, src):
                dst.copy_(t)

    def restore(self, state) -> None:
        """Write the snapshot back into `state`'s tensors, in place."""
        with torch.no_grad():
            for dst, t in zip(leaves(state), self.buffers):
                dst.copy_(t)

    def close(self) -> None:
        """Unregister the page-locked buffers (before they are freed)."""
        for ptr in self._registered:
            torch.cuda.cudart().cudaHostUnregister(ptr)
        self._registered = []
        self.buffers = None

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype)
        nbytes = buf.numel() * buf.element_size()
        if t.is_cuda and nbytes:
            err = torch.cuda.cudart().cudaHostRegister(buf.data_ptr(),
                                                       nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {nbytes} bytes "
                                   f"failed with CUDA error {int(err)}")
            self._registered.append(buf.data_ptr())
        return buf


def state_template(cfg: ModelConfig, tcfg: TrainConfig):
    """The train state's structure on the meta device: a restore template
    that allocates nothing (a resume at full width holds one state)."""
    params = M.init_params(None, cfg, device="meta")
    return params, adamw.init(params, tcfg.adamw)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
                 device=None):
        """`device` defaults to CUDA (and raises without it); pass
        ``device="cpu"`` for the CPU."""
        self.cfg, self.tcfg, self.lcfg = cfg, tcfg, lcfg
        self.device = input_device(None, device)
        self.step_fn = make_train_step(cfg, tcfg)
        self.straggler = fault.StragglerDetector()
        self.history: List[Dict[str, float]] = []

    def init_state(self, gen: Optional[torch.Generator] = None):
        """Random f32 params from `gen` (default: a generator on the
        device seeded with the loop's seed) and zero AdamW moments."""
        if gen is None:
            gen = torch.Generator(self.device).manual_seed(self.lcfg.seed)
        params = M.init_params(gen, self.cfg, device=self.device)
        return params, adamw.init(params, self.tcfg.adamw)

    def run(self) -> List[Dict[str, float]]:
        lc = self.lcfg
        start = 0
        if lc.checkpoint_dir and \
                ckpt_io.latest_step(lc.checkpoint_dir) is not None:
            (params, opt), start = ckpt_io.load_checkpoint(
                lc.checkpoint_dir, state_template(self.cfg, self.tcfg),
                device=self.device)
            start += 1
        else:
            params, opt = self.init_state()
        snapshot = HostSnapshot()
        # one in-flight write: a save while the writer still streams the
        # previous step blocks the loop instead of queueing snapshots
        writer = (ckpt_io.AsyncWriter(max_pending=1,
                                      retries=lc.writer_retries)
                  if lc.checkpoint_async and lc.checkpoint_dir else None)
        monkey = chaos.current()
        policy = lc.mitigation
        try:
            for step in range(start, lc.steps):
                toks = torch.from_numpy(pipeline.host_batch(
                    self.cfg.vocab, lc.batch, lc.seq, step, lc.seed)
                ).to(self.device)
                t0 = time.perf_counter()
                loss, params, opt = self.step_fn(params, opt, toks)
                loss = float(loss)  # repro-lint: allow[host-sync] straggler timer fence
                dt = time.perf_counter() - t0
                if monkey is not None:
                    # armed chaos: the step time becomes the simulated
                    # cluster's (real sleep); per-host times feed the
                    # mitigation policy
                    shares = policy.shares if policy is not None else None
                    dt, host_dts = monkey.inject_step(step, dt, shares)
                    if policy is not None:
                        policy.observe(step, host_dts)
                slow = self.straggler.observe(step, dt)
                loss_val = (float("nan")
                            if monkey is not None and monkey.nan_burst(step)
                            else loss)
                bad = (policy.on_bad_loss(step, loss_val)
                       if policy is not None else fault.loss_is_bad(loss_val))
                if bad:
                    # NaN guard: restore the last good state, skip the data
                    if snapshot.buffers is not None:
                        snapshot.restore((params, opt))
                    continue
                self.history.append({"step": step, "loss": loss,
                                     "dt": dt, "slow": bool(slow),
                                     "n_flagged": self.straggler.n_flagged})
                if step % SNAPSHOT_EVERY == 0:
                    snapshot.take((params, opt))
                if lc.checkpoint_dir and \
                        (step + 1) % lc.checkpoint_every == 0:
                    # async: returns after the encode (raw leaves
                    # snapshotted); the write streams under the next steps
                    ckpt_io.save_checkpoint(
                        lc.checkpoint_dir, step, (params, opt),
                        policy=lc.checkpoint_policy,
                        nshards=lc.checkpoint_nshards or 1, writer=writer)
        finally:
            # drain and stop the worker, surfacing any write failure
            if writer is not None:
                writer.close()
            snapshot.close()
        return self.history
