"""Continuous-batching scheduler over the paged compressed-KV pool.

Requests arrive over time; the scheduler keeps a fixed-width batch of
decode *slots* hot and refills slots the moment a sequence retires —
instead of the engine's synchronized waves, where the whole batch waits
for its slowest member.  The decode step runs every slot at its own
position (a per-slot length vector: per-row causal mask, per-row cache
write), and batch composition changes by *writing buffers* (adopting
pool pages into a slot), never by changing shapes.

Lifecycle of a request:

  admit   — prefill (B=1) under the pool-occupancy budget, slice the
            prefilled cache into SEQ_BLOCK pages (`kv_page_slice`
            payload-space — bit-identical to the whole-tensor
            path), park them in the `PagedKVPool`, adopt them into a
            free decode slot.
  decode  — every step runs all live slots through the batched step
            (per-slot cache_len, so ragged positions coexist); a slot
            crossing a SEQ_BLOCK boundary reserves its next pool page.
  retire  — on EOS or max_new: flush the slot back to its pages,
            release them, free the slot for the next admission.
  preempt — when admission needs pages the free list can't provide:
            first evict cold *parked* pages to host through the pool's
            eviction codec, then flush + evict the most recently
            admitted running sequence and requeue it at the front
            (it resumes from its pages — no re-prefill).

``run_static`` is the ablation baseline: the same machinery restricted
to wave admission (only admit when the batch is empty), which is the
engine's synchronized-batch behavior on the same pool budget.

Pool pages carry the attention leaves (GQA K and V, MLA latents); a
Mamba/SSD layer's recurrent state has no sequence axis, so it parks in a
per-sequence sidecar (`ContinuousScheduler.states`) across preemption.
A pure SSM model's pages carry no leaf at all: they still count against
the pool, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kvcache as KVC
from repro_torch.debug import guards
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.serve import engine as E
from repro_torch.serve.pool import PagedKVPool, PoolExhausted


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static knobs of one scheduler instance."""
    max_batch: int = 4               # decode slots
    pool_pages: int = 64             # device page budget (shared)
    admit_frac: float = 1.0          # admit only below this occupancy
    evict_codec: Optional[str] = None  # pool eviction codec (None=resolve)
    continuous: bool = True          # False = wave (static) admission
    eos_id: int = -1                 # -1: never fires (synthetic load)
    preempt: bool = True             # allow preemption-by-eviction


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any                      # [plen] integers (numpy or tensor)
    max_new: int
    arrival: int = 0                 # decode-step index of arrival


# ---------------------------------------------------------------------------
# the batched decode step: every slot at its own position
# ---------------------------------------------------------------------------

#: builds per (cfg, scfg, max_batch): admission and retirement churn
#: never build the batched step again (``debug.no_recompiles`` counts the
#: same builds as "batch_step")
BATCH_STEP_TRACES: Dict[Any, int] = {}


def make_batch_step(cfg: ModelConfig, scfg: E.ServeConfig):
    """One-token decode for a batch of ragged slots: one batched
    `decode_step` with a PER-SLOT cache_len vector, so each row attends
    to its own prefix and writes its own position, while retired/empty
    rows run harmlessly at len 0.  The reference runs the same rows one
    by one (`vmap` over B=1 steps); the block scales are per (batch,
    head, dim) coordinate, so the rows' cache updates are independent and
    the result is the same."""

    def batch_step(params, tokens, caches, lens, gen):
        logits, caches = M.decode_step(
            params, cfg, tokens, caches, lens,
            compute_dtype=scfg.compute_dtype,
            compressed_kv=scfg.compressed_kv)
        return E.pick_token(logits[:, -1, :], gen, scfg), caches

    return batch_step


@functools.lru_cache(maxsize=None)
def get_batch_step(cfg: ModelConfig, scfg: E.ServeConfig, max_batch: int):
    """The batched step for `(cfg, scfg, max_batch)`, built once per key,
    so every scheduler at one config (pool-size ablations included)
    shares it.  Pool knobs are not part of the key: the step never sees
    them."""
    key = (cfg, scfg, max_batch)
    BATCH_STEP_TRACES[key] = BATCH_STEP_TRACES.get(key, 0) + 1
    guards.note_build("batch_step")
    return make_batch_step(cfg, scfg)


# ---------------------------------------------------------------------------
# slot <-> pool page movement (in-place buffer writes; shapes never change)
# ---------------------------------------------------------------------------

def _leaf_paths(cfg: ModelConfig) -> List[str]:
    """Per pattern entry: "kv" | "mla" | "state" (pool pages carry the
    attn leaves; recurrent state is an unpaged per-sequence sidecar)."""
    return ["mla" if cfg.mla else "kv" if kind.startswith("attn")
            else "state" for kind in cfg.pattern]


def _attn_leaves(cfg: ModelConfig, entries) -> List[KVC.QuantKV]:
    """The K / V buffers and MLA latents of every pattern position, in
    order (the leaves a pool page carries one slab of each)."""
    out = []
    for kind, e in zip(_leaf_paths(cfg), entries):
        if kind == "kv":
            out.extend(e)
        elif kind == "mla":
            out.append(e)
    return out


def _state_entries(cfg: ModelConfig, entries) -> List[ssm_mod.MambaState]:
    return [e for kind, e in zip(_leaf_paths(cfg), entries)
            if kind == "state"]


def _adopt_slot(buf: KVC.QuantKV, page_slabs: List[KVC.QuantKV],
                slot: int, seq_axis: int) -> KVC.QuantKV:
    """Write a sequence's pages into decode-slot `slot` of a batched
    buffer ([nP, max_batch, s_max, ...]) in place.  The tail past the
    written pages is reset to the zero/SCALE_FLOOR extension pattern, so
    slot reuse never leaks a previous occupant and adoption stays
    bit-identical to the reference's.  Returns `buf`."""
    ax = seq_axis - 1                       # seq axis once the slot is picked
    q_slot, sc_slot = buf.q[:, slot], buf.scale[:, slot]
    q_slot.zero_()
    sc_slot.fill_(KVC.SCALE_FLOOR)
    if page_slabs:
        q_rows = torch.cat([s.q[:, 0] for s in page_slabs], dim=ax)
        sc_rows = torch.cat([s.scale[:, 0] for s in page_slabs], dim=ax)
        q_slot.narrow(ax, 0, q_rows.shape[ax]).copy_(q_rows)
        sc_slot.narrow(ax, 0, sc_rows.shape[ax]).copy_(sc_rows)
    return buf


def _flush_slot(buf: KVC.QuantKV, slot: int, n_pages: int,
                seq_axis: int) -> List[KVC.QuantKV]:
    """Read `n_pages` page slabs back out of decode-slot `slot` (inverse
    of `_adopt_slot`; keeps the pool batch axis of width 1).  The slabs
    are copies: the buffer goes on being written in place."""
    one = KVC.QuantKV(buf.q[:, slot:slot + 1],
                      buf.scale[:, slot:slot + 1])
    return [KVC.QuantKV(*(t.clone() for t in
                          KVC.kv_page_slice(one, seq_axis, i)))
            for i in range(n_pages)]


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class ContinuousScheduler:
    """Drives the batched decode step over a shared `PagedKVPool`, on the
    parameters' device."""

    def __init__(self, params, cfg: ModelConfig, scfg: E.ServeConfig,
                 schedcfg: SchedulerConfig, *,
                 generator: Optional[torch.Generator] = None):
        if not scfg.compressed_kv:
            raise ValueError(
                "the paged pool stores int8-block pages; build the "
                "ServeConfig with compressed_kv=True")
        if scfg.s_max % KVC.SEQ_BLOCK:
            raise ValueError(f"s_max must be a multiple of "
                             f"{KVC.SEQ_BLOCK}, got {scfg.s_max}")
        # the weights are cast to the compute dtype once per scheduler
        self.params = M.cast_params(params, scfg.compute_dtype)
        self.device = self.params["embed"].device
        self.cfg = cfg
        self.scfg = scfg
        self.schedcfg = schedcfg
        self.generator = generator
        self.pool = PagedKVPool(schedcfg.pool_pages,
                                evict_codec=schedcfg.evict_codec,
                                source_dtype=scfg.compute_dtype,
                                seq_axis=E.HANDOFF_SEQ_AXIS,
                                device=self.device)
        self.seq_axis = E.HANDOFF_SEQ_AXIS
        B = schedcfg.max_batch
        self.step_fn = get_batch_step(cfg, scfg, B)
        self.caches = M.init_caches(cfg, B, scfg.s_max,
                                    dtype=scfg.compute_dtype,
                                    compressed_kv=True, device=self.device)
        self.tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=self.device)
        self.lens = np.zeros((B,), np.int64)      # host mirror of cache_len
        # cache_len on the device: written at admission and retirement,
        # advanced in place per step where a slot is live (len > 0)
        self.lens_dev = torch.zeros((B,), dtype=torch.int64,
                                    device=self.device)
        self.slots: List[Optional[Dict[str, Any]]] = [None] * B
        self.queue: List[Request] = []
        self.finished: Dict[int, Dict[str, Any]] = {}
        #: per-sequence recurrent-state sidecar (SSM and hybrid archs):
        #: MambaState has no seq axis, so it bypasses the pool and parks
        #: per rid while the sequence is preempted
        self.states: Dict[int, List[ssm_mod.MambaState]] = {}
        #: preempted-but-not-yet-resumed progress, keyed by rid
        self._suspended: Dict[int, Dict[str, Any]] = {}
        self._admit_counter = 0
        self.n_steps = 0
        self.preemptions = 0
        self.occupancy_samples: List[float] = []

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _prefill_pages(self, req: Request):
        """Prefill one request (B=1) and slice its caches into pool page
        slabs (copies: a page owns its bytes).  Returns
        (page_slabs_per_page, states, first_token, plen)."""
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.device)[None, :]
        last, caches, plen = E.prefill(self.params, self.cfg, prompt,
                                       self.scfg)
        t0 = int(E.pick_token(last, self.generator, self.scfg)[0])  # repro-lint: allow[host-sync] admission needs the first sampled token on host to seed the slot

        leaves = _attn_leaves(self.cfg, caches.entries)
        n_pages = KVC.kv_page_count(plen)
        pages = [tuple(KVC.QuantKV(*(t.clone() for t in KVC.kv_page_slice(
            lv, self.seq_axis, i))) for lv in leaves)
            for i in range(n_pages)]
        return (pages, _state_entries(self.cfg, caches.entries), t0,
                plen)

    def _reclaim(self, need: int, protect) -> int:
        """Free >= `need` device pages: cold *parked* pages first, then
        preemption of the most recently admitted running sequence.
        Running sequences are never cold-evicted directly — their pool
        pages are reservations whose authoritative content lives in the
        decode buffers until a flush — only `_preempt` (flush first)
        takes pages away from them."""
        running = {s["rid"] for s in self.slots if s is not None}
        freed = self.pool.evict_cold(need, exclude=set(protect) | running)
        while freed < need and self.schedcfg.preempt:
            victim = self._pick_victim(protect)
            if victim is None:
                break
            freed += self._preempt(victim)
        return freed

    def _pick_victim(self, protect) -> Optional[int]:
        running = [(s["admit_order"], i)
                   for i, s in enumerate(self.slots)
                   if s is not None and s["rid"] not in protect]
        if not running:
            return None
        return max(running)[1]       # most recently admitted loses

    def _preempt(self, slot: int) -> int:
        """Flush a running sequence to its pages, evict them all, and
        requeue it at the FRONT (it resumes exactly where it stopped —
        its generated tokens and position ride in the requeued state)."""
        s = self.slots[slot]
        self._flush_to_pool(slot)
        freed = self.pool.evict_sequence(s["rid"])
        req = Request(rid=s["rid"], prompt=s["req"].prompt,
                      max_new=s["req"].max_new, arrival=s["req"].arrival)
        self.queue.insert(0, req)
        self._suspended[s["rid"]] = {
            "generated": s["generated"], "plen": s["plen"],
            "next_token": s["next_token"], "t_submit": s["t_submit"]}
        self._set_len(slot, 0)
        self.slots[slot] = None
        self.preemptions += 1
        return freed

    def _flush_to_pool(self, slot: int) -> None:
        """Write a running slot's cache content back into its reserved
        pool pages (content lives in the decode buffers while running;
        the pool holds reservations)."""
        s = self.slots[slot]
        leaves = _attn_leaves(self.cfg, self.caches.entries)
        n_pages = self.pool.n_pages_of(s["rid"])
        per_leaf = [_flush_slot(lv, slot, n_pages, self.seq_axis)
                    for lv in leaves]
        for i in range(n_pages):
            self.pool.write_page(s["rid"], i,
                                 tuple(pl[i] for pl in per_leaf))
        # copies: the decode buffers go on being written in place
        self.states[s["rid"]] = [
            ssm_mod.MambaState(*(t[:, slot:slot + 1].clone() for t in st))
            for st in _state_entries(self.cfg, self.caches.entries)]

    def _admit_into(self, slot: int, req: Request, now: int) -> bool:
        """Try to admit one request into a free slot.  Returns False if
        the pool cannot cover its pages even after reclaim."""
        sc = self.schedcfg
        suspended = self._suspended.pop(req.rid, None)
        if suspended is not None:
            # resumed preemptee: pages already exist (possibly on host)
            need = self.pool.n_pages_of(req.rid) \
                - self.pool.n_resident(req.rid)
            if need > self.pool.free_pages:
                self._reclaim(need - self.pool.free_pages, {req.rid})
            try:
                self.pool.ensure_resident(req.rid)
            except PoolExhausted:
                self._suspended[req.rid] = suspended
                self.queue.insert(0, req)
                return False
            pages = self.pool.read_pages(req.rid)
            state = self.states.get(req.rid)
            plen = suspended["plen"]
            generated = suspended["generated"]
            t_next = suspended["next_token"]
            t_submit = suspended["t_submit"]
        else:
            n_pages = KVC.kv_page_count(len(req.prompt))
            budget = int(sc.admit_frac * self.pool.n_pages)
            if self.pool.used_pages + n_pages > budget:
                need = self.pool.used_pages + n_pages - budget
                if self._reclaim(need, set()) < need \
                        and self.pool.free_pages < n_pages:
                    return False
            page_slabs, state, t_next, plen = self._prefill_pages(req)
            try:
                self.pool.register(req.rid)
                for p in page_slabs:
                    self.pool.append_page(req.rid, p)
            except PoolExhausted:
                self.pool.release(req.rid)
                return False
            pages = self.pool.read_pages(req.rid)
            generated = []
            t_submit = now
        # adopt pages into the decode buffers at `slot`
        for j, lv in enumerate(_attn_leaves(self.cfg, self.caches.entries)):
            _adopt_slot(lv, [pg[j] for pg in pages], slot, self.seq_axis)
        # prefill carries the conv tail in the compute dtype while the
        # batched buffer keeps the init_caches dtype: copy_ casts at adopt
        for full, one in zip(_state_entries(self.cfg, self.caches.entries),
                             state or ()):
            for f, o in zip(full, one):
                f[:, slot].copy_(o[:, 0])
        self.tokens[slot, 0] = int(t_next)
        self._set_len(slot, plen + len(generated))
        self.slots[slot] = {
            "rid": req.rid, "req": req, "plen": plen,
            "generated": list(generated), "next_token": int(t_next),
            "admit_order": self._next_admit_order(),
            "t_submit": t_submit}
        self.pool.touch(req.rid)
        return True

    def _set_len(self, slot: int, n: int) -> None:
        """Slot `slot`'s cache_len, on the host and on the device (a
        scalar write: a fill, not a copy)."""
        self.lens[slot] = n
        self.lens_dev[slot] = n

    def _next_admit_order(self) -> int:
        self._admit_counter += 1
        return self._admit_counter

    def _admit(self, now: int) -> None:
        sc = self.schedcfg
        if not sc.continuous and any(s is not None for s in self.slots):
            return                   # wave mode: only refill empty batch
        for slot in range(sc.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            if not self._ready(req, now):
                break                # FIFO: later arrivals wait too
            self.queue.pop(0)
            if not self._admit_into(slot, req, now):
                if self.queue and self.queue[0].rid == req.rid:
                    break            # resume path requeued it itself
                self.queue.insert(0, req)
                break

    def _ready(self, req: Request, now: int) -> bool:
        return req.arrival <= now

    # -- the decode loop ---------------------------------------------------

    def _grow_pages(self) -> None:
        """Reserve the next pool page for any slot crossing a SEQ_BLOCK
        boundary this step (before the step writes position `lens`)."""
        for slot, s in enumerate(self.slots):
            if s is None:
                continue
            need = KVC.kv_page_count(int(self.lens[slot]) + 1)
            while self.pool.n_pages_of(s["rid"]) < need:
                try:
                    self.pool.append_page(s["rid"])
                except PoolExhausted:
                    # growth may preempt a *different* running sequence
                    # (most recent admit) but never the grower itself
                    if self._reclaim(1, {s["rid"]}) < 1:
                        raise RuntimeError(
                            f"pool too small: {self.pool.n_pages} pages "
                            f"cannot hold the running batch") from None
                    self.pool.append_page(s["rid"])

    def _step(self) -> None:
        self._grow_pages()
        nt, self.caches = self.step_fn(
            self.params, self.tokens, self.caches, self.lens_dev,
            self.generator)
        self.lens_dev += self.lens_dev > 0
        self.n_steps += 1
        nt_host = nt.cpu().numpy()  # repro-lint: allow[host-sync] scheduler control flow (retire/admit) branches on the sampled tokens
        for slot, s in enumerate(self.slots):
            if s is None:
                continue
            s["generated"].append(s["next_token"])
            s["next_token"] = int(nt_host[slot])
            self.lens[slot] += 1
            self.pool.touch(s["rid"])
        self.tokens = nt[:, None].to(torch.int32)

    def _retire(self, now: int) -> None:
        sc = self.schedcfg
        for slot, s in enumerate(self.slots):
            if s is None:
                continue
            done = len(s["generated"]) >= s["req"].max_new or (
                sc.eos_id >= 0 and s["generated"]
                and s["generated"][-1] == sc.eos_id)
            if not done:
                continue
            self.finished[s["rid"]] = {
                "rid": s["rid"], "tokens": list(s["generated"]),
                "plen": s["plen"], "t_submit": s["t_submit"],
                "t_finish": now}
            self.pool.release(s["rid"])
            self.states.pop(s["rid"], None)
            self.slots[slot] = None
            self._set_len(slot, 0)

    def live(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def run(self, requests: List[Request],
            max_steps: Optional[int] = None) -> Dict[int, Dict[str, Any]]:
        """Drive the loop until every request finishes (or `max_steps`).
        Returns {rid: {tokens, plen, t_submit, t_finish}} with times in
        decode-step units."""
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(r)
        now = 0
        limit = max_steps if max_steps is not None else \
            _default_step_limit(requests, self.schedcfg)
        while (self.queue or self.live()) and now < limit:
            self._admit(now)
            if not self.live():
                # nothing running and nothing admissible yet: advance
                # time to the next arrival instead of spinning
                if self.queue and not self._ready(self.queue[0], now):
                    now += 1
                    continue
                if self.queue:
                    raise RuntimeError(
                        "pool too small: cannot admit "
                        f"request {self.queue[0].rid} into an empty batch")
                break
            self._step()
            now += 1
            self._retire(now)
            self.occupancy_samples.append(self.pool.occupancy)
        if self.queue or self.live():
            raise RuntimeError(
                f"step limit {limit} hit with {len(self.queue)} queued / "
                f"{self.live()} running sequences")
        return dict(self.finished)


def _default_step_limit(requests: List[Request],
                        sc: SchedulerConfig) -> int:
    total = sum(r.max_new for r in requests)
    last = max((r.arrival for r in requests), default=0)
    return 4 * (total + last) + 64


def run_static(params, cfg: ModelConfig, scfg: E.ServeConfig,
               schedcfg: SchedulerConfig, requests: List[Request],
               **kw) -> Tuple[Dict[int, Dict[str, Any]],
                              "ContinuousScheduler"]:
    """Wave-admission ablation: same pool, same step, admit only into an
    empty batch."""
    sc = dataclasses.replace(schedcfg, continuous=False)
    sched = ContinuousScheduler(params, cfg, scfg, sc, **kw)
    return sched.run(requests), sched


def run_continuous(params, cfg: ModelConfig, scfg: E.ServeConfig,
                   schedcfg: SchedulerConfig, requests: List[Request],
                   **kw) -> Tuple[Dict[int, Dict[str, Any]],
                                  "ContinuousScheduler"]:
    sc = dataclasses.replace(schedcfg, continuous=True)
    sched = ContinuousScheduler(params, cfg, scfg, sc, **kw)
    return sched.run(requests), sched
