"""Shared paged KV pool: int8-block-resident slab pages + cold eviction.

The continuous-batching serve layer parks every sequence's KV cache here
as *pages* — SEQ_BLOCK-aligned seq slabs in the in-memory QuantKV
payload form (``repro_torch.core.kvcache.kv_page_slice``).  Because a
page IS the ``"int8-block"`` codec payload, adopting pages back into a
decode slot is pure payload-space movement: bit-identical to the
whole-tensor adopt path, zero re-quantization, zero f32 round trip.

Three jobs live here:

* **free-list page allocator** — ``n_pages`` device pages, allocated /
  freed as integer page ids; exhaustion raises `PoolExhausted` (the
  scheduler answers with eviction or preemption).
* **per-sequence page tables** — ordered pages per sequence id, each
  resident (device slabs) or evicted (host Containers), plus
  last-touch ordering for cold-first reclaim.
* **eviction / restore** — cold pages cross to host through a wire
  codec: ``"int8-block"`` packs the payload (bit-exact restore),
  ``"cusz"``/``"fz"`` re-compress the dequantized slab (higher ratio;
  restore decodes on the pool's device — on the card, through the
  codecs' CUDA kernels — and re-quantizes under the codec's bound),
  ``"lossless"`` ships raw dequantized values.
  Codec resolution: explicit arg > the armed
  ``dist.context.use_kv_evict_codec`` hook > "cusz".

Accounting is exact by construction and asserted by the property suite:
``free + used == n_pages`` always, no page id is ever live twice, and
``used`` equals the number of resident pages across all tables.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import codecs
from repro_torch.codecs.base import input_device
from repro_torch.core import kvcache as KVC
from repro_torch.dist import context as dist_ctx

#: seq axis of every cache slab ([n_periods, B, S, ...]) — the engine's
#: handoff layout, which pages inherit
PAGE_SEQ_AXIS = 2

#: eviction codecs the pool accepts beyond blockwise-configurable ones
_WHOLE_SLAB_CODECS = KVC.WHOLE_SLAB_WIRES


class PoolExhausted(RuntimeError):
    """No free device pages; the caller must evict or preempt first."""


class _Page:
    """One page of one sequence: resident (device slabs) xor evicted
    (host containers) xor reserved (neither, content pending flush)."""

    __slots__ = ("pid", "slabs", "host")

    def __init__(self, pid: Optional[int]):
        self.pid = pid                    # device page id; None = evicted
        self.slabs: Optional[Tuple[KVC.QuantKV, ...]] = None
        self.host: Optional[Tuple[Tuple, ...]] = None

    @property
    def resident(self) -> bool:
        return self.pid is not None


def _evict_slab(slab: KVC.QuantKV, seq_axis: int, codec: str,
                source_dtype, codec_cfg: Optional[dict]) -> Tuple:
    return KVC.kv_page_encode(slab, seq_axis, codec=codec,
                              source_dtype=source_dtype,
                              codec_cfg=codec_cfg)


def _restore_slab(parts: Sequence, seq_axis: int, source_dtype,
                  device) -> KVC.QuantKV:
    if all(p.header.codec == "int8-block" for p in parts):
        return KVC.kv_page_adopt(parts, seq_axis, device=device)
    # a cusz-evicted slab may have degraded to "lossless" (validity
    # fallback in kv_page_encode); kv_wire_restore reads each part's own
    # header, then the requantize rebuilds the in-memory page
    full = KVC.kv_wire_restore(parts, seq_axis, dtype=source_dtype,
                               device=device)
    return KVC.kv_quantize(full, seq_axis, reciprocal=True)


class PagedKVPool:
    """Fixed-budget device page pool with per-sequence page tables.
    Restored pages land on `device` (default CUDA)."""

    def __init__(self, n_pages: int, *, evict_codec: Optional[str] = None,
                 evict_cfg: Optional[dict] = None,
                 source_dtype=torch.bfloat16,
                 seq_axis: int = PAGE_SEQ_AXIS, device=None):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        evict_codec = (evict_codec or dist_ctx.kv_evict_codec()
                       or "cusz")
        if evict_codec not in _WHOLE_SLAB_CODECS:
            # same arm-time validation as the context hook: a blockwise
            # id must configure, anything else fails here, not mid-evict
            codecs.get_block_codec(evict_codec, axis=seq_axis,
                                   block=KVC.SEQ_BLOCK)
        self.n_pages = int(n_pages)
        self.evict_codec = evict_codec
        self.evict_cfg = evict_cfg
        self.source_dtype = source_dtype
        self.seq_axis = seq_axis
        self.device = input_device(None, device)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: Dict[Any, List[_Page]] = {}
        self._touch: Dict[Any, int] = {}
        self._clock = 0
        # counters (monotonic unless noted)
        self.evicted_pages = 0
        self.restored_pages = 0
        self.peak_used = 0
        self.host_bytes = 0               # current, not monotonic
        self.evicted_bytes = 0            # all eviction containers

    # -- allocator ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / self.n_pages

    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.n_pages} pool pages allocated; evict or "
                f"preempt before admitting more cache blocks")
        pid = self._free.pop()
        self.peak_used = max(self.peak_used, self.used_pages)
        return pid

    def _release_pid(self, pid: int) -> None:
        assert pid not in self._free, f"double free of page {pid}"
        self._free.append(pid)

    # -- page tables --------------------------------------------------------

    def register(self, sid) -> None:
        if sid in self._tables:
            raise ValueError(f"sequence {sid!r} already registered")
        self._tables[sid] = []
        self.touch(sid)

    def release(self, sid) -> int:
        """Drop a sequence: free its resident pages, forget host copies.
        Returns the number of device pages returned to the free list."""
        freed = 0
        for page in self._tables.pop(sid):
            if page.resident:
                self._release_pid(page.pid)
                freed += 1
            elif page.host is not None:
                self.host_bytes -= _host_nbytes(page.host)
        self._touch.pop(sid, None)
        return freed

    def has(self, sid) -> bool:
        return sid in self._tables

    def sequences(self):
        return list(self._tables)

    def n_pages_of(self, sid) -> int:
        return len(self._tables[sid])

    def n_resident(self, sid) -> int:
        return sum(1 for p in self._tables[sid] if p.resident)

    def touch(self, sid) -> None:
        self._clock += 1
        self._touch[sid] = self._clock

    def append_page(self, sid,
                    slabs: Optional[Tuple[KVC.QuantKV, ...]] = None) -> int:
        """Grow a sequence by one device page (content optional: a
        running sequence reserves the page now, flushes slabs later)."""
        pid = self._alloc()
        page = _Page(pid)
        page.slabs = tuple(slabs) if slabs is not None else None
        self._tables[sid].append(page)
        self.touch(sid)
        return pid

    def write_page(self, sid, idx: int,
                   slabs: Tuple[KVC.QuantKV, ...]) -> None:
        page = self._tables[sid][idx]
        if not page.resident:
            raise ValueError(
                f"page {idx} of {sid!r} is evicted; restore before writing")
        page.slabs = tuple(slabs)
        page.host = None

    def read_pages(self, sid) -> List[Tuple[KVC.QuantKV, ...]]:
        """All page contents of a sequence (must be fully resident)."""
        out = []
        for i, page in enumerate(self._tables[sid]):
            if not page.resident or page.slabs is None:
                raise ValueError(
                    f"page {i} of {sid!r} is not resident with content; "
                    f"call ensure_resident first")
            out.append(page.slabs)
        self.touch(sid)
        return out

    # -- eviction / restore -------------------------------------------------

    def evict_page(self, sid, idx: int) -> bool:
        """Push one resident page to host through the eviction codec and
        return its device page to the free list.  Returns False when the
        page is already on host."""
        page = self._tables[sid][idx]
        if not page.resident:
            return False
        if page.slabs is None:
            raise ValueError(
                f"page {idx} of {sid!r} is reserved but unwritten; flush "
                f"the decode slot before evicting a running sequence")
        page.host = tuple(
            _evict_slab(s, self.seq_axis, self.evict_codec,
                        self.source_dtype, self.evict_cfg)
            for s in page.slabs)
        page.slabs = None
        self._release_pid(page.pid)
        page.pid = None
        self.evicted_pages += 1
        self.host_bytes += _host_nbytes(page.host)
        self.evicted_bytes += _host_nbytes(page.host)
        return True

    def evict_sequence(self, sid) -> int:
        """Evict every resident page of a sequence; returns count."""
        return sum(self.evict_page(sid, i)
                   for i in range(len(self._tables[sid])))

    def restore_page(self, sid, idx: int) -> bool:
        """Bring one evicted page back: allocate a device page and run
        the decode(+requantize) restore.  Returns False when the
        page is already resident.  Raises `PoolExhausted` when no page
        is free — the caller reclaims and retries."""
        page = self._tables[sid][idx]
        if page.resident:
            return False
        assert page.host is not None, (sid, idx)
        pid = self._alloc()
        page.slabs = tuple(
            _restore_slab(parts, self.seq_axis, self.source_dtype,
                          self.device)
            for parts in page.host)
        self.host_bytes -= _host_nbytes(page.host)
        page.host = None
        page.pid = pid
        self.restored_pages += 1
        return True

    def ensure_resident(self, sid) -> int:
        """Restore every evicted page of a sequence; returns count."""
        n = 0
        for i, page in enumerate(self._tables[sid]):
            if not page.resident:
                self.restore_page(sid, i)
                n += 1
        self.touch(sid)
        return n

    def evict_cold(self, n: int, exclude=()) -> int:
        """Reclaim up to `n` device pages by evicting pages of the
        coldest (least recently touched) non-excluded sequences first.
        Returns how many pages were actually freed."""
        exclude = set(exclude)
        freed = 0
        order = sorted((s for s in self._tables if s not in exclude),
                       key=lambda s: self._touch.get(s, 0))
        for sid in order:
            for i, page in enumerate(self._tables[sid]):
                if freed >= n:
                    return freed
                if page.resident and page.slabs is not None:
                    self.evict_page(sid, i)
                    freed += 1
        return freed

    # -- accounting ---------------------------------------------------------

    def device_pids(self):
        """Set of live device page ids across all tables (test hook)."""
        return {p.pid for t in self._tables.values()
                for p in t if p.resident}

    def stats(self) -> Dict[str, Any]:
        host_pages = sum(1 for t in self._tables.values()
                         for p in t if p.host is not None)
        return {"n_pages": self.n_pages, "used": self.used_pages,
                "free": self.free_pages, "occupancy": self.occupancy,
                "peak_used": self.peak_used, "host_pages": host_pages,
                "host_bytes": self.host_bytes,
                "evicted_bytes": self.evicted_bytes,
                "evicted_pages": self.evicted_pages,
                "restored_pages": self.restored_pages,
                "evict_codec": self.evict_codec,
                "sequences": len(self._tables)}


def _host_nbytes(host: Tuple[Tuple, ...]) -> int:
    return sum(KVC.kv_wire_nbytes(parts) for parts in host)
