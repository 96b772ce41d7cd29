"""Runtime sanitizers as context managers.

The counterpart of the reference's ``debug/guards.py``: three guards
that turn a debugging facility into a pass/fail scope for tests and for
``chip_smoke.py`` (the static layer is ``tools/lint``; these catch what
static analysis cannot: actual builds, actual transfers, actual syncs).

* `no_recompiles(max_compiles=N, match=...)` counts *builds* by name.
  Eager torch compiles nothing per call, so what the reference counts as
  an XLA compile is here a step or library the port builds: the serve
  step (``"step"``, `serve.engine.get_serve_step`), the continuous
  scheduler's batch step (``"batch_step"``,
  `serve.scheduler.get_batch_step`) and the CUDA kernel library
  (``"kernels"``, a build or load in `kernels._build.lib`).  Each of
  those calls `note_build` once per build; the scope raises
  `RecompileError` when more than `max_compiles` builds whose name
  matches `match` happen in it.
* `no_implicit_transfers(level)` flags a tensor made from host Python
  data (a scalar, list, tuple or ndarray through ``torch.tensor``,
  ``torch.as_tensor``, ``torch.asarray`` or ``torch.from_numpy``) and a
  copy from a CPU tensor into a CUDA tensor (``.to``, ``.cuda``,
  ``copy_``), when a `repro_torch` frame issued it.  Inside a decode loop
  either one is a pageable host-to-device copy that serialises the
  launches behind it.  On the CPU the first kind is seen as on the card.
* `host_sync_guard(allowed)` attributes every blocking read to the
  innermost `repro_torch` source frame: ``.item()``, ``.tolist()``,
  ``.numpy()`` / ``__array__``, ``.cpu()``, ``__bool__`` / ``__int__`` /
  ``__float__`` / ``__index__`` on a tensor and ``torch.cuda.synchronize``
  (on a machine with a card, reads of CPU tensors are host work and do
  not count; without one every tensor stands for a device tensor).
  A site inside a span of `allowed` (the statically waived
  ``allow[host-sync]`` statements, ``tools.lint.waived_spans``) is a hit;
  any other is a violation, raised as `HostSyncError` at scope exit.  On
  a card it also arms ``torch.cuda.set_sync_debug_mode("warn")`` and
  attributes each of its warnings the same way: that sees the syncs
  inside C++ operators (``nonzero``, ``unique``, ``masked_select``, a
  copy to pageable host memory) that no Python hook sees.

The first two kinds are seen by a ``TorchFunctionMode``, which holds for
the thread that entered the scope; ``torch.from_numpy`` and
``torch.cuda.synchronize`` are not overridable and are patched for the
scope.  Every guard restores what it changed on exit, also when the body
raises.  Reads issued by test or driver code (no `repro_torch` frame on
the stack) are ignored: the guards police the library, not the harness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import sys
import warnings
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
from torch.overrides import TorchFunctionMode


class GuardError(RuntimeError):
    """Base class for sanitizer failures."""


class RecompileError(GuardError):
    pass


class HostSyncError(GuardError):
    pass


class TransferError(GuardError):
    pass


# ---------------------------------------------------------------------------
# where a call came from
# ---------------------------------------------------------------------------

_HERE = os.path.abspath(__file__)
_PKG = f"{os.sep}repro_torch{os.sep}"
_TESTS = f"{os.sep}tests{os.sep}"


def _attribute_frame() -> Optional[Tuple[str, int]]:
    """(abs file, line) of the innermost `repro_torch` source frame of
    the calling thread, skipping this module and test files."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and _TESTS not in fn:
            path = os.path.abspath(fn)
            if path != _HERE:
                return path, f.f_lineno
        f = f.f_back
    return None


# ---------------------------------------------------------------------------
# no_recompiles
# ---------------------------------------------------------------------------

_BUILD_LISTENERS: List[Callable[[str], None]] = []


def note_build(name: str) -> None:
    """Record one build of `name` ("step", "batch_step", "kernels") with
    every `no_recompiles` scope that is open."""
    for listener in list(_BUILD_LISTENERS):
        listener(name)


@dataclasses.dataclass
class CompileLog:
    """Mutable scope state: names of what was built so far."""
    compiles: List[str] = dataclasses.field(default_factory=list)

    def count(self) -> int:
        return len(self.compiles)


@contextlib.contextmanager
def no_recompiles(max_compiles: int = 1,
                  match: Optional[str] = None) -> Iterator[CompileLog]:
    """Fail if more than `max_compiles` builds happen in scope.

    Warm up once, then assert steady state with
    ``no_recompiles(max_compiles=0)``; or cover first use with the
    default budget of 1.  `match` restricts counting to names matching
    the regex, e.g. ``match=r"^step$"`` for the serve decode step.
    """
    log = CompileLog()
    pattern = re.compile(match) if match else None

    def listener(name: str) -> None:
        if pattern is None or pattern.search(name):
            log.compiles.append(name)

    _BUILD_LISTENERS.append(listener)
    try:
        yield log
    finally:
        _BUILD_LISTENERS.remove(listener)
    if log.count() > max_compiles:
        raise RecompileError(
            f"{log.count()} build(s) inside a "
            f"no_recompiles(max_compiles={max_compiles}) scope"
            + (f" (match={match!r})" if match else "")
            + f": {log.compiles}")


# ---------------------------------------------------------------------------
# no_implicit_transfers
# ---------------------------------------------------------------------------

_FROM_HOST = {torch.tensor: "torch.tensor", torch.as_tensor:
              "torch.as_tensor", torch.asarray: "torch.asarray"}
_COPIES = {torch.Tensor.to: ".to", torch.Tensor.cuda: ".cuda",
           torch.Tensor.copy_: ".copy_"}


@dataclasses.dataclass
class TransferLog:
    """Host-to-device transfers attributed to repro_torch source lines."""
    transfers: List[str] = dataclasses.field(default_factory=list)


def _is_cpu(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cpu"


def _is_cuda(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


class _TransferMode(TorchFunctionMode):
    def __init__(self, flag: Callable[[str], None]):
        super().__init__()
        self._flag = flag

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FROM_HOST and args \
                and not isinstance(args[0], torch.Tensor):
            self._flag(f"{_FROM_HOST[func]} of host "
                       f"{type(args[0]).__name__}")
        out = func(*args, **kwargs)
        if func in _FROM_HOST or func in _COPIES:
            src = args[1] if func is torch.Tensor.copy_ else \
                (args[0] if args else None)
            if _is_cpu(src) and _is_cuda(out):
                name = _FROM_HOST.get(func) or _COPIES[func]
                self._flag(f"{name} of a CPU tensor into CUDA")
        return out


@contextlib.contextmanager
def no_implicit_transfers(level: str = "disallow") -> Iterator[TransferLog]:
    """Flag host-to-device transfers issued by repro_torch code in scope.

    Levels as the reference's: "log" records each one in the yielded
    `TransferLog`; "disallow" also raises `TransferError` at the
    offending call.  Make inputs (tensors on the device) before entering
    the scope.
    """
    if level not in ("log", "disallow"):
        raise ValueError(f"level must be 'log' or 'disallow', got {level!r}")
    log = TransferLog()

    def flag(what: str) -> None:
        site = _attribute_frame()
        if site is None:
            return
        entry = f"{site[0]}:{site[1]} {what}"
        log.transfers.append(entry)
        if level == "disallow":
            raise TransferError(f"host-to-device transfer inside a "
                                f"no_implicit_transfers scope: {entry}")

    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        flag("torch.from_numpy of host ndarray")
        return real_from_numpy(a)

    torch.from_numpy = from_numpy
    try:
        with _TransferMode(flag):
            yield log
    finally:
        torch.from_numpy = real_from_numpy


# ---------------------------------------------------------------------------
# host_sync_guard
# ---------------------------------------------------------------------------

#: {absolute file path: [(start_line, end_line, reason), ...]}
AllowedSites = Dict[str, Sequence[Tuple[int, int, str]]]

_SYNCS = {torch.Tensor.item: ".item()", torch.Tensor.tolist: ".tolist()",
          torch.Tensor.numpy: ".numpy()", torch.Tensor.__array__:
          "__array__", torch.Tensor.cpu: ".cpu()", torch.Tensor.__bool__:
          "__bool__", torch.Tensor.__int__: "__int__",
          torch.Tensor.__float__: "__float__",
          torch.Tensor.__index__: "__index__"}
_SYNC_WARNING = "synchronizing CUDA operation"


@dataclasses.dataclass
class SyncLog:
    """Syncs attributed to repro_torch source lines during the scope."""
    violations: List[str] = dataclasses.field(default_factory=list)
    allowed_hits: List[str] = dataclasses.field(default_factory=list)


def _watched(t: torch.Tensor) -> bool:
    """Whether a read of `t` counts: a tensor off the CPU, or on a
    machine without a card any tensor (CPU tensors then stand for device
    ones, as the reference's CPU arrays do)."""
    return t.device.type != "cpu" or not torch.cuda.is_available()


class _SyncMode(TorchFunctionMode):
    def __init__(self, check: Callable[[str], None]):
        super().__init__()
        self._check = check
        self.inside = 0          # >0 while a counted read runs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kind = _SYNCS.get(func)
        if kind is None or not _watched(args[0]):
            return func(*args, **(kwargs or {}))
        self._check(kind)
        self.inside += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.inside -= 1


@contextlib.contextmanager
def host_sync_guard(allowed: Optional[AllowedSites] = None,
                    *, strict: bool = True) -> Iterator[SyncLog]:
    """Intercept blocking reads issued from repro_torch code in scope.

    Reads from statement spans in `allowed` are recorded as hits; any
    other attributed read is a violation, raised as `HostSyncError` at
    scope exit when `strict`.  On a card, the sync-debug mode's warnings
    are attributed too (one read is counted once, by the hook that saw
    it first).
    """
    allowed = allowed or {}
    log = SyncLog()

    def check(kind: str) -> None:
        site = _attribute_frame()
        if site is None:
            return
        path, line = site
        for (lo, hi, reason) in allowed.get(path, ()):
            if lo <= line <= hi:
                log.allowed_hits.append(
                    f"{path}:{line} {kind} [waived: {reason}]")
                return
        log.violations.append(f"{path}:{line} {kind}")

    mode = _SyncMode(check)
    real_sync = torch.cuda.synchronize

    def synchronize(device=None):
        check("torch.cuda.synchronize")
        mode.inside += 1
        try:
            return real_sync(device)
        finally:
            mode.inside -= 1

    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
            show = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None,
                            line=None):
                if _SYNC_WARNING not in str(message):
                    return show(message, category, filename, lineno, file,
                                line)
                if not mode.inside:
                    check("sync-debug: " + str(message).split("\n")[0])

            warnings.showwarning = showwarning
            old_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, old_mode)
        torch.cuda.synchronize = synchronize
        stack.callback(setattr, torch.cuda, "synchronize", real_sync)
        stack.enter_context(mode)
        yield log
    if strict and log.violations:
        raise HostSyncError(
            "unwaived host sync(s) from repro_torch code inside a "
            f"host_sync_guard scope: {log.violations}")
