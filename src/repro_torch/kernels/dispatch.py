"""Kernel dispatch: one policy decides, per pipeline stage, whether the
hand-written CUDA kernel or the plain PyTorch version runs.

Policy values:
  "auto"   the CUDA kernel for a CUDA tensor, the plain version for a CPU
           tensor (the default)
  "torch"  the plain PyTorch version on any device
  "cuda"   the CUDA kernel; raises for a CPU tensor

Resolution order (most specific wins):
  1. an explicit per-call ``impl=`` argument
  2. an active ``kernel_policy(...)`` context
  3. the caller's configured default (``CompressorConfig.kernel_impl``,
     threaded through ``pipeline_policy``)
  4. "auto"

Every stage of the three codecs (cusz, cusz-i, fz) has a CUDA kernel, so
there is no fallback:
a CUDA tensor under "auto" launches the kernel or raises.  Each
registered kernel carries a ``launches`` count that its wrapper bumps
where it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch

IMPL_CHOICES = ("auto", "torch", "cuda")


def _validate(impl: str) -> str:
    if impl not in IMPL_CHOICES:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of "
                         f"{IMPL_CHOICES}")
    return impl


# ---------------------------------------------------------------------------
# Registry: kernel name -> launch record.  Ops modules register at import.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Kernel:
    """A registered CUDA kernel and the number of times it was launched."""
    name: str
    launches: int = 0


_REGISTRY: Dict[str, Kernel] = {}


def register(name: str) -> Kernel:
    return _REGISTRY.setdefault(name, Kernel(name))


def registered() -> Dict[str, Kernel]:
    return dict(_REGISTRY)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in _REGISTRY.items()}


def reset_launches() -> None:
    for k in _REGISTRY.values():
        k.launches = 0


# ---------------------------------------------------------------------------
# Ambient policy: a thread-local stack of `kernel_policy` contexts.
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextmanager
def kernel_policy(impl: str = "auto") -> Iterator[str]:
    """Scoped policy override::

        with kernel_policy("torch"):
            blob, eb = compress(x, cfg)        # every stage plain
    """
    st = _stack()
    st.append(_validate(impl))
    try:
        yield impl
    finally:
        st.pop()


def current_policy() -> Optional[str]:
    """The innermost active `kernel_policy` impl, else None."""
    st = _stack()
    return st[-1] if st else None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def resolve(kernel: str, where, impl: Optional[str] = None) -> str:
    """Resolve a kernel name (+ optional request) to "torch" or "cuda" for
    the tensor `where` (or tensors on the device `where`).  A "cuda"
    request for a CPU tensor raises, and so does a DTensor: a kernel takes
    raw pointers, and a DTensor's are its local shard's, so encoding one
    would code a shard as if it were the whole tensor (gather it first)."""
    from torch.distributed.tensor import DTensor

    if isinstance(where, DTensor):
        raise TypeError(f"kernel {kernel!r} takes plain tensors; got a "
                        f"DTensor on {where.device_mesh} (gather it with "
                        f"full_tensor() first)")
    device = where.device if isinstance(where, torch.Tensor) else where
    if kernel not in _REGISTRY:
        raise KeyError(f"kernel {kernel!r} not registered; known: "
                       f"{sorted(_REGISTRY)}")
    if impl is None:
        impl = current_policy() or "auto"
    _validate(impl)
    on_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        impl = "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError(f"kernel {kernel!r}: impl 'cuda' needs CUDA tensors, "
                         f"got a tensor on {device}")
    return impl


# ---------------------------------------------------------------------------
# Whole-pipeline policy: the compressor resolves every stage once per call.
# ---------------------------------------------------------------------------

PIPELINE_STAGES = ("lorenzo.dualquant", "lorenzo.reverse", "histogram",
                   "encode", "deflate", "inflate", "interp.predict",
                   "interp.reconstruct", "bitshuffle.encode",
                   "bitshuffle.decode")


@dataclasses.dataclass(frozen=True)
class PipelinePolicy:
    """Frozen per-kernel dispatch decisions ("torch" | "cuda") for one
    device."""
    entries: Tuple[Tuple[str, str], ...] = ()

    def for_kernel(self, kernel: str) -> str:
        for name, impl in self.entries:
            if name == kernel:
                return impl
        raise KeyError(
            f"pipeline policy has no resolution for kernel {kernel!r} "
            f"(resolved: {[n for n, _ in self.entries]})")


def pipeline_policy(device: torch.device,
                    default_impl: Optional[str] = None) -> PipelinePolicy:
    """Resolve all pipeline stages for `device` under the ambient policy,
    falling back to `default_impl` (CompressorConfig.kernel_impl), then
    "auto"."""
    if default_impl is not None:
        _validate(default_impl)
    impl = current_policy() or default_impl
    return PipelinePolicy(entries=tuple(
        (k, resolve(k, device, impl)) for k in PIPELINE_STAGES))
