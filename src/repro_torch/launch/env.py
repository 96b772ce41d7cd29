"""One runtime setup for every entry point of the port.

The counterpart of the reference's ``launch/env.py``: one importable,
testable function instead of environment strings spread over scripts:

    from repro_torch.launch import env
    env.setup_runtime(env.RuntimeConfig(nan_debug=True))

`env_overrides` is the pure core (config -> environment dict), so tests
assert on it without touching the process environment; `setup_runtime`
applies it to ``os.environ``.  Call it **before the first CUDA touch**:
the caching allocator reads ``PYTORCH_CUDA_ALLOC_CONF`` when CUDA
initialises, and ProcessGroupNCCL reads its variables when the process
group is created.  Importing this module changes nothing.

How the reference's fields map to torch 2.11 and NCCL:

* ``preallocate=False`` (the reference's "no up-front arena", the
  several-processes-per-card setting) sets ``expandable_segments:True``
  in ``PYTORCH_CUDA_ALLOC_CONF``: the caching allocator then maps
  physical memory into one growing segment per stream and unmaps freed
  pages on ``torch.cuda.empty_cache()``, so a process holds about what
  it uses.  ``PYTORCH_CUDA_ALLOC_CONF`` is one comma-separated list of
  ``key:value`` options; it is merged key by key as the reference merges
  ``XLA_FLAGS``: options this module does not manage stay verbatim, a
  managed one is replaced, no key appears twice.
* ``async_collectives`` (default on) leaves ``TORCH_NCCL_BLOCKING_WAIT``
  off: a collective's ``wait()`` returns at once and the card orders the
  NCCL stream after the compute stream, so collectives overlap compute.
  ``async_collectives=False`` sets ``TORCH_NCCL_BLOCKING_WAIT=1``: the
  host blocks in every ``wait()`` until the collective has finished.
* ``nan_debug`` arms ``torch.autograd.set_detect_anomaly(True)`` in
  `setup_runtime` (the backward raises at the op that produced a NaN,
  with the forward's stack) and sets ``TORCH_NCCL_NAN_CHECK=1``
  (ProcessGroupNCCL checks every collective's input for NaN).
* ``host_device_count`` has no torch meaning in one process: the
  reference forces N fake XLA CPU devices, while a torch run gets N
  ranks by starting N processes (``torchrun --nproc-per-node N``, gloo
  on the CPU).  `env_overrides` emits nothing for it, and
  `setup_runtime` raises if it is set.
* ``extra_xla_flags`` has no torch meaning; `env_overrides` raises if it
  is not empty (allocator options of the caller's go in
  ``PYTORCH_CUDA_ALLOC_CONF`` itself, where they are kept).

The counterpart of the reference's scrub of removed XLA flags: torch
renamed its NCCL variables to ``TORCH_NCCL_*``.  Releases read the old
un-prefixed names (``NCCL_BLOCKING_WAIT``, ``NCCL_ASYNC_ERROR_HANDLING``,
``NCCL_DESYNC_DEBUG``, ``NCCL_ENABLE_TIMING``) for a while with a
deprecation warning (2.11 still reads ``NCCL_ASYNC_ERROR_HANDLING``), so
a stale copy inherited from an old job script either overrides the
config or means nothing: `env_overrides` removes them (value ``None``)
and never emits one.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple

import torch

ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"
BLOCKING_WAIT = "TORCH_NCCL_BLOCKING_WAIT"
NAN_CHECK = "TORCH_NCCL_NAN_CHECK"

#: allocator options this module owns inside PYTORCH_CUDA_ALLOC_CONF
_MANAGED_ALLOC = ("expandable_segments",)
#: the un-prefixed names torch renamed to TORCH_NCCL_*: removed, never set
STALE_NCCL = ("NCCL_BLOCKING_WAIT", "NCCL_ASYNC_ERROR_HANDLING",
              "NCCL_DESYNC_DEBUG", "NCCL_ENABLE_TIMING")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """One runtime environment policy (the reference's fields, mapped as
    the module docstring says)."""
    host_device_count: Optional[int] = None
    async_collectives: bool = True
    nan_debug: bool = False
    preallocate: bool = True
    extra_xla_flags: Tuple[str, ...] = ()


def _alloc_options(conf: str) -> Dict[str, str]:
    """``"k1:v1,k2:v2"`` -> {k1: v1, k2: v2}, in order; a repeated key
    keeps its last value, in its last place."""
    out: Dict[str, str] = {}
    for opt in conf.split(","):
        opt = opt.strip()
        if opt:
            key, _, val = opt.partition(":")
            out.pop(key.strip(), None)
            out[key.strip()] = val.strip()
    return out


def env_overrides(cfg: RuntimeConfig,
                  base_env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, Optional[str]]:
    """The environment changes `cfg` resolves to over ``base_env``
    (default: the live ``os.environ``).  Pure: nothing is applied.
    Returns only the keys that change: a string value is set, ``None``
    removes the variable."""
    if cfg.extra_xla_flags:
        raise ValueError(f"extra_xla_flags {cfg.extra_xla_flags} have no "
                         f"meaning under torch; allocator options go in "
                         f"{ALLOC_CONF}")
    base_env = dict(os.environ) if base_env is None else base_env
    want: Dict[str, Optional[str]] = {}

    opts = {k: v for k, v in _alloc_options(base_env.get(ALLOC_CONF, ""))
            .items() if k not in _MANAGED_ALLOC}
    if not cfg.preallocate:
        opts["expandable_segments"] = "True"
    want[ALLOC_CONF] = ",".join(f"{k}:{v}" for k, v in opts.items()) \
        or None

    want[BLOCKING_WAIT] = None if cfg.async_collectives else "1"
    want[NAN_CHECK] = "1" if cfg.nan_debug else None
    for name in STALE_NCCL:
        want[name] = None
    return {k: v for k, v in want.items() if base_env.get(k) != v}


def setup_runtime(cfg: Optional[RuntimeConfig] = None, **kw
                  ) -> RuntimeConfig:
    """Apply `cfg` (or ``RuntimeConfig(**kw)``) to ``os.environ`` and arm
    anomaly detection when ``nan_debug``.  Warns, rather than silently
    misconfiguring, when CUDA is already initialised (the allocator
    options come too late) or the process group already exists (the
    NCCL options do).  Raises if ``host_device_count`` is set (no torch
    meaning; see the module docstring).  Returns the config it
    applied."""
    if cfg is None:
        cfg = RuntimeConfig(**kw)
    if cfg.host_device_count is not None:
        raise ValueError(
            f"host_device_count={cfg.host_device_count} (--host-devices) "
            "has no meaning under torch: start N ranks as N processes "
            "(torchrun --nproc-per-node N; gloo with --device cpu)")
    overrides = env_overrides(cfg)
    if ALLOC_CONF in overrides and torch.cuda.is_initialized():
        warnings.warn(
            "launch.env.setup_runtime: CUDA is already initialised; "
            f"{ALLOC_CONF} changes will not apply to this process. Call "
            "setup_runtime() before the first CUDA operation.",
            RuntimeWarning, stacklevel=2)
    if set(overrides) - {ALLOC_CONF} and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        warnings.warn(
            "launch.env.setup_runtime: the process group already exists; "
            "NCCL option changes will not apply to it.",
            RuntimeWarning, stacklevel=2)
    for k, v in overrides.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    torch.autograd.set_detect_anomaly(bool(cfg.nan_debug))
    return cfg


def add_arguments(ap) -> None:
    """Attach the shared runtime flags to an entry point's argparser."""
    ap.add_argument("--host-devices", type=int, default=None,
                    help="the reference's N fake CPU devices; no meaning "
                         "under torch (start N ranks with torchrun): any "
                         "value raises")
    ap.add_argument("--nan-debug", action="store_true",
                    help="arm torch.autograd.set_detect_anomaly and "
                         "TORCH_NCCL_NAN_CHECK")
    ap.add_argument("--no-async-collectives", action="store_true",
                    help="TORCH_NCCL_BLOCKING_WAIT=1: the host blocks in "
                         "every collective's wait()")


def from_args(args) -> RuntimeConfig:
    """The `RuntimeConfig` an `add_arguments`-extended namespace
    selects."""
    return RuntimeConfig(
        host_device_count=args.host_devices,
        nan_debug=bool(args.nan_debug),
        async_collectives=not args.no_async_collectives)
