"""Device meshes on `torch.distributed`, with the reference's axis names.

A function builds each mesh; importing this module touches no process
group.  ``"data"`` carries data parallelism and FSDP, ``"model"`` tensor
and expert parallelism, ``"pod"`` cross-pod data parallelism (and the
compressed gradient all-reduce).

The process group is NCCL on ``cuda`` and gloo on ``cpu``, built from an
explicit store with a timeout: a ``file://`` path or a ``tcp://`` address
given by the caller, the environment ``torchrun`` sets, or an in-process
`HashStore` for one rank.  Asking for NCCL without a card raises.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: how long a collective may wait for a peer before the group raises
DEFAULT_TIMEOUT_S = 120.0


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a card; pass "
                               "device_type='cpu' for a gloo mesh")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unknown mesh device type {device_type!r}")


def init_process_group(device_type: str = "cuda", *,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group: NCCL on ``cuda``, gloo on ``cpu``.

    `init_method` is a ``file://`` or ``tcp://`` URL; without one, the
    environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read, and without that a single
    rank runs on an in-process `HashStore`.  On ``cuda`` each rank takes
    the card ``LOCAL_RANK`` (default: its rank modulo the card count)."""
    backend = _backend(device_type)
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; "
                           "call destroy_process_group() first")
    timeout = timedelta(seconds=timeout_s)
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
        rank = int(rank if rank is not None else os.environ["RANK"])
        world_size = int(world_size if world_size is not None
                         else os.environ["WORLD_SIZE"])
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        kw["init_method"] = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    else:
        if world_size not in (None, 1):
            raise ValueError("more than one rank needs an init_method or "
                             "torchrun's environment")
        rank, world_size = 0, 1
        kw["store"] = dist.HashStore()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timeout, **kw)


def destroy_process_group() -> None:
    """End the default process group (and every mesh built on it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextmanager
def process_group(device_type: str = "cuda", **kw):
    """`init_process_group` for the extent of a ``with`` block; the group
    is destroyed on exit, also on an exception."""
    init_process_group(device_type, **kw)
    try:
        yield
    finally:
        destroy_process_group()


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A named mesh over the running process group (its size must be the
    product of `shape`)."""
    _backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group() "
                           "first")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The (1, 1) mesh with the production axis names, on one rank."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(f"the {'multi' if multi_pod else 'single'}-pod "
                           f"production mesh {shape} needs {want} ranks; "
                           f"the process group has {have}")
    return make_mesh(shape, names, device_type)

