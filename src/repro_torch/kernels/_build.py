"""Build the CUDA sources under `repro_torch/csrc/` with nvcc into one
shared library at first use, and load it with ctypes.

Every `.cu` file compiles to its own object in parallel (one nvcc process
per source, all started together), then one nvcc call links them into
`librepro_torch_kernels.so`.  The library name carries a hash of the
sources, so an edited source rebuilds and an unchanged one is reused.
The sources expose plain C entry points (no PyTorch headers), which keeps
a build to seconds.  Each entry point launches on the stream it is given
and returns `cudaGetLastError()`; the wrappers raise on a nonzero code.

Nothing here runs at import: `lib()` builds and loads on first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argtypes: the device index first, the stream last;
# pointers and the stream as c_void_p, so ctypes never cuts a 64-bit
# address to a 32-bit int
SIGNATURES = {
    "rt_dualquant": [_I, _P, _P, _P, _I, _P, _P, _F, _I, _P],
    "rt_reverse": [_I, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    "rt_histogram": [_I, _P, _P, _LL, _I, _P],
    "rt_encode": [_I, _P, _P, _P, _P, _P, _LL, _I, _P],
    "rt_deflate": [_I, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_inflate": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                   _I, _P],
    "rt_interp_residual": [_I, _P, _P, _P, _LL, _LL, _LL, _P],
    "rt_interp_odd": [_I, _P, _P, _P, _LL, _LL, _LL, _P],
    "rt_bitshuffle_encode": [_I, _P, _P, _LL, _LL, _I, _I, _P],
    "rt_bitshuffle_decode": [_I, _P, _P, _LL, _LL, _I, _I, _P],
    "rt_huffman_tree": [_I, _P, _P, _P, _I, _P],
    "rt_huffman_codebook": [_I, _P, _P, _P, _I, _P],
    "rt_huffman_decode_table": [_I, _P, _P, _P, _P, _P, _P, _I, _P],
    "rt_huffman_tree_scratch_bytes": [_I],
    "rt_huffman_codebook_scratch_bytes": [_I],
    "rt_launch_floor": [_I, _P],
}
#: entry points that return something other than a CUDA error code
RESTYPES = {"rt_huffman_tree_scratch_bytes": _LL,
            "rt_huffman_codebook_scratch_bytes": _LL}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build did: seconds, library path, nvcc's ptxas report
build_info: Dict[str, object] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library.
    Returns its path; reuses an existing library with the same digest."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if so.exists():
        build_info.update(seconds=0.0, path=str(so), ptxas="", cached=True)
        return so
    exe = nvcc()
    t0 = time.perf_counter()
    tmp = BUILD_DIR / f"tmp_{os.getpid()}_{threading.get_ident()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        reports.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(reports))
    part = tmp / so.name
    link = subprocess.run(
        [exe, *ARCH_FLAGS, "-shared", "-o", str(part),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(part, so)                 # atomic: concurrent builders agree
    shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      ptxas="\n".join(reports), cached=False)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built or loaded on first call, which
    ``debug.no_recompiles`` counts as "kernels")."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from repro_torch.debug import guards

            guards.note_build("kernels")
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, _I)
            _lib = handle
    return _lib


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as the raw handle the C
    side takes (without building a `torch.cuda.Stream` per launch)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
