"""Run a function on N gloo ranks of the port, and a reference scenario on
8 fake XLA devices, for the `test_torch_spmd_*` files.

`run_ranks(fn, n, tmp_path, *args)` spawns n processes; each starts a gloo
group from a `FileStore` under `tmp_path` (no fixed port, so parallel
test workers never collide), with a collective timeout, runs
``fn(rank, *args)`` on one CPU thread and destroys its group.  It returns
the ranks' results in rank order.  A rank that raises, or a run past its
wall limit, kills every rank still alive (they may be blocked in a
collective) and fails with the rank's traceback.

`run_reference(script, tmp_path)` runs the reference in a subprocess with
8 fake host devices (or `devices`) and an unarmed `repro.dist.chaos`
stand-in (the checkout lacks that module); the script passes its results
back as a pickle written to the path in ``sys.argv[1]``.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import os
import pickle
import subprocess
import sys
import textwrap
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_main(fn, rank, n, store, args, q):
    try:
        import torch

        torch.set_num_threads(1)
        from repro_torch.launch import mesh as LM

        with LM.process_group("cpu", init_method=f"file://{store}",
                              rank=rank, world_size=n, timeout_s=300.0):
            out = fn(rank, *args)
        q.put((rank, True, pickle.dumps(out)))
    except BaseException:                     # noqa: BLE001 (reported)
        q.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n, tmp_path, *args, wall_s: float = 600.0):
    """``[fn(0, *args), ..., fn(n-1, *args)]`` on n gloo ranks."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, store, args, q), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + wall_s
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(results))}"
                                   f" still running after {wall_s} s")
            try:
                rank, ok, payload = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{payload}")
            results[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
    return [results[r] for r in range(n)]


_PRELUDE = """
import contextlib, os, pickle, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(devices)d"
os.environ["JAX_PLATFORMS"] = "cpu"
stub = types.ModuleType("repro.dist.chaos")
stub.current = lambda: None
stub.use_chaos = contextlib.contextmanager(lambda cfg: (yield None))
sys.modules["repro.dist.chaos"] = stub
import jax
import repro
assert jax.device_count() == %(devices)d, jax.devices()
OUT = {}
"""

_POSTLUDE = """
with open(sys.argv[1], "wb") as f:
    pickle.dump(OUT, f)
"""


def run_reference(script: str, tmp_path, timeout: float = 600.0,
                  devices: int = 8):
    """Run `script` (which fills the dict ``OUT``) on `devices` fake XLA
    devices; returns ``OUT``."""
    out = os.path.join(str(tmp_path), f"ref_{time.monotonic_ns()}.pkl")
    code = _PRELUDE % {"devices": devices} + textwrap.dedent(script) \
        + _POSTLUDE
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", code, out], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def reference_modules(**names):
    """Generator for a module-scoped fixture: the reference modules
    `names` ({attr: module}), imported with an unarmed `repro.dist.chaos`
    stand-in; every `repro*` module the import added leaves `sys.modules`
    again at teardown."""
    import importlib
    import types

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    before = set(sys.modules)
    stub = types.ModuleType("repro.dist.chaos")
    stub.current = lambda: None
    sys.modules["repro.dist.chaos"] = stub
    try:
        yield types.SimpleNamespace(**{k: importlib.import_module(v)
                                       for k, v in names.items()})
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]
                parent, _, child = name.rpartition(".")
                if parent in sys.modules:
                    sys.modules[parent].__dict__.pop(child, None)
