"""Where the port's train step moves data on a mesh, and which of those
moves DTensor made on its own.

Runs one train step of reduced qwen2.5-3b on a (2, 2, 2) ("pod", "data",
"model") mesh of 8 gloo processes on the CPU (none and int8 grads,
FSDP specs with the int8 weight gather), and one prefill of reduced
deepseek-v2 (MLA + MoE, the int8 all-to-all) on a (4, 2) ("data",
"model") mesh, counting every collective by the line of
`src/repro_torch` that caused it (the step's backward runs from the
`autograd.grad` call in `train/train_step.py`).  A collective under an
explicit ``redistribute`` (``constrain``, the weight gather, the MoE and
attention placements) counts as asked; one that DTensor's dispatcher
inserted because an op had no sharding rule for its inputs counts as
implicit.  Prints one JSON object per (mode, kind, site).

    PYTHONPATH=src python tools/mesh_comms.py
"""
from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


#: functional-collective ops that move no data
_BOOKKEEPING = ("wait_tensor", "_wrap_tensor_autograd")


def _site(stack):
    """The innermost frame in the port's source, as file:line."""
    for fr in reversed(stack):
        if "/repro_torch/" in fr.filename:
            path = fr.filename[fr.filename.index("repro_torch/"):]
            return f"{path}:{fr.lineno}"
    return "?"


def _rank(rank, world, store, q, arch):
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import (use_a2a_compress, use_mesh,
                                          use_param_specs)
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T

    class Sites(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in ("_c10d_functional", "c10d") \
                    and func._opname not in _BOOKKEEPING:
                stack = traceback.extract_stack()
                names = {fr.name for fr in stack}
                kind = ("implicit" if "redistribute_local_args" in names
                        and "redistribute" not in names else "asked")
                self.counts[(kind, func._opname, _site(stack))] += 1
            return func(*args, **(kwargs or {}))

    try:
        with LM.process_group("cpu", init_method=f"file://{store}",
                              rank=rank, world_size=world):
            cfg = configs.reduced(arch, n_periods=1)
            mesh = LM.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
            params = M.init_params(None, cfg, device="cpu")
            pspecs = SH.param_specs(params, mesh, fsdp=True)
            out = {}
            for mode in ("none", "int8"):
                tcfg = T.TrainConfig(grad_compress=mode, npods=2,
                                     weight_compress="int8")
                p = SH.place(params, SH.param_shardings(params, mesh,
                                                        fsdp=True))
                opt = adamw.init(p, tcfg.adamw)
                step = T.make_train_step(cfg, tcfg)
                with use_mesh(mesh), use_param_specs(pspecs):
                    toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, 0,
                                                 podded=mode != "none")
                    step(p, opt, toks)             # warm the rule caches
                    rec = Sites()
                    with rec:
                        step(p, opt, toks)
                out[f"train:{mode}"] = dict(rec.counts)
            # a prefill of the MLA + MoE arch with the int8 all-to-all
            cfg = configs.reduced("deepseek-v2-236b", n_periods=1)
            mesh = LM.make_mesh((4, 2), ("data", "model"), "cpu")
            params = M.init_params(None, cfg, device="cpu")
            p = SH.place(params, SH.param_shardings(params, mesh))
            toks = pipeline.global_batch(mesh, cfg.vocab, 8, 32, 0)
            with use_mesh(mesh), use_a2a_compress("int8-block"), \
                    torch.no_grad():
                M.forward(p, cfg, toks, collect_caches=True)
                rec = Sites()
                with rec:
                    M.forward(p, cfg, toks, collect_caches=True)
            out["prefill:deepseek"] = dict(rec.counts)
        q.put((rank, out))
    except BaseException:                      # noqa: BLE001 (reported)
        q.put((rank, traceback.format_exc()))


def main(arch: str = "qwen2.5-3b") -> None:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank, args=(r, 8, store, q, arch))
                 for r in range(8)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=600) for _ in procs)
        for p in procs:
            p.join(timeout=30)
    if not isinstance(got[0], dict):
        raise SystemExit(got[0])
    for mode, counts in got[0].items():
        for (kind, op, site), n in sorted(counts.items()):
            print(json.dumps({"mode": mode, "kind": kind, "op": op,
                              "site": site, "count": n}))


if __name__ == "__main__":
    main(*sys.argv[1:])
