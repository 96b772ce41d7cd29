"""The production dry run: every (arch x shape x single/multi-pod) cell
built on a fake process group of 256 / 512 ranks, one JSON record each.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
        --shape decode_32k --device cpu

The reference's `repro.launch.dryrun`, which lowers and compiles each
cell's jitted step for 256 / 512 fake XLA devices.  Torch has no
compile-only path, so the port runs the cell's function once under
`FakeTensorMode` (tensors with shapes, dtypes and placements and no
data) on the production mesh (`launch.mesh.make_production_mesh`) over a
"fake" process group (collectives that move nothing), rank 0's view:

  * train_*   the train step (`train.train_step.make_train_step`) on the
              cell's `TrainConfig` (the reference's `ARCH_TRAIN` knobs),
              parameters placed FSDP, AdamW moments as `adamw.init`
              places them, tokens (and modality inputs) by rows;
  * prefill_* the forward with caches collected, the last position's
              logits placed ``(dp, "model")`` and the caches by the decode
              cache rule (`sharding.cache_spec`);
  * decode_* / long_*  one `models.model.mesh_decode_step` on caches of
              the shape's length placed by that rule (for ``long_*`` the
              sequence over "data").

The record keeps the reference's keys where torch can fill them:
``status`` (ok / skipped by `applicable` / error), ``meta`` (the
`TrainConfig`), ``n_chips``, ``lower_s`` (seconds to build the inputs and
run the cell under fake tensors; ``compile_s`` is None), the per-rank
peak of live bytes, FLOPs and unfused bytes per rank counted over the
local operations, collectives by op from `CommDebugMode` with
the bytes of each collective's output, the roofline terms on H100
constants, ``model_flops_global`` and ``useful_flops_ratio``.  The fake
group runs on the CPU device type: placements, shapes and counts do not
depend on the device.  Records are cached per cell under ``--out``
(``--force`` rebuilds).  ``--save-hlo`` has no torch counterpart: the flag
is accepted and the record says ``hlo_path: null``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.dist import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim import adamw
# one NVIDIA H100 SXM's rates, from their one source
from repro_torch.perf.costmodel import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves, leaves_with_path, tree_map

#: dry-run knobs per arch (microbatching / quantized moments / accum dtype)
ARCH_TRAIN = {
    "mamba2-1.3b": dict(microbatches=2),
    "moonshot-v1-16b-a3b": dict(microbatches=8),
    "deepseek-v2-236b": dict(microbatches=16, quant_moments=True),
    "jamba-1.5-large-398b": dict(microbatches=16, quant_moments=True,
                                 accum_bf16=True),
    "phi-3-vision-4.2b": dict(microbatches=4),
    "qwen3-32b": dict(microbatches=16),
    "qwen3-4b": dict(microbatches=4),
    "granite-34b": dict(microbatches=16),
    "qwen2.5-3b": dict(microbatches=4),
    "musicgen-medium": dict(microbatches=2),
}

_HLO_NOTE = "torch lowers nothing: there is no HLO to save"


class Cell(NamedTuple):
    """One cell's function and its inputs as meta tensors (shapes and
    dtypes only), with the spec of every input and output."""
    kind: str                 # "train" | "prefill" | "decode"
    cfg: Any
    tcfg: Optional[TrainConfig]
    args: dict                # name -> tree of meta tensors
    in_specs: dict            # name -> tree of `P`
    out_specs: dict           # name -> tree of `P`
    donate: tuple             # names of donated (updated in place) args
    meta: dict


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _extra_specs(cfg, B, S):
    extra = {}
    if cfg.n_prepend_embeds:
        extra["patch_embeds"] = _meta((B, cfg.n_prepend_embeds,
                                       cfg.d_model), torch.bfloat16)
    if cfg.add_frame_embeds:
        extra["frame_embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    return extra or None


def _vocab_spec(cfg, mesh) -> Optional[str]:
    return "model" if cfg.vocab % SH.mesh_shape(mesh)["model"] == 0 \
        else None


def input_specs(arch: str, shape_name: str, mesh, grad_compress="none",
                weight_compress="none", microbatch_override=None,
                kv_compress=False, a2a_compress="none", cfg=None,
                shape=None, tcfg=None) -> Cell:
    """The cell (the reference's `input_specs`): `mesh` is a DeviceMesh
    or any object whose ``.shape`` maps axis names to sizes.  `cfg`
    overrides ``configs.get(arch)`` (a reduced or depth-cut config),
    `shape` ``SHAPES[shape_name]`` and, for a train cell, `tcfg` the
    `TrainConfig` of the `ARCH_TRAIN` knobs (``launch.train
    --lower-only`` builds the CLI's own)."""
    cfg = cfg if cfg is not None else configs.get(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    sizes = SH.mesh_shape(mesh)
    multi = "pod" in sizes
    dp = SH.dp_axes(mesh)
    knobs = ARCH_TRAIN.get(arch, {})
    params = M.init_params(None, cfg, device="meta")
    pspecs = SH.param_specs(params, mesh, fsdp=True)
    B, S = shape.global_batch, shape.seq_len
    vshard = _vocab_spec(cfg, mesh)

    if shape.kind == "train":
        nmb = microbatch_override or knobs.get("microbatches", 1)
        if multi:
            nmb = min(nmb, 8)
        tcfg = tcfg or TrainConfig(
            microbatches=nmb,
            grad_compress=grad_compress if multi else "none",
            weight_compress=weight_compress,
            a2a_compress=a2a_compress,
            npods=sizes.get("pod", 1),
            accum_dtype=(torch.bfloat16 if knobs.get("accum_bf16")
                         else torch.float32),
            adamw=adamw.AdamWConfig(
                quantized_moments=knobs.get("quant_moments", False)))
        opt = adamw.init(params, tcfg.adamw)
        ospecs = SH.param_specs(opt, mesh, fsdp=True)
        podded = tcfg.grad_compress != "none" and tcfg.npods > 1
        if podded:
            toks = _meta((tcfg.npods, B // tcfg.npods, S), torch.int32)
            extra = _extra_specs(cfg, B // tcfg.npods, S)
            if extra:
                extra = tree_map(lambda t: _meta((tcfg.npods,) + t.shape,
                                                 t.dtype), extra)
            espec = SH.P("pod", "data", None, None)
        else:
            toks = _meta((B, S), torch.int32)
            extra = _extra_specs(cfg, B, S)
            espec = SH.P(dp, None, None)
        args = {"params": params, "opt_state": opt, "tokens": toks}
        in_specs = {"params": pspecs, "opt_state": ospecs,
                    "tokens": SH.batch_spec(mesh, podded)}
        if extra:
            args["extra"] = extra
            in_specs["extra"] = tree_map(lambda _: espec, extra)
        out_specs = {"loss": SH.P(), "params": pspecs, "opt_state": ospecs}
        return Cell("train", cfg, tcfg, args, in_specs, out_specs,
                    ("params", "opt_state"), {"tcfg": str(tcfg)})

    if shape.kind == "prefill":
        extra = _extra_specs(cfg, B, S)
        args = {"params": params, "tokens": _meta((B, S), torch.int32)}
        in_specs = {"params": pspecs, "tokens": SH.P(dp, None)}
        if extra:
            args["extra"] = extra
            in_specs["extra"] = tree_map(lambda _: SH.P(dp, None, None),
                                         extra)
        S_total = S + cfg.n_prepend_embeds
        caches = M.init_caches(cfg, B, S_total, torch.bfloat16,
                               device="meta")
        out_specs = {"logits": SH.P(dp, vshard),
                     "caches": SH.cache_specs(caches, mesh)}
        return Cell("prefill", cfg, None, args, in_specs, out_specs, (),
                    {})

    long_ctx = shape_name.startswith("long")
    caches = M.init_caches(cfg, B, S, torch.bfloat16, kv_compress,
                           device="meta")
    cspecs = SH.cache_specs(caches, mesh, long_ctx)
    rows = dp if not long_ctx else None
    args = {"params": params, "token": _meta((B, 1), torch.int32),
            "caches": caches, "cache_len": _meta((), torch.int32)}
    in_specs = {"params": pspecs, "token": SH.P(rows, None),
                "caches": cspecs, "cache_len": SH.P()}
    out_specs = {"logits": SH.P(rows, None, vshard), "caches": cspecs}
    return Cell("decode", cfg, None, args, in_specs, out_specs,
                ("caches",), {"long_ctx": long_ctx})


def model_flops(arch: str, shape_name: str, cfg=None, shape=None) -> float:
    """6·N(_active)·D — the 'useful' FLOPs yardstick for the roofline."""
    cfg = cfg if cfg is not None else configs.get(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token/slot


# ---------------------------------------------------------------------------
# counting on the fake group
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


#: operations that allocate or alias and move no data
_NO_TRAFFIC = frozenset({torch.ops.aten._unsafe_view,
                         torch.ops.aten.empty, torch.ops.aten.empty_strided,
                         torch.ops.aten.empty_like})


def _device_counter():
    """A dispatch mode counting each rank's FLOPs (torch's flop formulas),
    unfused bytes (every aten operation that moves data reads its inputs
    and writes its outputs) and live bytes over the local operations: a
    DTensor operation is let through to run as the local operations it
    becomes.

    Live bytes follow each storage from the operation that makes it to
    its release; `track` adds the inputs.  DTensor's sharding
    propagation runs the operation on global-shape fake tensors through
    the same modes: those calls count nothing.  (`MemTracker` counts
    them: 2.2 GiB for casting 31 MiB of qwen3-4b's shards.)"""
    import sys
    import weakref

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.registry = FlopCounterMode(display=False).flop_registry
            self.flops = 0
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self._sizes = {}

        def track(self, tree):
            for t in tree_flatten(tree)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in self._sizes:
                    continue
                self._sizes[key] = st.nbytes()
                self.live += self._sizes[key]
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._release, key)

        def _release(self, key):
            self.live -= self._sizes.pop(key, 0)

        @staticmethod
        def _propagating() -> bool:
            f = sys._getframe(2)
            while f is not None:
                if "sharding_prop" in f.f_code.co_filename:
                    return True
                f = f.f_back
            return False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            packet = func._overloadpacket
            if packet not in self.registry and func.namespace == "aten":
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if self._propagating():
                return out
            if packet in self.registry:
                self.flops += int(self.registry[packet](
                    *args, **kwargs, out_val=out))
            if getattr(func, "is_view", False):
                return out
            self.track(out)
            if func.namespace == "aten" and packet not in _NO_TRAFFIC:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out

    return Counter()


def _collective_counter():
    """`CommDebugMode` that also sums the bytes of each collective's
    output, by the op name its counts use."""
    from torch.distributed.tensor.debug import CommDebugMode

    class Collectives(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes_by_op: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.comm_counts)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            for op, n in self.comm_counts.items():
                if n != before.get(op, 0):
                    key = str(op)
                    self.bytes_by_op[key] = self.bytes_by_op.get(key, 0) \
                        + _nbytes(out)
            return out

    return Collectives()


@contextlib.contextmanager
def fake_world(n: int):
    """A "fake" default process group of `n` ranks (this process is rank
    0) for the extent of the block; one that already runs at `n` ranks
    is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is running; the dry run needs {n}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _materialize(tree, specs, mesh):
    """Fake tensors of the meta `tree`'s shapes and dtypes, placed on
    `mesh` by `specs` (each rank's shard only)."""
    def one(t, spec):
        z = torch.zeros(t.shape, dtype=t.dtype)
        return SH.NamedSharding(mesh, spec).place(z) if t.dim() else z
    return tree_map(one, tree, specs)


def _specs_of(tree):
    return tree_map(SH.spec_of, tree)


def _prefill(cell: Cell, mesh, params, tokens, extra=None):
    """The prefill cell: the forward with caches collected, the last
    position's logits and the caches placed as the reference pins them."""
    from torch.distributed.tensor import Shard

    from repro_torch.serve.engine import place_caches

    cfg = cell.cfg
    with torch.no_grad():
        params = M.cast_params(params, torch.bfloat16)
        hidden, caches = M.forward(params, cfg, tokens, extra,
                                   collect_caches=True, return_hidden=True)
        rows = [isinstance(p, Shard) for p in hidden.placements]
        logits = M.mesh_logits(params, cfg, hidden.to_local()[:, -1, :],
                               rows, torch.bfloat16)
        caches = place_caches(M.DecodeCaches(caches), mesh)
    return {"logits": logits, "caches": caches}


def _inputs(cell: Cell, mesh) -> dict:
    """The cell's inputs as fake tensors placed by its specs, the AdamW
    state as `adamw.init` places it."""
    from repro_torch.dist.context import use_mesh

    a = {k: _materialize(v, cell.in_specs[k], mesh)
         for k, v in cell.args.items() if k != "opt_state"}
    if cell.kind == "train":
        with use_mesh(mesh):
            a["opt_state"] = adamw.init(a["params"], cell.tcfg.adamw)
    return a


def _run(cell: Cell, mesh, a: dict) -> dict:
    """The cell's function on its inputs `a`; returns its outputs by
    name."""
    from repro_torch.dist.context import use_mesh, use_param_specs

    with use_mesh(mesh), use_param_specs(cell.in_specs["params"]):
        if cell.kind == "train":
            step = make_train_step(cell.cfg, cell.tcfg)
            loss, params, opt = step(a["params"], a["opt_state"],
                                     a["tokens"], a.get("extra"))
            return {"loss": loss, "params": params, "opt_state": opt}
        if cell.kind == "prefill":
            return _prefill(cell, mesh, a["params"], a["tokens"],
                            a.get("extra"))
        with torch.no_grad():
            logits, caches = M.decode_step(
                a["params"], cell.cfg, a["token"], a["caches"],
                a["cache_len"])
        return {"logits": logits, "caches": caches}


def _spec_list(tree, prefix: str):
    return [(prefix + "/" + "/".join(str(k) for k in path), str(spec))
            for path, spec in leaves_with_path(tree)]


def build_cell(cell: Cell, mesh):
    """Run `cell` once on `mesh` (the fake group) under the counters, its
    inputs made before them (they count in the memory as the shards each
    rank holds).  Returns (outputs, per-rank peak bytes, FLOPs, unfused
    bytes, the collective counter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    with FakeTensorMode(allow_non_fake_inputs=True):
        a = _inputs(cell, mesh)
        comm, dev = _collective_counter(), _device_counter()
        dev.track([t.to_local() if isinstance(t, DTensor) else t
                   for t in leaves(a)])
        with comm, dev:
            out = _run(cell, mesh, a)
        del a
    return out, dev.peak, dev.flops, dev.bytes, comm


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             grad_compress: str = "none", out_dir: str = "results/dryrun",
             force: bool = False, save_hlo: bool = False,
             weight_compress: str = "none", microbatch_override=None,
             kv_compress: bool = False, a2a_compress: str = "none",
             cfg=None, shape=None, tcfg=None):
    """Build one cell on a fake group of 256 (512 multi-pod) ranks and
    write its record to ``<out_dir>/<tag>.json`` (a cached record is
    returned unless `force`; no file with `out_dir` None).  `cfg`,
    `shape` and `tcfg` override the arch's config, the named shape and
    the train knobs (`input_specs`)."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh_tag = "multipod" if multi_pod else "singlepod"
    tag = f"{arch}__{shape_name}__{mesh_tag}" + (
        f"__gc-{grad_compress}" if grad_compress != "none" else "") + (
        f"__wc-{weight_compress}" if weight_compress != "none" else "") + (
        f"__mb{microbatch_override}" if microbatch_override else "") + (
        "__kvc" if kv_compress else "") + (
        f"__a2a-{a2a_compress}" if a2a_compress != "none" else "")
    path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, tag + ".json")
    if path is not None and os.path.exists(path) and not force:
        print(f"[skip cached] {tag}")
        with open(path) as f:
            return json.load(f)
    cfg = cfg if cfg is not None else configs.get(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    if not applicable(shape, cfg):
        rec = {"cell": tag, "status": "skipped",
               "reason": "long_500k needs sub-quadratic sequence handling"}
        _write(path, rec)
        print(f"[skip n/a] {tag}")
        return rec

    t0 = time.time()
    rec = {"cell": tag, "arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "grad_compress": grad_compress, "torch": torch.__version__}
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            cell = input_specs(arch, shape_name, mesh, grad_compress,
                               weight_compress, microbatch_override,
                               kv_compress, a2a_compress, cfg=cfg,
                               shape=shape, tcfg=tcfg)
            out, peak, flops_dev, bytes_dev, comm = build_cell(cell, mesh)
            placed = {k: _spec_list(_specs_of(v), k) for k, v in out.items()}
            nchips = int(mesh.size())
        t_lower = time.time() - t0
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        cbytes = sum(comm.bytes_by_op.values())
        mf = model_flops(arch, shape_name, cfg, shape)
        terms = {"compute_s": flops_dev / PEAK_FLOPS,
                 "memory_s": bytes_dev / HBM_BW,
                 "collective_s": cbytes / NVLINK_BW}
        dominant = max(terms, key=terms.get)
        rec.update(
            status="ok", meta=cell.meta, n_chips=nchips,
            lower_s=round(t_lower, 1), compile_s=None,
            memory=dict(per_device_total_GiB=peak / 2**30),
            flops_per_device=float(flops_dev),
            hbm_bytes_per_device=float(bytes_dev),
            collective_bytes_per_device=float(cbytes),
            collective_by_op=dict(sorted(comm.bytes_by_op.items())),
            collective_counts=counts,
            roofline=dict(terms, dominant=dominant,
                          bound_s=max(terms.values()),
                          constants=dict(peak_flops=PEAK_FLOPS,
                                         hbm_bw=HBM_BW,
                                         nvlink_bw=NVLINK_BW)),
            model_flops_global=mf,
            useful_flops_ratio=(mf / (flops_dev * nchips)
                                if flops_dev else None),
            output_specs=placed,
        )
        if save_hlo:
            rec.update(hlo_path=None, hlo_note=_HLO_NOTE)
        print(f"[ok] {tag}  build={t_lower:.0f}s  "
              f"dom={dominant}({terms[dominant]*1e3:.1f}ms)  "
              f"mem={rec['memory']['per_device_total_GiB']:.2f}GiB/dev")
    except Exception as e:                        # noqa: BLE001 (recorded)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
    _write(path, rec)
    return rec


def _write(path, rec) -> None:
    if path is not None:
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=[*SHAPES], help="shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8", "int16"])
    ap.add_argument("--weight-compress", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--kv-compress", action="store_true")
    ap.add_argument("--a2a-compress", default="none", choices=["none", "int8"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="accepted for the reference's CLI; " + _HLO_NOTE)
    ap.add_argument("--device", default="cpu", choices=["cpu"],
                    help="the fake group's device type (the cells run "
                         "under fake tensors on the host)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else sorted(configs.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    ok = True
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, args.mesh == "multi", args.grad_compress,
                           args.out, args.force, args.save_hlo,
                           args.weight_compress, args.microbatches,
                           args.kv_compress, args.a2a_compress)
            ok &= rec.get("status") in ("ok", "skipped")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
