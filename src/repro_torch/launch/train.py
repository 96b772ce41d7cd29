"""Training launcher.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --device cpu --steps 3 --batch 4 --seq 32

    # compressed grads / weights / moments, restart files, fault injection
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --device cpu --steps 6 --batch 4 --seq 32 \
        --grad-compress int8 --weight-compress int8 --quantized-moments \
        --checkpoint-dir /tmp/ck --checkpoint-every 2 \
        --chaos 'writer:failures=1' --mitigate

    # the production meshes, one rank per card
    torchrun --nproc-per-node 8 --nnodes 32 ... \
        -m repro_torch.launch.train --arch qwen3-32b --mesh single

``--mesh host`` (the default) starts a one-rank process group (NCCL on
the card, gloo with ``--device cpu``) and installs the reference's 1x1
``("data", "model")`` mesh and its param specs: parameters, moments and
batches are DTensors and the step is the train step's mesh branch.  On
that layout no parameter is FSDP-sharded and there is one pod, so, as in
the reference, ``--weight-compress`` quantizes no leaf (the weight-gather
hook compresses only FSDP-sharded leaves) and ``--grad-compress`` takes
the plain branch (it needs more than one pod): the losses are the
uncompressed run's.  ``--mesh single|multi`` builds the 16x16 or 2x16x16
production mesh from ``torchrun``'s environment and raises unless the
group has 256 or 512 ranks.  ``--lower-only`` runs nothing on a device:
it builds the step once under fake tensors on a fake group of 256 ranks
(512 with ``--mesh multi``) and prints the per-rank memory
(`launch.dryrun`).  The weights are random (seed 0), f32, computed in
bf16; tokens come from the synthetic bigram stream.  The shared runtime
flags (``--nan-debug``, ``--no-async-collectives``, ``--host-devices``)
are `launch.env`'s, applied before the first CUDA touch.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import chaos, fault
from repro_torch.dist import sharding as SH
from repro_torch.dist.context import use_mesh, use_param_specs
from repro_torch.launch import env as launch_env
from repro_torch.launch import mesh as LM
from repro_torch.io import checkpoint as ckpt_io
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.train.trainer import state_template

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8", "int16"])
    ap.add_argument("--weight-compress", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--quantized-moments", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--checkpoint-sync", action="store_true",
                    help="block the step loop on checkpoint writes "
                         "(default: async writer, bounded queue)")
    ap.add_argument("--checkpoint-shards", type=int, default=None,
                    help="shard files per step (default: 1, one process)")
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec, e.g. "
                         "'straggler:host=1,delay=0.05;writer:failures=2' "
                         "(see repro_torch.dist.chaos.from_spec)")
    ap.add_argument("--mitigate", action="store_true",
                    help="arm the straggler MitigationPolicy (rebalance/"
                         "exclude flagged hosts, skip NaN steps)")
    launch_env.add_arguments(ap)
    args = ap.parse_args(argv)

    launch_env.setup_runtime(launch_env.from_args(args))
    if args.lower_only:
        return _lower_only(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    with LM.process_group(args.device):
        if args.mesh == "host":
            mesh = LM.make_host_mesh(args.device)
        else:
            mesh = LM.make_production_mesh(multi_pod=args.mesh == "multi",
                                           device_type=args.device)
        _run(args, mesh)


def _lower_only(args):
    """Build the train step once under fake tensors on a fake group of
    256 ranks (512 with ``--mesh multi``) at the CLI's arch, batch,
    sequence and knobs (`launch.dryrun.run_cell`), and print its
    per-rank memory, FLOPs and collectives."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    multi = args.mesh == "multi"
    shape = ShapeSpec(f"train_{args.batch}x{args.seq}", "train", args.seq,
                      args.batch)
    tcfg = TrainConfig(
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        weight_compress=args.weight_compress, npods=2 if multi else 1,
        adamw=adamw.AdamWConfig(lr=args.lr,
                                quantized_moments=args.quantized_moments))
    rec = dryrun.run_cell(args.arch, shape.name, multi, out_dir=None,
                          cfg=cfg, shape=shape, tcfg=tcfg)
    if rec["status"] != "ok":
        raise SystemExit(f"--lower-only: {rec['error']}")
    print(f"built under fake tensors on {rec['n_chips']} ranks in "
          f"{rec['lower_s']} s; per-rank memory "
          f"{rec['memory']['per_device_total_GiB']:.4f} GiB, "
          f"{rec['flops_per_device']:.4g} FLOP, collectives "
          f"{rec['collective_counts']}")


def _run(args, mesh):
    dev = torch.device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    npods = SH.mesh_shape(mesh).get("pod", 1)
    tcfg = TrainConfig(
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        weight_compress=args.weight_compress, npods=npods,
        adamw=adamw.AdamWConfig(lr=args.lr,
                                quantized_moments=args.quantized_moments))
    podded = tcfg.grad_compress != "none" and npods > 1
    step_fn = make_train_step(cfg, tcfg)
    template = state_template(cfg, tcfg)
    pspecs = SH.param_specs(template[0], mesh)
    shardings = SH.param_shardings(template, mesh)

    start = 0
    if args.checkpoint_dir and \
            ckpt_io.latest_step(args.checkpoint_dir) is not None:
        (params, opt), start = ckpt_io.load_checkpoint(
            args.checkpoint_dir, template, shardings=shardings)
        start += 1
        print(f"resumed from step {start}")
    else:
        params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                               device=dev)
        params = SH.place(params, shardings[0])
        opt = adamw.init(params, tcfg.adamw)
    writer = None if args.checkpoint_sync or not args.checkpoint_dir \
        else ckpt_io.AsyncWriter(max_pending=1, retries=2)
    nhosts = 1
    chaos_cfg = (chaos.from_spec(args.chaos, nhosts=nhosts)
                 if args.chaos else None)
    policy = (fault.MitigationPolicy(
                  chaos_cfg.nhosts if chaos_cfg is not None else nhosts)
              if args.mitigate else None)
    try:
        with chaos.use_chaos(chaos_cfg) as monkey, use_mesh(mesh), \
                use_param_specs(pspecs):
            for step in range(start, args.steps):
                batch = pipeline.global_batch(mesh, cfg.vocab, args.batch,
                                              args.seq, step, podded=podded)
                t0 = time.perf_counter()
                loss, params, opt = step_fn(params, opt, batch)
                loss = float(loss)  # repro-lint: allow[host-sync] step-time fence
                dt = time.perf_counter() - t0
                if monkey is not None:
                    shares = policy.shares if policy is not None else None
                    dt, host_dts = monkey.inject_step(step, dt, shares)
                    if policy is not None:
                        policy.observe(step, host_dts)
                bad = ((monkey is not None and monkey.nan_burst(step))
                       or fault.loss_is_bad(loss))
                if bad and policy is not None:
                    policy.on_bad_loss(step, float("nan"))
                    print(f"step {step:5d}  skipped (bad loss)")
                    continue
                if step % 5 == 0 or step == args.steps - 1:
                    tps = args.batch * args.seq / dt
                    extra = ""
                    if policy is not None and (policy.excluded
                                               or policy.events):
                        extra = (f"  shares={[round(float(s), 3) for s in policy.shares]}"
                                 f"  excluded={sorted(policy.excluded)}")
                    print(f"step {step:5d}  loss {loss:.4f}  "
                          f"{dt * 1e3:7.1f} ms  {tps:9.0f} tok/s{extra}")
                if args.checkpoint_dir and \
                        (step + 1) % args.checkpoint_every == 0:
                    ckpt_io.save_checkpoint(
                        args.checkpoint_dir, step, (params, opt),
                        policy=ckpt_io.CheckpointPolicy(codec="cusz"),
                        nshards=args.checkpoint_shards or 1, writer=writer)
    finally:
        if writer is not None:
            writer.close()     # drain and surface any async write failure


if __name__ == "__main__":
    main()
