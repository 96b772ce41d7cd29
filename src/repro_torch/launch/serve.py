"""Serving launcher: batched prefill + decode loop, optionally split
into disaggregated prefill/decode phases with the compressed KV handoff,
or run as a continuous-batching server over the paged compressed-KV pool.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 32 \
        --compressed-kv

    # disaggregated: prefill -> Containers -> reshard -> decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --compressed-kv --disaggregate --wire-codec fz

    # continuous batching on the paged pool (implies --compressed-kv)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --continuous --requests 8 --max-batch 4 --pool-pages 32 \
        --evict-codec cusz

    # MLA + MoE, and Mamba2 (a prompt is one SSD chunk or a whole number
    # of them: 16 tokens at --reduced, 128 at full width)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --reduced --device cpu --compressed-kv
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --prompt-len 256 --compressed-kv --disaggregate

The weights are random (``--seed``), f32, computed in bf16.  Archs with
Mamba layers draw the continuous mode's prompt lengths as whole chunks.
The shared runtime flags (``--nan-debug``, ``--no-async-collectives``,
``--host-devices``) are `launch.env`'s, applied before the first CUDA
touch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import env as launch_env
from repro_torch.models import model as M
from repro_torch.models.ssm import SEG_CHUNKS
from repro_torch.serve.engine import (LAST_HANDOFF_STATS, LAST_RESHARD_STATS,
                                      ServeConfig, decode_tokens,
                                      encode_handoff, generate, prefill,
                                      reshard_caches)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # repro-lint: allow[host-sync] wall-clock fence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--compressed-kv", action="store_true")
    ap.add_argument("--kv-codec", default="int8-block",
                    help="registry id of the in-memory KV codec")
    ap.add_argument("--disaggregate", action="store_true",
                    help="run prefill and decode as separate phases with "
                         "the compressed Container handoff between them")
    ap.add_argument("--wire-codec", default="fz",
                    choices=["int8-block", "cusz", "fz", "lossless"],
                    help="prefill->decode handoff wire codec")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler on the paged "
                         "compressed-KV pool (implies --compressed-kv)")
    ap.add_argument("--requests", type=int, default=8,
                    help="[continuous] synthetic request count")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="[continuous] decode slots")
    ap.add_argument("--pool-pages", type=int, default=32,
                    help="[continuous] device page budget of the pool")
    ap.add_argument("--evict-codec", default=None,
                    choices=["int8-block", "cusz", "fz", "lossless"],
                    help="[continuous] pool eviction codec (default: the "
                         "armed dist-context hook, else cusz)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu only when asked)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and sampling")
    launch_env.add_arguments(ap)
    args = ap.parse_args(argv)

    launch_env.setup_runtime(launch_env.from_args(args))

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    dev = torch.device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    chunk = cfg.ssm.chunk if cfg.ssm is not None else 1
    n_chunks = args.prompt_len // chunk
    if chunk > 1 and args.prompt_len > chunk and (
            args.prompt_len % chunk or n_chunks % min(SEG_CHUNKS, n_chunks)):
        raise SystemExit(
            f"{cfg.name}: --prompt-len must be at most one SSD chunk "
            f"({chunk} tokens) or a whole number of them, and above "
            f"{SEG_CHUNKS} chunks a whole number of {SEG_CHUNKS}-chunk "
            f"segments")
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = M.init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (args.batch, args.prompt_len))
                              .astype(np.int32)).to(dev)
    scfg = ServeConfig(
        s_max=args.s_max,
        compressed_kv=args.compressed_kv or args.continuous,
        kv_codec=args.kv_codec, temperature=args.temperature)

    if args.continuous:
        from repro_torch.serve import scheduler as sched_mod

        def length():
            if chunk == 1 or args.prompt_len < chunk:
                return int(rng.integers(4, args.prompt_len + 1))
            return chunk * int(rng.integers(1, min(n_chunks, SEG_CHUNKS) + 1))

        reqs = [sched_mod.Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab, size=length()
                                ).astype(np.int32),
            max_new=int(rng.integers(2, args.new_tokens + 1)),
            arrival=int(rng.integers(0, max(1, args.requests // 2))))
            for i in range(args.requests)]
        schedcfg = sched_mod.SchedulerConfig(
            max_batch=args.max_batch, pool_pages=args.pool_pages,
            evict_codec=args.evict_codec)
        t0 = time.perf_counter()
        fin, sched = sched_mod.run_continuous(params, cfg, scfg, schedcfg,
                                              reqs, generator=gen)
        _sync(dev)
        dt = time.perf_counter() - t0
        total = sum(len(f["tokens"]) for f in fin.values())
        st = sched.pool.stats()
        print(f"arch={cfg.name} device={dev} continuous "
              f"requests={len(fin)} max_batch={args.max_batch} "
              f"pool_pages={args.pool_pages}")
        print(f"decode_steps={sched.n_steps} preemptions="
              f"{sched.preemptions} evicted={st['evicted_pages']} "
              f"restored={st['restored_pages']} "
              f"peak_pages={st['peak_used']} "
              f"evict_codec={st['evict_codec']}")
        print(f"generated {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s)")
        return

    t0 = time.perf_counter()
    if args.disaggregate:
        last, caches, plen = prefill(params, cfg, prompt, scfg)
        handoff = encode_handoff(caches, cfg, scfg, plen=plen,
                                 wire=args.wire_codec)
        caches = reshard_caches(handoff, cfg, scfg, device=dev)
        toks = decode_tokens(params, cfg, scfg, last, caches,
                             handoff.plen, args.new_tokens, generator=gen)
    else:
        toks = generate(params, cfg, prompt, args.new_tokens, scfg,
                        generator=gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"new={args.new_tokens} compressed_kv={scfg.compressed_kv}")
    if args.disaggregate:
        hs, rs = LAST_HANDOFF_STATS, LAST_RESHARD_STATS
        print(f"handoff wire={hs['wire']} containers={hs['containers']} "
              f"wire_bytes={hs['wire_bytes']} "
              f"raw_bf16_bytes={hs['raw_bf16_bytes']} "
              f"adopted_quantkv={rs['adopted_quantkv']} "
              f"decoded={rs['decoded']}")
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("first sequence:", toks[0].tolist())


if __name__ == "__main__":
    main()
