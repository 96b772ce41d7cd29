#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card: its
three codecs (cusz, cusz-i, fz) with every CUDA kernel of their paths
held against its plain PyTorch version, their consumers, the serving
path of three model families: dense (qwen3-4b), MLA + MoE
(deepseek-v2-236b, 2 layers) and Mamba2/SSD (mamba2-1.3b), the
training path (qwen3-4b) with its cusz restart files, the device mesh
on a one-rank NCCL group, and the production dry run on a fake group of
256 ranks.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env       card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc builds the ten kernels for sm_90a; seconds and the
            ptxas register / shared-memory report
  kernel:*  each kernel at the main path's shapes on a NYX-like 512^3
            field, compared exactly with its plain version on the card;
            kernel, plain and (where one PyTorch call computes the same
            function) library times from CUDA events.  Also: the share
            of inflate steps that take the long-code path, inflate on a
            max_len-32 stream, lorenzo.dualquant and lorenzo.reverse on
            the same bytes as (256) and (16,16) blocks, dual-quant's
            generic kernel and bitshuffle.encode on unaligned copies,
            bitshuffle.encode and .decode at chunk 32 (W = 1) and at
            P = 16 (nbins 65536), and the interpolation kernels,
            untimed, on HACC's first level (one row of 140,476,933
            values)
  yardstick:copy  `copy_` of the NYX codes (4 B read and 4 B written per
            symbol): the rate the card reaches on read+write traffic
  golden    the committed cusz v2 fixture re-encoded on the card, byte for
            byte
  quality   the six small scidata fields under each codec, configured as
            benchmarks/quality.py configures it: ratios equal the
            reference's BENCH_quality.json rows, error bound held
  main:*    per codec, encode -> device-form decode -> pack -> packed
            decode at the paper's Table 2 sizes (HACC 1-D 280,953,867,
            CESM 1800x3600, NYX 512^3) at eb=1e-4 valrel; the launch
            counts are set to 0 before each codec's path and read after
            it ("main:<field>" and "main:launches" are cusz's,
            "main:cusz-i:<field>", "main:fz:<field>" the others')
  v1        cusz's NYX 512^3 container with its gap arrays stripped
            (format v1) decoded in device and packed form by the
            sequential decoder, bit-identical to the gap-array decode
  codecs:*  a qwen3-4b MLP weight ([2560, 9728] f32, numpy from --seed)
            through every registry id: encode, pack, packed and
            device-form decode, each codec's bound
  kv:*      the prefill -> decode handoff K tensor of one 32k-token
            sequence at qwen3-4b's width and depth ([36, 1, 32768, 8,
            128] bf16) over the four wires at 256 slabs, then 4 pages
            evicted and adopted on the int8-block wire
  checkpoint  qwen3-4b's tied embedding plus one decoder block (490 M
            f32 values, numpy from --seed) saved at 4 shards through an
            AsyncWriter and loaded on the card
  serve:*   the serving path at qwen3-4b's published width and depth
            (36 layers, 4.02 B random f32 weights from --seed, cast once
            to bf16): `serve:generate` (4 prompts of 512 tokens, s_max
            1024, int8-block QuantKV, 16 greedy tokens; prefill seconds,
            decode tokens/s, peak memory, a torch.profiler window of 2
            decode steps), `serve:disagg:<wire>` (prefill ->
            encode_handoff -> reshard_caches -> decode_tokens over
            int8-block, cusz, fz, lossless: wire bytes, ratio, seconds,
            launches; int8-block adopted bit for bit with generate's
            tokens, cusz / fz within their bound, and the K tensor's
            containers made again by the kernels' plain versions on the
            same card tensor, byte for byte, with equal restores) and
            `serve:continuous:*` (8 requests of 130-600 tokens on 4
            slots: cusz eviction of the first 4 on an 8-page pool, which
            must preempt, with one evicted page encoded and restored
            again by the plain versions; then int8-block on the 8- and
            the 32-page pool for all 8, whose tokens must agree)
  serve:deepseek:*  the same phases at deepseek-v2-236b's published
            widths (d_model 5120, 128 heads, MLA q_lora 1536 / kv_lora
            512 / rope 64, 160 routed experts top-6 of d_ff 1536 plus 2
            shared, vocab 102400) with the depth cut to 2 layers (9.0 B
            random f32 weights, cast once to bf16): `generate` also
            counts the prefill's assignments dropped over capacity; the
            handoff carries the MLA latent [2, 4, 1024, 576] on the four
            wires (cusz / fz containers again by the plain versions);
            the continuous runs take the qwen3-4b phase's requests and
            pools and must give its schedule
  serve:mamba2:*  mamba2-1.3b at its published width and depth (48
            layers, 1.35 B weights): `generate`, one handoff (the state
            [48, 4, 64, 128, 64] f32 and its conv tail cross lossless,
            bit for bit) and the scheduler on 3 prompts of 256 / 384 /
            512 tokens with the state sidecar, on an 8-page pool that
            preempts against a 32-page one: equal tokens, the rehearsed
            schedule
  train:step  `Trainer.run` at qwen3-4b's published width and depth (36
            layers, 4.02 B f32 master weights from --seed, AdamW with f32
            moments, bf16 compute): 4 steps of 4 x 512 bigram tokens;
            seconds per step, tokens/s, losses (the last below the
            first), peak memory, the NaN guard's host snapshots after
            steps 0 and 2 (the first allocates and page-locks the
            buffers, the second reuses them) with the host's peak
            resident memory, a device-only profiler window over the
            last step
  train:compress  qwen3-4b's width, depth cut to 2 layers: 3 steps of
            `make_train_step` with int8 pod-compressed grads (2 pods, the
            batch as [2, 2, 512]), the int8 weight STE, 2 microbatches
            and int8 AdamW moments; the pod mean of layers[0].mlp.w_up's
            grad within amax/(127//2)/2, `max_weight_error` within 1/254
  train:restart  the same cut, default step: run A (4 steps) saves
            after steps 1 and 3 (cusz params at eb_valrel 1e-3, moments
            lossless) through the AsyncWriter under one injected
            transient write failure; B resumes at step 4 and runs to 6;
            C runs 6 steps without checkpoints.  A's losses within 1e-6
            of C's, B's within 1e-2; the restored state within its bound
            (lossless leaves exact, AdamWState and count as written);
            one cusz leaf's container made again by the plain versions,
            byte for byte
  mesh:*    on a one-rank NCCL process group (in-process store), every
            mesh axis of size 1, torn down before the summary:
            `mesh:train` (qwen3-4b's width, 2 layers, on a ("pod",
            "data", "model") mesh with FSDP specs and the int8 weight
            gather, 3 steps of 4 x 512: losses equal to the mesh-less
            `compress_for_gather` run within 1e-6, step times on and off
            the mesh, kernels per step, `CommDebugMode` counts),
            `mesh:moe` (deepseek-v2-236b's widths, 2 layers: one forward
            of 4 x 512 with the int8-block all-to-all against the plain
            one; finite logits, the dispatch within its bound),
            `mesh:reshard` (qwen3-4b full: prefill on mesh A, the
            int8-block and cusz handoffs, `reshard_caches` onto mesh B,
            16 greedy tokens; the int8-block leg adopted with no decode
            and equal to the mesh-less `generate`'s tokens, the cusz leg
            on kernels 1-6 with its first K leaf's containers again by
            the plain versions) and `mesh:checkpoint` (the 2-layer
            parameters placed FSDP, cusz saves in 1 and 4 shards, the
            elastic restore onto mesh B bit-equal, one leaf by the plain
            versions, the `use_restore_compress` wire leg in its bound)
  dryrun:*  the production dry run (`launch/dryrun.py`) on a fake group
            of 256 ranks under fake tensors, one process per cell with
            the card hidden, all started together after the card's
            phases (they would take host cores from those phases'
            timings), each to end within one cap from that start:
            qwen3-4b `decode_32k` at
            its published depth (the sharded decode), qwen3-4b
            `prefill_32k` cut to 2 of 36 layers (its blocked attention
            is 1,024 flash blocks per layer at 32k, each a few dozen
            host operations under fake tensors), deepseek-v2-236b
            `train_4k` at its published widths cut to 2 of 60 layers
            (int8 moments, MLA and MoE backward) and mamba2-1.3b
            `train_4k` cut to 4 of 48 layers;
            each must report status ok, with its per-rank memory,
            collectives and build seconds

Each of the consumer, serve, train and mesh phases is driven with the
launch counts set to 0 just before it (each serve phase before itself)
and read just after it; "timing" lines give each phase's seconds; `--seed`
sets the data of the consumer, serve and train phases.

then the `{"kernels": [...]}` summary and, last, the device line.  Any
failed check raises, so the script exits nonzero; without a CUDA device it
exits 2 before printing any result.  The full record also goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import math
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# the codecs as benchmarks/quality.py configures them, and their
# BENCH_quality.json rows (ratio = raw bytes / stored bytes)
QUALITY_KW = {"cusz": dict(eb=1e-4, eb_mode="valrel"),
              "cusz-i": dict(eb=1e-4, eb_mode="valrel", outlier_frac=1.0),
              "fz": dict(eb=1e-4, eb_mode="valrel")}
QUALITY_RATIOS = {
    "cusz": {"hacc": 9.709, "cesm": 4.844, "hurricane": 5.334,
             "hurricane_cloud": 11.692, "nyx": 14.447, "qmcpack": 4.122},
    "cusz-i": {"hacc": 10.48, "cesm": 8.801, "hurricane": 5.038,
               "hurricane_cloud": 11.577, "nyx": 14.926, "qmcpack": 1.188},
    "fz": {"hacc": 3.202, "cesm": 2.827, "hurricane": 2.416,
           "hurricane_cloud": 10.807, "nyx": 11.983, "qmcpack": 3.219},
}

# kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "lorenzo.dualquant": ("src/repro_torch/csrc/lorenzo.cu",
                          "src/repro/kernels/lorenzo/kernel.py:76"),
    "histogram": ("src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram/kernel.py:41"),
    "encode": ("src/repro_torch/csrc/encode.cu",
               "src/repro/kernels/encode/kernel.py:36"),
    "deflate": ("src/repro_torch/csrc/deflate.cu",
                "src/repro/kernels/deflate/kernel.py:69"),
    "inflate": ("src/repro_torch/csrc/inflate.cu",
                "src/repro/kernels/inflate/kernel.py:103"),
    "lorenzo.reverse": ("src/repro_torch/csrc/lorenzo.cu",
                        "src/repro/kernels/lorenzo/kernel.py:96"),
    "interp.predict": ("src/repro_torch/csrc/interp.cu",
                       "src/repro/kernels/interp/kernel.py:62"),
    "interp.reconstruct": ("src/repro_torch/csrc/interp.cu",
                           "src/repro/kernels/interp/kernel.py:67"),
    "bitshuffle.encode": ("src/repro_torch/csrc/bitshuffle.cu",
                          "src/repro/kernels/bitshuffle/kernel.py:46"),
    "bitshuffle.decode": ("src/repro_torch/csrc/bitshuffle.cu",
                          "src/repro/kernels/bitshuffle/kernel.py:63"),
}

# qwen3-4b (src/repro/configs/qwen3_4b.py): the widths of the consumer
# phases
QWEN3_4B = dict(n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
                d_ff=9728, vocab=151936, head_dim=128)
# the KV handoff: one 32k-token sequence in 256 wire slabs (the default
# slab of 128 tokens)
KV_SEQ, KV_SLABS = 32768, 256

# codec -> the kernels its path must launch
PATH_KERNELS = {
    "cusz": ("lorenzo.dualquant", "histogram", "encode", "deflate",
             "inflate", "lorenzo.reverse"),
    "cusz-i": ("interp.predict", "histogram", "encode", "deflate",
               "inflate", "interp.reconstruct"),
    "fz": ("lorenzo.dualquant", "bitshuffle.encode", "bitshuffle.decode",
           "lorenzo.reverse"),
}

RECORD: list = []


def emit(obj: dict) -> None:
    RECORD.append(obj)
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_diff(torch, a, b) -> float:
    """Largest |a - b| (integers compared as int64, floats as float64)."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    _build.lib()
    info = _build.build_info
    ptxas = [ln.strip() for ln in str(info["ptxas"]).splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or ln.startswith("==")]
    emit({"phase": "build", "seconds": info["seconds"],
          "cached": info["cached"], "library": info["path"],
          "ptxas": ptxas})


def long_code_shares(torch, lengths, flat, nc: int, chunk: int,
                     sub: int) -> dict:
    """Share of inflate steps whose codeword is longer than the kernel's
    LUT (they take the interval compare), per symbol and per warp step (a
    warp of 32 consecutive cursors waits whenever one of its lanes does)."""
    from repro_torch.core import huffman as hf
    n = flat.numel()
    long = torch.zeros(nc * chunk, dtype=torch.bool, device=flat.device)
    long[:n] = lengths.long()[flat.long()] > hf.LUT_BITS
    steps = long.view(-1, sub)                      # [cursors, sub]
    pad = -steps.shape[0] % 32
    if pad:
        steps = torch.cat([steps, steps.new_zeros(pad, sub)])
    warp_any = steps.view(-1, 32, sub).any(1)
    return {"lut_bits": hf.LUT_BITS,
            "long_code_share": float(long.sum()) / max(n, 1),
            "long_code_warp_step_share": float(warp_any.float().mean())}


def inflate_long_codes(torch, dev, chunk: int, sub: int) -> None:
    """The inflate kernel against its plain version on a stream whose
    code reaches max_len 32 (Fibonacci frequencies over 33 symbols), so
    many steps take the interval compare."""
    from repro_torch.core import huffman as hf
    from repro_torch.kernels.deflate import ops as deflate_ops
    from repro_torch.kernels.encode import ops as encode_ops
    from repro_torch.kernels.inflate import ops as inflate_ops
    fib = [1, 1]
    while len(fib) < 33:
        fib.append(fib[-1] + fib[-2])
    freq = torch.zeros(1024, dtype=torch.int64)
    freq[100:133] = torch.tensor(fib)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    codes = torch.repeat_interleave(torch.arange(1024, device=dev),
                                    freq.to(dev)).to(torch.int32)
    codes = codes[torch.randperm(codes.numel(), device=dev, generator=g)]
    cb = hf.canonical_codebook(hf.codeword_lengths(freq)).to(dev)
    cw, bw = encode_ops.encode_cuda(codes, cb)
    words, _, gbits, _ = deflate_ops.deflate_cuda(cw, bw, chunk, sub)
    nc, n = words.shape[0], codes.numel()
    n_valid = (n - torch.arange(nc, device=dev, dtype=torch.int64) * chunk
               ).clamp(0, chunk).to(torch.int32)
    tbl = hf.build_decode_table(cb.lengths)
    dec = inflate_ops.inflate_cuda(words, n_valid, gbits, tbl, sub)
    diff = max_diff(torch, dec, inflate_ops.ref.inflate_gap_ref(
        words, n_valid, gbits, tbl, sub))
    same = diff == 0.0 and torch.equal(dec.reshape(-1)[:n], codes)
    emit({"phase": "kernel:inflate:long_codes", "n": n,
          "max_len": int(cb.max_len), "max_abs_err": diff, "equal": same,
          **long_code_shares(torch, cb.lengths, codes, nc, chunk, sub)})
    require(same and int(cb.max_len) > hf.LUT_BITS,
            f"inflate differs on a max_len {int(cb.max_len)} stream by "
            f"{diff}")


def phase_kernels(torch, dev) -> dict:
    """Every kernel against its plain version at the NYX 512^3 shapes."""
    from repro_torch.core import compressor as CZ
    from repro_torch.core import dualquant as dq
    from repro_torch.core import huffman as hf
    from repro_torch.data import scidata
    from repro_torch.kernels.deflate import ops as deflate_ops
    from repro_torch.kernels.encode import ops as encode_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.inflate import ops as inflate_ops
    from repro_torch.kernels.lorenzo import ops as lorenzo_ops
    from repro_torch.kernels.lorenzo import ref as lorenzo_ref

    cfg = CZ.CompressorConfig(eb=1e-4, eb_mode="valrel")
    x = scidata.nyx_like((512, 512, 512), seed=3, device=dev)
    eb = CZ.resolve_eb(cfg, x)
    block = cfg.block_for(3)
    xb = dq.block_split(dq.pad_to_blocks(x, block), block)
    del x
    n, nbins = xb.numel(), cfg.nbins
    out = {}

    def record(name, diff, ms, plain_ms, nbytes, ops, library_ms=None,
               **extra):
        b, by = bound_ms(nbytes, ops)
        out[name] = {"name": name, "route": "cuda",
                     "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                     "max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": library_ms}
        emit({"phase": f"kernel:{name}", "n": n, "equal": diff == 0.0,
              **out[name], **extra})
        require(diff == 0.0, f"{name} kernel differs from its plain version "
                f"by {diff}")

    # 1. fused dual-quant: ~20 scalar ops per value (multiply, round, the
    # 8-term stencil, the cap test); then the same bytes as (256) and
    # (16,16) blocks, and the generic kernel (the one every block took
    # before the warp-per-block kernels) on an unaligned copy
    def dualquant_check(v):
        kc, kd = lorenzo_ops.dualquant_blocks_cuda(v, eb, nbins)
        pc, pd = lorenzo_ref.dualquant_blocks_ref(v, eb, nbins)
        torch.cuda.synchronize()
        return max(max_diff(torch, kc, pc), max_diff(torch, kd, pd))

    diff = dualquant_check(xb)
    codes, delta = lorenzo_ops.dualquant_blocks_cuda(xb, eb, nbins)
    buf = torch.empty(n + 4, dtype=torch.float32, device=dev)
    xu = buf[1:n + 1].view(xb.shape)
    xu.copy_(xb)
    generic_diff = dualquant_check(xu)
    generic_ms = cuda_ms(torch, lambda: lorenzo_ops.dualquant_blocks_cuda(
        xu, eb, nbins), 10)
    del buf, xu
    require(generic_diff == 0.0, "lorenzo.dualquant's generic kernel "
            f"differs from its plain version by {generic_diff}")
    record("lorenzo.dualquant", diff,
           cuda_ms(torch, lambda: lorenzo_ops.dualquant_blocks_cuda(
               xb, eb, nbins), 10),
           cuda_ms(torch, lambda: lorenzo_ref.dualquant_blocks_ref(
               xb, eb, nbins), 3),
           12 * n, 20 * n, block=list(block), eb=eb,
           generic_ms=generic_ms, generic_max_abs_err=generic_diff)
    for view in ((-1, 256), (-1, 1, 16, 16)):
        v = xb.view(view)
        diff = dualquant_check(v)
        b, by = bound_ms(12 * n, 20 * n)
        ms = cuda_ms(torch, lambda: lorenzo_ops.dualquant_blocks_cuda(
            v, eb, nbins), 10)
        plain = cuda_ms(torch, lambda: lorenzo_ref.dualquant_blocks_ref(
            v, eb, nbins), 3)
        name = "x".join(str(d) for d in view[-2:] if d > 1)
        emit({"phase": f"kernel:lorenzo.dualquant:{name}", "n": n,
              "block": [d for d in view[1:] if d > 1], "equal": diff == 0.0,
              "max_abs_err": diff, "ms": ms, "plain_ms": plain,
              "bound_ms": b, "bound_by": by})
        require(diff == 0.0, f"lorenzo.dualquant ({name}) differs from its "
                f"plain version by {diff}")
    del xb, v

    # 2. histogram: 1 increment per code
    flat = codes.reshape(-1)
    hist = hist_ops.histogram_cuda(codes, nbins)
    diff = max_diff(torch, hist, hist_ops.ref.histogram_ref(codes, nbins))
    record("histogram", diff,
           cuda_ms(torch, lambda: hist_ops.histogram_cuda(codes, nbins), 10),
           cuda_ms(torch, lambda: hist_ops.ref.histogram_ref(codes, nbins), 3),
           4 * n + 4 * nbins, n,
           library_ms=cuda_ms(torch, lambda: torch.bincount(
               flat, minlength=nbins), 10))

    # the Huffman tree between the kernels runs on a host copy (its own
    # stage time, host clock)
    t0 = time.perf_counter()
    lengths = hf.codeword_lengths(hist)
    cb = hf.canonical_codebook(lengths).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "huffman_tree_host", "seconds": time.perf_counter() - t0,
          "max_len": int(cb.max_len)})

    # 3. encode: 1 gather per symbol
    cw, bw = encode_ops.encode_cuda(codes, cb)
    pcw, pbw = encode_ops.ref.encode_ref(codes, cb)
    diff = max(max_diff(torch, cw, pcw), max_diff(torch, bw, pbw))
    del pcw, pbw
    table = torch.stack([cb.codes.view(torch.int32), cb.lengths], 1)
    record("encode", diff,
           cuda_ms(torch, lambda: encode_ops.encode_cuda(codes, cb), 10),
           cuda_ms(torch, lambda: encode_ops.ref.encode_ref(codes, cb), 3),
           12 * n + 8 * nbins, n,
           library_ms=cuda_ms(torch, lambda: torch.index_select(
               table, 0, flat), 10))

    # 4. deflate: ~15 scalar ops per symbol (scan, shifts, two ORs)
    chunk, sub = cfg.chunk_size, cfg.sub_size
    words, bits, gbits, gsyms = deflate_ops.deflate_cuda(cw, bw, chunk, sub)
    plain = deflate_ops.ref.deflate_ref(cw, bw, chunk, sub)
    diff = max(max_diff(torch, a, b) for a, b in
               zip((words, bits, gbits, gsyms), plain))
    del plain
    nc = words.shape[0]
    record("deflate", diff,
           cuda_ms(torch, lambda: deflate_ops.deflate_cuda(cw, bw, chunk,
                                                           sub), 10),
           cuda_ms(torch, lambda: deflate_ops.ref.deflate_ref(cw, bw, chunk,
                                                              sub), 2),
           8 * n + 4 * nc * chunk + 4 * nc + 8 * gbits.numel(), 15 * n)
    del cw, bw

    # 5. inflate: ~12 scalar ops per symbol (the LUT lookup, the shift
    # and refill test, the staged store); bytes are the used stream words,
    # not the dense buffer
    tbl = hf.build_decode_table(cb.lengths)
    starts = torch.arange(nc, device=dev, dtype=torch.int64) * chunk
    n_valid = (n - starts).clamp(0, chunk).to(torch.int32)
    dec = inflate_ops.inflate_cuda(words, n_valid, gbits, tbl, sub)
    pdec = inflate_ops.ref.inflate_gap_ref(words, n_valid, gbits, tbl, sub)
    diff = max_diff(torch, dec, pdec)
    require(torch.equal(dec.reshape(-1)[:n], flat),
            "inflate does not give back the encoded codes")
    del pdec
    used_words = int(((bits.long() + 31) // 32).sum())
    record("inflate", diff,
           cuda_ms(torch, lambda: inflate_ops.inflate_cuda(
               words, n_valid, gbits, tbl, sub), 10),
           cuda_ms(torch, lambda: inflate_ops.ref.inflate_gap_ref(
               words, n_valid, gbits, tbl, sub), 2),
           4 * used_words + 4 * nc + 4 * gbits.numel() + 4 * nc * chunk,
           12 * n, stream_bytes=4 * used_words,
           **long_code_shares(torch, cb.lengths, flat, nc, chunk, sub))
    del words, dec, codes, flat
    inflate_long_codes(torch, dev, chunk, sub)

    # 6. reverse: ~10 scalar ops per value (3 axes x 3 scan steps, dequant);
    # then the same bytes viewed as (256) and (16,16) blocks
    rec = lorenzo_ops.reverse_blocks_cuda(delta, eb)
    diff = max_diff(torch, rec, lorenzo_ref.reverse_blocks_ref(delta, eb))
    del rec
    record("lorenzo.reverse", diff,
           cuda_ms(torch, lambda: lorenzo_ops.reverse_blocks_cuda(delta, eb),
                   10),
           cuda_ms(torch, lambda: lorenzo_ref.reverse_blocks_ref(delta, eb),
                   3),
           8 * n, 10 * n, block=list(block))
    for view in ((-1, 256), (-1, 1, 16, 16)):
        d = delta.view(view)
        rec = lorenzo_ops.reverse_blocks_cuda(d, eb)
        diff = max_diff(torch, rec, lorenzo_ref.reverse_blocks_ref(d, eb))
        del rec
        b, by = bound_ms(8 * n, 10 * n)
        ms = cuda_ms(torch, lambda: lorenzo_ops.reverse_blocks_cuda(d, eb),
                     10)
        plain = cuda_ms(torch, lambda: lorenzo_ref.reverse_blocks_ref(d, eb),
                        3)
        name = "x".join(str(v) for v in view[-2:] if v > 1)
        emit({"phase": f"kernel:lorenzo.reverse:{name}", "n": n,
              "block": [v for v in view[1:] if v > 1], "equal": diff == 0.0,
              "max_abs_err": diff, "ms": ms, "plain_ms": plain,
              "bound_ms": b, "bound_by": by})
        require(diff == 0.0, f"lorenzo.reverse ({name}) differs from its "
                f"plain version by {diff}")
    del delta
    torch.cuda.empty_cache()

    # 7-8. interpolation at NYX's first level (axis 0 of the prequantized
    # field: 262,144 rows, 256 evens + 3 pad, 256 odds); ~8 integer ops
    # per value
    from repro_torch.core import interp
    from repro_torch.kernels.bitshuffle import ops as bits_ops
    from repro_torch.kernels.interp import ops as interp_ops
    x = scidata.nyx_like((512, 512, 512), seed=3, device=dev)
    axis = interp.interp_plan(tuple(x.shape))[0][0][0]
    xm = torch.movedim(dq.prequant(x, eb), axis, -1)
    ev, odd = xm[..., 0::2], xm[..., 1::2]
    pe = interp._pad_even(ev.reshape(-1, ev.shape[-1]))
    odd = odd.reshape(-1, odd.shape[-1]).contiguous()
    del xm, ev
    rows, mo = odd.shape
    io_bytes = 4 * pe.numel() + 8 * odd.numel()
    res = interp_ops.residual_rows_cuda(pe, odd)
    diff = max_diff(torch, res, interp_ops.ref.residual_rows_ref(pe, odd))
    record("interp.predict", diff,
           cuda_ms(torch, lambda: interp_ops.residual_rows_cuda(pe, odd), 10),
           cuda_ms(torch, lambda: interp_ops.ref.residual_rows_ref(pe, odd),
                   3),
           io_bytes, 8 * rows * mo, rows=rows, mo=mo, pe_width=pe.shape[1])
    back = interp_ops.odd_rows_cuda(pe, res)
    diff = max_diff(torch, back, interp_ops.ref.odd_rows_ref(pe, res))
    require(torch.equal(back, odd), "interp.reconstruct does not invert "
            "interp.predict")
    record("interp.reconstruct", diff,
           cuda_ms(torch, lambda: interp_ops.odd_rows_cuda(pe, res), 10),
           cuda_ms(torch, lambda: interp_ops.ref.odd_rows_ref(pe, res), 3),
           io_bytes, 8 * rows * mo, rows=rows, mo=mo, pe_width=pe.shape[1])
    del pe, odd, res, back

    # 9-10. bit planes of fz's codes (Lorenzo 8x8x8 at the same eb) in
    # chunks of 512: ~2P + 6 scalar ops per symbol to encode, ~3P + 6 to
    # decode; the encode also on an unaligned copy of the codes (its bulk
    # copy then moves the 16 B-aligned window around each tile); both also
    # at chunk 32 (W = 1) and at P = 16 (the codes of nbins 65536)
    xb = dq.block_split(x, block)
    codes, _ = lorenzo_ops.dualquant_blocks_cuda(xb, eb, nbins)
    codes16, _ = lorenzo_ops.dualquant_blocks_cuda(xb, eb, 65536)
    del x, xb
    codes2 = codes.reshape(-1, 512)
    del codes
    p_count = bits_ops.nplanes(nbins)
    planes = bits_ops.encode_planes_cuda(codes2, nbins)
    diff = max_diff(torch, planes,
                    bits_ops.ref.encode_planes_ref(codes2, nbins))
    buf = torch.empty(codes2.numel() + 4, dtype=torch.int32, device=dev)
    cu = buf[1:codes2.numel() + 1].view(codes2.shape)
    cu.copy_(codes2)
    unaligned_diff = max_diff(torch, bits_ops.encode_planes_cuda(cu, nbins),
                              planes)
    unaligned_ms = cuda_ms(torch, lambda: bits_ops.encode_planes_cuda(
        cu, nbins), 10)
    del buf, cu
    require(unaligned_diff == 0.0, "bitshuffle.encode on an unaligned copy "
            f"differs from the aligned one by {unaligned_diff}")
    bs_bytes = 4 * codes2.numel() + 4 * planes.numel()
    record("bitshuffle.encode", diff,
           cuda_ms(torch, lambda: bits_ops.encode_planes_cuda(codes2, nbins),
                   10),
           cuda_ms(torch, lambda: bits_ops.ref.encode_planes_ref(codes2,
                                                                 nbins), 3),
           bs_bytes, (2 * p_count + 6) * codes2.numel(),
           chunks=codes2.shape[0], planes=p_count, unaligned_ms=unaligned_ms,
           unaligned_max_abs_err=unaligned_diff)
    dec = bits_ops.decode_planes_cuda(planes, nbins)
    diff = max_diff(torch, dec, bits_ops.ref.decode_planes_ref(planes, nbins))
    require(torch.equal(dec, codes2), "bitshuffle.decode does not invert "
            "bitshuffle.encode")
    record("bitshuffle.decode", diff,
           cuda_ms(torch, lambda: bits_ops.decode_planes_cuda(planes, nbins),
                   10),
           cuda_ms(torch, lambda: bits_ops.ref.decode_planes_ref(planes,
                                                                 nbins), 3),
           bs_bytes, (3 * p_count + 6) * codes2.numel(),
           chunks=codes2.shape[0], planes=p_count)
    del planes, dec
    for name, c2, nb in (("W1", codes2.view(-1, 32), nbins),
                         ("P16", codes16.view(-1, 512), 65536)):
        pl = bits_ops.encode_planes_cuda(c2, nb)
        enc_diff = max_diff(torch, pl, bits_ops.ref.encode_planes_ref(c2, nb))
        dec = bits_ops.decode_planes_cuda(pl, nb)
        dec_diff = max_diff(torch, dec,
                            bits_ops.ref.decode_planes_ref(pl, nb))
        same = torch.equal(dec, c2)
        del dec
        pc = bits_ops.nplanes(nb)
        nbytes = 4 * c2.numel() + 4 * pl.numel()
        shape = {"n": c2.numel(), "chunks": c2.shape[0],
                 "words": pl.shape[2], "planes": pc}
        for kname, kdiff, ops_per, fn, plain in (
                ("encode", enc_diff, 2 * pc + 6,
                 lambda: bits_ops.encode_planes_cuda(c2, nb),
                 lambda: bits_ops.ref.encode_planes_ref(c2, nb)),
                ("decode", dec_diff, 3 * pc + 6,
                 lambda: bits_ops.decode_planes_cuda(pl, nb),
                 lambda: bits_ops.ref.decode_planes_ref(pl, nb))):
            b, by = bound_ms(nbytes, ops_per * c2.numel())
            emit({"phase": f"kernel:bitshuffle.{kname}:{name}", **shape,
                  "equal": kdiff == 0.0 and same, "max_abs_err": kdiff,
                  "ms": cuda_ms(torch, fn, 10),
                  "plain_ms": cuda_ms(torch, plain, 3),
                  "bound_ms": b, "bound_by": by})
        require(enc_diff == 0.0 and dec_diff == 0.0 and same,
                f"bitshuffle ({name}) differs from its plain version: "
                f"encode by {enc_diff}, decode by {dec_diff}, inverse {same}")
        del pl

    # the card's own rate on read+write traffic: one copy of the NYX codes
    # (4 B read and 4 B written per symbol), the yardstick beside the
    # bounds of the kernels above
    dst = torch.empty_like(codes2)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(codes2), 10)
    b, by = bound_ms(8 * codes2.numel(), 0)
    emit({"phase": "yardstick:copy", "n": codes2.numel(),
          "bytes": 8 * codes2.numel(), "ms": copy_ms, "bound_ms": b,
          "TBps": 8 * codes2.numel() / copy_ms / 1e9})
    del dst, codes2, codes16

    # the interpolation kernels on HACC's first level: one row of
    # 140,476,933 odds, which only a kernel that tiles the columns covers
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    mo = 280_953_867 // 2
    pe = torch.randint(-2 ** 22, 2 ** 22, (1, mo + 4), dtype=torch.int32,
                       device=dev, generator=g)
    odd = torch.randint(-2 ** 22, 2 ** 22, (1, mo), dtype=torch.int32,
                        device=dev, generator=g)
    res = interp_ops.residual_rows_cuda(pe, odd)
    back = interp_ops.odd_rows_cuda(pe, res)
    diff = max(max_diff(torch, res,
                        interp_ops.ref.residual_rows_ref(pe, odd)),
               max_diff(torch, back, interp_ops.ref.odd_rows_ref(pe, res)))
    same = diff == 0.0 and torch.equal(back, odd)
    emit({"phase": "kernel:interp:hacc_first_level", "rows": 1, "mo": mo,
          "pe_width": pe.shape[1], "max_abs_err": diff, "equal": same})
    require(same, f"interp kernels differ on one row of {mo} by {diff}")
    del pe, odd, res, back
    torch.cuda.empty_cache()
    return out


def phase_golden(torch) -> None:
    import numpy as np

    from repro_torch import codecs
    from repro_torch.core import compressor as CZ

    z = np.load(ROOT / "tests" / "data" / "cusz_v2_golden.npz")
    hdr = json.loads((ROOT / "tests" / "data" /
                      "cusz_v2_golden_header.json").read_text())
    cfg = CZ.CompressorConfig(eb=1e-3, eb_mode="abs", chunk_size=256,
                              sub_size=64, outlier_frac=1.0)
    codec = codecs.get("cusz", cfg=cfg)
    c = codec.encode(z["field"], device="cuda")
    require(c.payload["words"].is_cuda,
            "golden encode did not run on the card")
    c = codec.pack(c)
    keys = sorted(k for k in z.files if k != "field")
    bad = [k for k in keys if k not in c.payload
           or np.asarray(c.payload[k]).dtype != z[k].dtype
           or not np.array_equal(np.asarray(c.payload[k]), z[k])]
    same_header = c.header.to_json() == hdr
    emit({"phase": "golden", "header_equal": same_header,
          "arrays": len(keys), "arrays_differing": bad})
    require(same_header and not bad and sorted(c.payload) == keys,
            f"golden container differs (header equal {same_header}, "
            f"arrays {bad})")


def phase_quality(torch) -> None:
    from repro_torch import codecs
    from repro_torch.core import metrics as M
    from repro_torch.data import scidata

    for cname, kw in QUALITY_KW.items():
        for name, f in scidata.all_fields(small=True).items():
            codec = codecs.get(cname, **kw)
            c = codec.encode(f, device="cuda")
            rec = codecs.decode(c)
            ratio = f.nbytes / codec.stored_nbytes(c)
            want = QUALITY_RATIOS[cname][name]
            held = M.verify_error_bound(torch.from_numpy(f).cuda(), rec,
                                        c.header.param("eb"))
            emit({"phase": "quality", "codec": cname, "field": name,
                  "ratio": round(ratio, 3), "reference_ratio": want,
                  "bound_held": held,
                  "psnr_db": M.psnr(torch.from_numpy(f).cuda(), rec)})
            require(round(ratio, 3) == want and held,
                    f"quality {cname} {name}: ratio {ratio:.3f} vs {want}, "
                    f"bound held {held}")


def main_fields(torch, dev):
    """The paper's Table 2 sizes, one field per block rank."""
    from repro_torch.data import scidata
    yield "hacc", lambda: torch.from_numpy(
        scidata.hacc_like(n=280_953_867, seed=0)).to(dev)
    yield "cesm", lambda: scidata.cesm_like((1800, 3600), seed=1, device=dev)
    yield "nyx", lambda: scidata.nyx_like((512, 512, 512), seed=3,
                                          device=dev)


def phase_main(torch, dev) -> dict:
    """Each codec's path over the three fields, the launch counts set to
    0 before the path and read after it.  Returns the counts per codec."""
    from repro_torch import codecs
    from repro_torch.core import interp
    from repro_torch.core import metrics as M
    from repro_torch.kernels import dispatch

    fields = [(name, make()) for name, make in main_fields(torch, dev)]
    torch.cuda.synchronize()
    per_codec = {}
    for cname, kw in QUALITY_KW.items():
        codec = codecs.get(cname, **kw)
        tag = "main" if cname == "cusz" else f"main:{cname}"
        dispatch.reset_launches()
        for name, x in fields:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dispatch.launch_counts()
            raw = x.numel() * x.element_size()
            t0 = time.perf_counter()
            c = codec.encode(x)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            y_dev = codecs.decode(c)
            torch.cuda.synchronize()
            t_dec_dev = time.perf_counter() - t0
            del y_dev
            t0 = time.perf_counter()
            p = codec.pack(c)
            t_pack = time.perf_counter() - t0
            t0 = time.perf_counter()
            y = codecs.decode(p, device=dev)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            eb = float(c.header.param("eb"))
            err = M.max_abs_err(x, y)
            held = M.verify_error_bound(x, y, eb)
            launches = {k: v - before[k]
                        for k, v in dispatch.launch_counts().items()
                        if v != before[k]}
            emit({"phase": f"{tag}:{name}", "codec": cname,
                  "shape": list(x.shape), "raw_bytes": raw,
                  "ratio": raw / p.nbytes, "eb": eb,
                  "encode_s": t_enc, "pack_s": t_pack,
                  "decode_device_form_s": t_dec_dev, "decode_packed_s": t_dec,
                  "encode_GBps": raw / t_enc / 1e9,
                  "decode_device_form_GBps": raw / t_dec_dev / 1e9,
                  "decode_packed_GBps": raw / t_dec / 1e9,
                  "max_abs_err": err, "bound_held": held,
                  "n_outliers": int(c.payload["n_outliers"]),
                  "peak_device_bytes": torch.cuda.max_memory_allocated(),
                  "launches": launches})
            require(held and y.shape == x.shape
                    and bool(torch.isfinite(y).all()),
                    f"{tag} {name}: bound held {held}, shape "
                    f"{tuple(y.shape)}")
            if cname == "cusz-i":
                # one launch per level in each direction; two decodes
                levels = len(interp.interp_plan(tuple(x.shape))[0])
                got = (launches.get("interp.predict", 0),
                       launches.get("interp.reconstruct", 0))
                require(got == (levels, 2 * levels),
                        f"{tag} {name}: interp launches {got}, expected "
                        f"({levels}, {2 * levels})")
            del c, p, y
        counts = dispatch.launch_counts()
        emit({"phase": f"{tag}:launches", **counts})
        missing = [k for k in PATH_KERNELS[cname] if counts[k] == 0]
        require(not missing, f"{cname}: kernels never launched on its main "
                f"path: {missing}")
        per_codec[cname] = counts
    return per_codec


def strip_gaps(codecs, c):
    """The format-v1 (gap-less) form of a cusz container."""
    import dataclasses
    return codecs.Container(
        dataclasses.replace(c.header.without_params("sub_size"), version=1),
        {k: v for k, v in c.payload.items()
         if k not in ("gap_bits", "gap_syms")})


def phase_v1(torch, dev) -> dict:
    """cusz's NYX 512^3 container without its gap arrays (format v1):
    the sequential decoder in device and packed form, bit-identical to
    the gap-array decode of the same stream."""
    from repro_torch import codecs
    from repro_torch.core import huffman as hf
    from repro_torch.data import scidata
    from repro_torch.kernels import dispatch

    x = scidata.nyx_like((512, 512, 512), seed=3, device=dev)
    codec = codecs.get("cusz", **QUALITY_KW["cusz"])
    dispatch.reset_launches()
    c = codec.encode(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gap = codecs.decode(c)
    torch.cuda.synchronize()
    t_gap = time.perf_counter() - t0
    v1 = strip_gaps(codecs, c)
    t0 = time.perf_counter()
    y = codecs.decode(v1)
    torch.cuda.synchronize()
    t_v1 = time.perf_counter() - t0
    same_dev = torch.equal(y.view(torch.int32), gap.view(torch.int32))
    del y
    p = codec.pack(v1)
    t0 = time.perf_counter()
    yp = codecs.decode(p, device=dev)
    torch.cuda.synchronize()
    t_v1p = time.perf_counter() - t0
    same_packed = torch.equal(yp.view(torch.int32), gap.view(torch.int32))
    counts = dispatch.launch_counts()
    max_len = int(c.payload["max_len"])
    emit({"phase": "v1", "field": "nyx", "shape": list(x.shape),
          "max_len": max_len, "bucket": hf.bucket_max_len(max_len),
          "decoder": "bitscan" if hf.bucket_max_len(max_len)
          > hf.SEQ_LUT_BITS else "lut",
          "chunks": int(c.payload["words"].shape[0]),
          "max_bits_used": int(c.payload["bits_used"].max()),
          "gap_decode_s": t_gap, "v1_decode_device_form_s": t_v1,
          "v1_decode_packed_s": t_v1p, "gap_arrays_in_packed": sorted(
              k for k in p.payload if k.startswith("gap")),
          "equal_device_form": same_dev, "equal_packed": same_packed,
          "launches": {k: v for k, v in counts.items() if v}})
    require(same_dev and same_packed and "gap_bits" not in p.payload,
            f"v1 decode differs from the gap decode (device form "
            f"{same_dev}, packed {same_packed})")
    # the v1 decode launches no inflate: only the gap decode did
    require(counts["inflate"] == 1 and counts["lorenzo.reverse"] == 3,
            f"v1 launch counts {counts}")
    del x, c, gap, yp, v1, p
    torch.cuda.empty_cache()
    return counts


def consumer_codec(codecs, name: str):
    """Every registry id as the consumer phases configure it: the staged
    codecs at eb 1e-4 valrel with full outlier capacity, int8-block along
    the last axis in blocks of 128, zfp at its default 12 bits."""
    if name in ("cusz", "cusz-i", "fz"):
        return codecs.get(name, eb=1e-4, eb_mode="valrel", outlier_frac=1.0)
    return codecs.get(name)


def int8_tolerance(torch, c, x, name: str):
    """Per-element bound of the int8 family: scale/2 plus one ulp of
    max|x| (the float32 dequantize rounds once more)."""
    scale = c.payload["scale"]
    if name == "int8-block":
        axis = int(c.header.param("axis"))
        scale = scale.repeat_interleave(int(c.header.param("block")),
                                        dim=axis)
    amax = float(x.abs().max())
    return scale / 2 + 2.0 ** math.floor(math.log2(amax)) * 2.0 ** -23


def phase_codecs(torch, dev, seed: int) -> dict:
    """A full-width qwen3-4b MLP weight through every registry id."""
    import numpy as np

    from repro_torch import codecs
    from repro_torch.core import metrics as M
    from repro_torch.kernels import dispatch

    shape = (QWEN3_4B["d_model"], QWEN3_4B["d_ff"])
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                         * np.float32(0.02)).to(dev)
    raw = w.numel() * 4
    total = {k: 0 for k in dispatch.launch_counts()}
    for name in codecs.names():
        codec = consumer_codec(codecs, name)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        c = codec.encode(w)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = codec.pack(c)
        t_pack = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = codecs.decode(p, device=dev)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        t0 = time.perf_counter()
        y_dev = codecs.decode(c)
        torch.cuda.synchronize()
        t_dec_dev = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        same_forms = torch.equal(y, y_dev)
        stored = codec.stored_nbytes(c) if name == "zfp" else p.nbytes
        err = M.max_abs_err(w, y)
        rec = {"phase": f"codecs:{name}", "shape": list(shape),
               "raw_bytes": raw, "stored_bytes": stored,
               "ratio": raw / stored, "encode_s": t_enc, "pack_s": t_pack,
               "decode_packed_s": t_dec, "decode_device_form_s": t_dec_dev,
               "max_abs_err": err, "forms_equal": same_forms,
               "launches": {k: v for k, v in counts.items() if v}}
        if name in ("cusz", "cusz-i", "fz"):
            eb = float(c.header.param("eb"))
            held = M.verify_error_bound(w, y, eb)
            rec.update(eb=eb, bound_held=held)
        elif name == "lossless":
            held = torch.equal(y, w)
        elif name == "zfp":
            rate = codec.achieved_bitrate(c)
            held = rate == codec.planes + 16.0 / 16 \
                and stored == math.ceil(rate * w.numel() / 8) \
                and bool(torch.isfinite(y).all())
            rec.update(bits_per_value=rate, stored_bits_per_value=stored
                       * 8 / w.numel())
        else:
            held = bool(((y - w).abs() <= int8_tolerance(torch, c, w, name)
                         ).all())
        rec["bound_held"] = held
        emit(rec)
        require(held and same_forms and tuple(y.shape) == shape,
                f"codecs {name}: bound held {held}, packed and device "
                f"forms equal {same_forms}")
        for k, v in counts.items():
            total[k] += v
        del c, p, y, y_dev
    require(all(total[k] > 0 for k in set(PATH_KERNELS["cusz"])
                | set(PATH_KERNELS["cusz-i"]) | set(PATH_KERNELS["fz"])),
            f"codecs: kernels not launched: {total}")
    del w
    torch.cuda.empty_cache()
    return total


def phase_kv(torch, dev, seed: int) -> dict:
    """The prefill -> decode handoff of one 8k-token sequence at
    qwen3-4b's width and depth: the K tensor over the four wires, then
    page eviction and adoption on the int8-block wire."""
    from repro_torch.core import kvcache as KV
    from repro_torch.kernels import dispatch

    seq_axis = 2                                 # [n_periods, B, S, Hkv, D]
    shape = (QWEN3_4B["n_layers"], 1, KV_SEQ, QWEN3_4B["n_kv_heads"],
             QWEN3_4B["head_dim"])
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k = torch.randn(shape, generator=g, device=dev, dtype=torch.float32
                    ).to(torch.bfloat16)
    raw = k.numel() * k.element_size()
    nslabs = KV_SLABS
    total = {name: 0 for name in dispatch.launch_counts()}
    for wire in ("int8-block", "cusz", "fz", "lossless"):
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        src = KV.kv_quantize(k, seq_axis) if wire == "int8-block" else k
        parts = KV.kv_wire_encode(src, seq_axis, wire=wire, nslabs=nslabs)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        nbytes = KV.kv_wire_nbytes(parts)
        t0 = time.perf_counter()
        if wire == "int8-block":
            got = KV.kv_wire_adopt(parts, seq_axis, device=dev)
        else:
            got = KV.kv_wire_restore(parts, seq_axis, device=dev)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        rec = {"phase": f"kv:{wire}", "shape": list(shape),
               "dtype": "bfloat16", "nslabs": len(parts),
               "raw_bytes": raw, "wire_bytes": nbytes,
               "ratio": raw / nbytes, "encode_s": t_enc,
               "restore_s": t_dec,
               "codecs": sorted({p.header.codec for p in parts}),
               "launches": {n: v for n, v in counts.items() if v}}
        if wire == "int8-block":
            ok = torch.equal(got.q, src.q) and torch.equal(
                got.scale.view(torch.int32), src.scale.view(torch.int32))
            rec["bit_exact"] = ok
            qkv = src
        elif wire == "lossless":
            ok = torch.equal(got.view(torch.int16), k.view(torch.int16))
            rec["bit_exact"] = ok
        else:
            # each slab within its eb (eb_valrel x the slab's range), plus
            # the bf16 rounding of the restored value
            step = shape[seq_axis] // nslabs
            worst, ok = 0.0, True
            for i, p in enumerate(parts):
                sl = slice(i * step, (i + 1) * step)
                ref_s = k[:, :, sl].float()
                err = float((got[:, :, sl].float() - ref_s).abs().max())
                amax = float(ref_s.abs().max())
                tol = float(p.header.param("eb")) \
                    + 2.0 ** math.floor(math.log2(amax)) * 2.0 ** -8
                worst = max(worst, err / tol)
                ok &= err <= tol
            rec.update(max_err_over_bound=worst, bound_held=ok)
            missing = [n for n in PATH_KERNELS[wire] if counts[n] == 0]
            rec["kernels_missing"] = missing
            ok &= not missing
        emit(rec)
        require(ok, f"kv {wire}: {rec}")
        for n, v in counts.items():
            total[n] += v
        del parts, got
        torch.cuda.empty_cache()
    del k
    # evict and adopt 4 pages of the int8-block cache
    dispatch.reset_launches()
    n_pages = KV.kv_page_count(KV_SEQ)
    ids = (0, n_pages // 3, 2 * n_pages // 3, n_pages - 1)
    t0 = time.perf_counter()
    pages = [KV.kv_page_slice(qkv, seq_axis, i) for i in ids]
    wire = [KV.kv_page_encode(p, seq_axis) for p in pages]
    back = KV.kv_page_concat([KV.kv_page_adopt(w, seq_axis, device=dev)
                              for w in wire], seq_axis)
    torch.cuda.synchronize()
    t_pages = time.perf_counter() - t0
    want = KV.kv_page_concat(pages, seq_axis)
    ok = torch.equal(back.q, want.q) and torch.equal(back.scale, want.scale)
    emit({"phase": "kv:pages", "pages": list(ids),
          "page_bytes": KV.kv_wire_nbytes(wire[0]), "seconds": t_pages,
          "bit_exact": ok})
    require(ok, "kv pages: adopted pages differ from the evicted ones")
    del qkv, pages, wire, back, want
    torch.cuda.empty_cache()
    return total


def qwen3_tree(torch, dev, seed: int) -> dict:
    """qwen3-4b's tied embedding and one decoder block at full width,
    numpy normal x 0.02 from `seed`."""
    import numpy as np

    d, f = QWEN3_4B["d_model"], QWEN3_4B["d_ff"]
    hd = QWEN3_4B["head_dim"]
    q, kv = QWEN3_4B["n_heads"] * hd, QWEN3_4B["n_kv_heads"] * hd
    rng = np.random.default_rng(seed)

    def draw(*shp):
        return torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)
                                * np.float32(0.02)).to(dev)

    block = {"attn": {"q": draw(d, q), "k": draw(d, kv), "v": draw(d, kv),
                      "o": draw(q, d), "q_norm": draw(hd),
                      "k_norm": draw(hd)},
             "mlp": {"gate": draw(d, f), "up": draw(d, f),
                     "down": draw(f, d)},
             "input_norm": draw(d), "post_norm": draw(d)}
    return {"embed": draw(QWEN3_4B["vocab"], d), "layers": [block]}


def phase_checkpoint(torch, dev, seed: int) -> dict:
    """qwen3-4b's embedding plus one block saved at 4 shards through an
    AsyncWriter (cusz leaves, the embedding as int8-block) and loaded on
    the card."""
    import os

    from repro_torch import codecs
    from repro_torch.io import checkpoint as CK
    from repro_torch.io.async_writer import AsyncWriter
    from repro_torch.kernels import dispatch

    tree = qwen3_tree(torch, dev, seed)
    leaves = dict((CK._leaf_key(p), t) for p, t in
                  CK._leaves_with_path(tree))
    n_values = sum(t.numel() for t in leaves.values())
    # eb_valrel 1e-3: at the default 1e-5, N(0, 0.02) weights overflow
    # cusz's outlier capacity and every matrix falls back to lossless
    policy = CK.CheckpointPolicy(codec="cusz", eb_valrel=1e-3,
                                 rules=(("embed", "int8-block"),))
    torch.cuda.synchronize()
    dispatch.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        with AsyncWriter(max_pending=1) as w:
            t0 = time.perf_counter()
            CK.save_checkpoint(d, 0, tree, policy=policy, nshards=4,
                               writer=w)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            w.wait()
            t_write = time.perf_counter() - t0
        step_dir = os.path.join(d, "step_00000000")
        man = json.load(open(os.path.join(step_dir, "manifest.json")))
        shard_bytes = [os.path.getsize(os.path.join(
            step_dir, CK._SHARD_FMT.format(h))) for h in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = CK.load_checkpoint(d, tree, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        stats = dict(CK.LAST_RESTORE_STATS)
    counts = dispatch.launch_counts()
    got = dict((CK._leaf_key(p), t) for p, t in CK._leaves_with_path(out))
    placement, fails = {}, []
    for key, x in leaves.items():
        e = man["tensors"][key]
        y = got[key]
        placement[key] = {"codec": e["codec"], "axis": e["axis"],
                          "shards": [s["shard"] for s in e["shards"]]}
        if e["codec"] == "lossless":
            ok = torch.equal(y, x)
        elif e["codec"] == "int8-block":
            # split across the 4 shards; within scale/2 + one ulp, with
            # the block scales recomputed from the source
            c = codecs.get("int8-block").encode(x)
            ok = e["axis"] == 0 and len(e["shards"]) == 4 \
                and bool(((y - x).abs() <= int8_tolerance(
                    torch, c, x, "int8-block")).all())
            del c
        else:
            eb = float(e["shards"][0]["header"]["params"]["eb"])
            ok = e["axis"] is None and len(e["shards"]) == 1 \
                and float((y - x).abs().max()) <= eb * (1 + 1e-5) \
                + 4 * 2.0 ** -23 * float(x.abs().max())
        if not ok:
            fails.append(key)
    emit({"phase": "checkpoint", "leaves": len(leaves), "values": n_values,
          "raw_bytes": n_values * 4, "nshards": 4,
          "eb_valrel": policy.eb_valrel, "encode_s": t_enc,
          "write_s": t_write, "load_s": t_load,
          "shard_bytes": shard_bytes, "stored_bytes": sum(shard_bytes),
          "ratio": n_values * 4 / sum(shard_bytes),
          "placement": placement, "restore_stats": stats,
          "launches": {k: v for k, v in counts.items() if v},
          "leaves_failing": fails})
    require(not fails, f"checkpoint leaves outside their bound: {fails}")
    require(all(counts[k] > 0 for k in PATH_KERNELS["cusz"]),
            f"checkpoint: cusz kernels not launched: {counts}")
    del tree, out, leaves, got
    torch.cuda.empty_cache()
    return counts


SERVE = dict(batch=4, prompt=512, s_max=1024, new=16, requests=8,
             plen=(130, 600), max_new=(8, 16), arrivals=(0, 3),
             max_batch=4, tight_pages=8, big_pages=32,
             # the cusz-evicting run takes the first 4 requests: on the
             # 8-page pool they preempt 22 times and move 70 pages each
             # way (all 8 move 350, ~0.14 s each at full width)
             cusz_requests=4)
# (steps, preemptions, pages evicted, pages restored) of the continuous
# runs at the default --seed: with EOS off the schedule depends only on
# the requests' lengths and the pool, not on the model or the codec;
# tests/test_torch_serve.py rehearses both schedules on the CPU
SERVE_COUNTS = {"cusz": (26, 22, 70, 70), "int8-block": (52, 105, 350, 350),
                "int8-block-big": (32, 0, 0, 0)}
# deepseek-v2-236b (src/repro/configs/deepseek_v2_236b.py) at its
# published widths, depth cut to 2 of 60 layers: 9.0 B f32 parameters
# (36 GB, 54 GB during the one bf16 cast); three layers would pass 78 GB
DEEPSEEK_LAYERS = 2
# mamba2-1.3b at its published width and depth: 3 prompts of whole SSD
# chunks (128 tokens) on 3 slots, 8 pool pages tight enough to preempt
MAMBA2 = dict(prompts=(256, 384, 512), max_new=16, max_batch=3,
              tight_pages=8, big_pages=32)
MAMBA2_COUNTS = {"int8-block": (32, 31, 123, 123),
                 "int8-block-big": (16, 0, 0, 0)}
WIRES = ("int8-block", "cusz", "fz", "lossless")
# the kernels each handoff wire must launch (kernels 1-6; 1, 2, 9, 10)
WIRE_KERNELS = {"cusz": PATH_KERNELS["cusz"], "fz": PATH_KERNELS["fz"],
                "int8-block": (), "lossless": ()}


def same_qkv(torch, a, b) -> bool:
    return torch.equal(a.q, b.q) and torch.equal(
        a.scale.view(torch.int32), b.scale.view(torch.int32))


def same_bits(torch, a, b) -> bool:
    """Two dense tensors (f32 or bf16), bit for bit."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(ints), b.view(ints))


def handoff_bound_held(torch, KV, parts, src_bf16, seq_axis: int):
    """Each lossy slab within its wire bound: the codec's eb (absolute,
    from the header) plus the bf16 rounding of the restored value.
    Returns (worst error / bound, held)."""
    got = KV.kv_wire_restore(parts, seq_axis, dtype=torch.bfloat16,
                             device=src_bf16.device)
    worst, ok, start = 0.0, True, 0
    for p in parts:
        n = KV.kv_slab_shape(p)[seq_axis]
        ref_s = src_bf16.narrow(seq_axis, start, n).float()
        err = float((got.narrow(seq_axis, start, n).float() - ref_s)
                    .abs().max())
        amax = float(ref_s.abs().max())
        tol = (float(p.header.param("eb")) if p.header.codec != "lossless"
               else 0.0)
        if amax > 0:
            tol += 2.0 ** math.floor(math.log2(amax)) * 2.0 ** -8
        worst = max(worst, err / tol if tol else (0.0 if err == 0 else
                                                  math.inf))
        ok &= err <= tol
        start += n
    return worst, ok


def same_containers(np, codecs, a, b) -> bool:
    """Two sequences of packed containers, byte for byte."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        hx, ax = codecs.to_arrays(x)
        hy, ay = codecs.to_arrays(y)
        if hx != hy or sorted(ax) != sorted(ay) or any(
                np.asarray(ax[k]).tobytes() != np.asarray(ay[k]).tobytes()
                for k in ax):
            return False
    return True


def plain_route_check(torch, dispatch, encode, restore, parts,
                      same_restore) -> dict:
    """Encode and restore one cache tensor again through the kernels'
    plain PyTorch versions on the same card tensors: `encode()` must give
    the containers `parts` that the kernels made on the path, byte for
    byte, and `restore(parts)` the same values as the kernels' restore.
    The plain run must launch no kernel (it really took the plain route);
    the kernels' restore here runs after the path's counts were read."""
    import numpy as np

    from repro_torch import codecs

    dispatch.reset_launches()
    with dispatch.kernel_policy("torch"):
        plain_parts = encode()
        plain = restore(parts)
    torch.cuda.synchronize()
    plain_launches = sum(dispatch.launch_counts().values())
    kern = restore(parts)
    out = {"containers": len(parts),
           "containers_identical": same_containers(np, codecs, parts,
                                                   plain_parts),
           "restore_equal": same_restore(plain, kern),
           "plain_launches": plain_launches}
    out["ok"] = out["containers_identical"] and out["restore_equal"] \
        and plain_launches == 0
    return out


def serve_requests(np, Req, vocab: int, seed: int):
    """The continuous phase's requests, from `seed`: drawn at qwen3-4b's
    vocabulary whatever the model (so every model gets the same lengths,
    arrivals and max_new), token ids taken modulo `vocab`."""
    sizes = SERVE
    rng = np.random.default_rng(seed + 1)
    lo, hi = sizes["plen"]
    return [Req(rid=i,
                prompt=rng.integers(1, QWEN3_4B["vocab"],
                                    size=int(rng.integers(lo, hi + 1))
                                    ).astype(np.int32) % vocab,
                max_new=int(rng.integers(sizes["max_new"][0],
                                         sizes["max_new"][1] + 1)),
                arrival=int(rng.integers(sizes["arrivals"][0],
                                         sizes["arrivals"][1] + 1)))
            for i in range(sizes["requests"])]


def profile_decode(torch, dev, E, params, cfg, scfg, last, caches, plen,
                   steps: int = 2) -> dict:
    """`torch.profiler` over `steps` decode steps: the device's busy
    time (the sum of kernel times) against the host clock, and the five
    kernels that take the most device time.  Only the device is traced
    (tracing the host's ~20 k ops per step as well took ~18 s for 4
    steps and adds host time to them); `profiler_s` is the whole call,
    ~2.7 s per step for the ~5 k kernels of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_call = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        E.decode_tokens(params, cfg, scfg, last, caches, plen, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy,
            "profiler_s": time.perf_counter() - t_call,
            "device_busy_share": busy / wall if rows else None,
            "kernels_per_step": sum(r[2] for r in rows) / steps,
            "top": [{"name": k[:80], "ms_per_step": t / 1e3 / steps,
                     "calls_per_step": c / steps} for k, t, c in rows[:6]]}


class ServeRun:
    """One model's serve phases on the card (`prefix` names them:
    "serve", "serve:deepseek", "serve:mamba2"): its weights, the launch
    counts summed over its phases, and each phase's record."""

    def __init__(self, torch, dev, cfg, params, prefix: str):
        from repro_torch.core import kvcache as KV
        from repro_torch.kernels import dispatch
        from repro_torch.serve import engine as E
        from repro_torch.serve import pool as P
        from repro_torch.serve import scheduler as S

        self.torch, self.dev, self.cfg = torch, dev, cfg
        self.params, self.prefix = params, prefix
        self.E, self.P, self.S, self.KV = E, P, S, KV
        self.dispatch = dispatch
        self.total = {name: 0 for name in dispatch.launch_counts()}
        self.scfg = E.ServeConfig(s_max=SERVE["s_max"], compressed_kv=True)

    def _add(self, counts) -> dict:
        for n, v in counts.items():
            self.total[n] += v
        return {k: v for k, v in counts.items() if v}

    def generate(self, prompt, n_new: int, extra: dict) -> None:
        """`generate`, then prefill and decode_tokens apart (timed), and a
        device-only profiler window over 2 decode steps.  Keeps the
        tokens, the last logits and the caches for `disagg`."""
        torch, E, cfg, scfg = self.torch, self.E, self.cfg, self.scfg
        params = self.params
        B = prompt.shape[0]
        t_phase = time.perf_counter()
        self.dispatch.reset_launches()
        t0 = time.perf_counter()
        want = E.generate(params, cfg, prompt, n_new, scfg)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        last, caches, plen = E.prefill(params, cfg, prompt, scfg)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = E.decode_tokens(params, cfg, scfg, last, caches, plen, n_new)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = self._add(self.dispatch.launch_counts())
        prof = profile_decode(torch, self.dev, E, params, cfg, scfg, last,
                              caches, plen)
        ok = torch.equal(toks, want) and tuple(toks.shape) == (B, n_new) \
            and bool(((toks >= 0) & (toks < cfg.vocab)).all()) \
            and bool(torch.isfinite(last).all())
        emit({"phase": f"{self.prefix}:generate", "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "params": sum(t.numel() for t in _leaves(params)),
              "weights_dtype": "bfloat16 (cast once)",
              "batch": B, "prompt_len": plen, "s_max": scfg.s_max,
              "compressed_kv": True, "new_tokens": n_new, **extra,
              "generate_first_call_s": t_gen, "prefill_s": t_prefill,
              "prefill_tokens_per_s": B * plen / t_prefill,
              "decode_s": t_decode,
              "decode_tokens_per_s": B * n_new / t_decode,
              "decode_ms_per_step": t_decode / n_new * 1e3,
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "tokens_equal_generate": torch.equal(toks, want),
              "first_tokens": toks[0, :8].tolist(), "decode_profile": prof,
              "launches": launches,
              "phase_s": time.perf_counter() - t_phase})
        require(ok, f"{self.prefix}:generate: tokens differ between "
                "generate and prefill + decode_tokens, or are out of range, "
                "or the logits are not finite")
        self.want, self.last, self.caches, self.plen = want, last, caches, plen

    def disagg(self, wire: str) -> dict:
        """prefill's caches -> encode_handoff -> reshard_caches ->
        decode_tokens over `wire`: the cache leaves (GQA K / V, MLA
        latents) on the wire codec, Mamba state lossless.  int8-block
        adopts bit for bit and gives generate's tokens; the lossy wires
        hold their bound, and cusz / fz make the first leaf's containers
        again by the plain versions, byte for byte; Mamba state arrives
        bit for bit."""
        torch, E, KV, S = self.torch, self.E, self.KV, self.S
        cfg, scfg, caches = self.cfg, self.scfg, self.caches
        n_new = self.want.shape[1]
        leaves = S._attn_leaves(cfg, caches.entries)
        states = S._state_entries(cfg, caches.entries)
        torch.cuda.synchronize()
        t_phase = time.perf_counter()
        self.dispatch.reset_launches()
        t0 = time.perf_counter()
        h = E.encode_handoff(caches, cfg, scfg, plen=self.plen, wire=wire)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        hs = dict(E.LAST_HANDOFF_STATS)
        t0 = time.perf_counter()
        rc = E.reshard_caches(h, cfg, scfg, device=self.dev)
        torch.cuda.synchronize()
        t_res = time.perf_counter() - t0
        rs = dict(E.LAST_RESHARD_STATS)
        t0 = time.perf_counter()
        got = E.decode_tokens(self.params, cfg, scfg, self.last, rc,
                              h.plen, n_new)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        counts = self.dispatch.launch_counts()
        rec = {"phase": f"{self.prefix}:disagg:{wire}",
               "wire_bytes": hs["wire_bytes"],
               "raw_bf16_bytes": hs["raw_bf16_bytes"],
               "ratio": hs["raw_bf16_bytes"] / hs["wire_bytes"],
               "containers": hs["containers"],
               "lossless_fallback": hs["lossless_fallback"],
               "leaf_shapes": sorted({tuple(getattr(c, "q", c).shape)
                                      for c in leaves}),
               "encode_s": t_enc, "reshard_s": t_res, "decode_s": t_dec,
               "adopted_quantkv": rs["adopted_quantkv"],
               "decoded": rs["decoded"],
               "tokens_equal_generate": torch.equal(got, self.want),
               "launches": self._add(counts)}
        missing = [k for k in WIRE_KERNELS[wire] if counts[k] == 0] \
            if leaves else []
        rec["kernels_missing"] = missing
        ok = not missing and tuple(got.shape) == tuple(self.want.shape)
        state_exact = all(same_bits(torch, a, b)
                          for new, old in zip(S._state_entries(cfg,
                                                               rc.entries),
                                              states)
                          for a, b in zip(new, old))
        rec["state_bit_exact"] = state_exact if states else None
        ok &= state_exact and rs["tensors"] == hs["tensors"]
        if wire == "int8-block":
            exact = all(same_qkv(torch, a, b) for a, b in zip(
                S._attn_leaves(cfg, rc.entries), leaves))
            rec["adopted_bit_exact"] = exact
            ok &= exact and rs["adopted_quantkv"] == len(leaves) \
                and torch.equal(got, self.want)
        else:
            parts = [pt for kind, entry in zip(h.kinds, h.entries)
                     if kind != "state" for pt in entry]
            worst, held = 0.0, True
            for pt, src in zip(parts, leaves):
                w, hd = handoff_bound_held(
                    torch, KV, pt,
                    KV.kv_dequantize(src, E.HANDOFF_SEQ_AXIS,
                                     torch.bfloat16), E.HANDOFF_SEQ_AXIS)
                worst, held = max(worst, w), held and hd
            rec.update(max_err_over_bound=worst, bound_held=held)
            ok &= held and rs["decoded"] == hs["tensors"]
            if wire in ("cusz", "fz"):
                chk = plain_route_check(
                    torch, self.dispatch,
                    lambda: KV.kv_wire_encode(
                        leaves[0], E.HANDOFF_SEQ_AXIS, wire=wire,
                        source_dtype=scfg.compute_dtype),
                    lambda ps: KV.kv_wire_restore(
                        ps, E.HANDOFF_SEQ_AXIS, dtype=torch.bfloat16,
                        device=self.dev),
                    parts[0], torch.equal)
                rec["plain_route_leaf"] = {
                    "shape": list(leaves[0].q.shape), **chk}
                ok &= chk["ok"]
        rec["phase_s"] = time.perf_counter() - t_phase
        emit(rec)
        require(ok, f"{self.prefix}:disagg:{wire}: {rec}")
        return rec

    def drop_handoff_state(self) -> None:
        del self.caches, self.last
        self.torch.cuda.empty_cache()

    def continuous(self, runs) -> dict:
        """The continuous scheduler, per (label, evict codec, pool pages,
        requests) run; the cusz run records the first slab it evicts and
        encodes and restores it again through the plain versions.
        Returns {label: (finished, scheduler)}."""
        torch, P, S, KV = self.torch, self.P, self.S, self.KV
        evicted = []
        keep_evict = P._evict_slab

        def recording_evict(slab, seq_axis, codec, source_dtype,
                            codec_cfg):
            """The pool's eviction leg, keeping the first slab it encodes
            (and its containers) for the plain-route check."""
            parts = keep_evict(slab, seq_axis, codec, source_dtype,
                               codec_cfg)
            if not evicted:
                evicted.append((KV.QuantKV(slab.q.clone(),
                                           slab.scale.clone()),
                                seq_axis, codec, source_dtype, codec_cfg,
                                parts))
            return parts

        out = {}
        for label, codec, pages, reqs, max_batch in runs:
            torch.cuda.synchronize()
            P._evict_slab = recording_evict if label == "cusz" \
                else keep_evict
            self.dispatch.reset_launches()
            t0 = time.perf_counter()
            try:
                fin, sched = S.run_continuous(
                    self.params, self.cfg, self.scfg,
                    S.SchedulerConfig(max_batch=max_batch, pool_pages=pages,
                                      evict_codec=codec), reqs)
                torch.cuda.synchronize()
            finally:
                P._evict_slab = keep_evict
            dt = time.perf_counter() - t0
            counts = self.dispatch.launch_counts()
            st = sched.pool.stats()
            n_tok = sum(len(f["tokens"]) for f in fin.values())
            rec = {"phase": f"{self.prefix}:continuous:{label}",
                   "requests": len(fin),
                   "prompt_lens": [len(r.prompt) for r in reqs],
                   "max_batch": max_batch, "pool_pages": pages,
                   "evict_codec": st["evict_codec"], "decode_steps":
                   sched.n_steps, "preemptions": sched.preemptions,
                   "evicted_pages": st["evicted_pages"],
                   "restored_pages": st["restored_pages"],
                   "host_bytes_evicted": st["evicted_bytes"],
                   "peak_pages": st["peak_used"], "tokens": n_tok,
                   "seconds": dt, "tokens_per_s": n_tok / dt,
                   "launches": self._add(counts)}
            out[label] = (fin, sched)
            ok = len(fin) == len(reqs) and all(
                len(fin[r.rid]["tokens"]) == r.max_new for r in reqs) \
                and sched.pool.used_pages == 0 and not sched.states
            if label == "cusz":
                missing = [k for k in PATH_KERNELS["cusz"]
                           if counts[k] == 0]
                rec["kernels_missing"] = missing
                ok &= sched.preemptions > 0 and st["evicted_pages"] > 0 \
                    and st["restored_pages"] > 0 and not missing \
                    and len(evicted) == 1
                if evicted:
                    slab, ax, ev_codec, src_dt, ev_cfg, parts = evicted[0]
                    chk = plain_route_check(
                        torch, self.dispatch,
                        lambda: keep_evict(slab, ax, ev_codec, src_dt,
                                           ev_cfg),
                        lambda ps: P._restore_slab(ps, ax, src_dt,
                                                   self.dev),
                        parts, lambda a, b: same_qkv(torch, a, b))
                    rec["plain_route_page"] = {
                        "slab_shape": list(slab.q.shape), **chk}
                    ok &= chk["ok"]
            rec["phase_s"] = time.perf_counter() - t0
            emit(rec)
            require(ok, f"{self.prefix}:continuous:{label}: {rec}")
        return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def schedule_counts(sched) -> tuple:
    st = sched.pool.stats()
    return (sched.n_steps, sched.preemptions, st["evicted_pages"],
            st["restored_pages"])


def continuous_same_tokens(name: str, runs, tight: str, big: str) -> None:
    """The tight pool's tokens (it preempted) equal the big pool's."""
    (t_fin, t_sched), (b_fin, b_sched) = runs[tight], runs[big]
    same = all(t_fin[r]["tokens"] == b_fin[r]["tokens"] for r in t_fin)
    emit({"phase": name, "tight_equals_big": same,
          "tight_preemptions": t_sched.preemptions,
          "big_preemptions": b_sched.preemptions})
    require(same and t_sched.preemptions > 0,
            f"{name}: tight-pool tokens differ from the big pool's (or the "
            "tight pool never preempted)")


def random_prompt(torch, np, cfg, dev, batch: int, length: int, seed: int):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, length)).astype(np.int32)).to(dev)


def phase_serve(torch, dev, seed: int) -> tuple:
    """The serving path at qwen3-4b's published width and depth: generate
    (prefill + 16 greedy tokens), the disaggregated prefill -> handoff ->
    reshard -> decode over the four wires, and the continuous scheduler
    on a paged pool tight enough to preempt.  Random f32 weights from
    `seed`, cast once to bf16.  Returns the launch counts summed over the
    phases (each driven with the counts set to 0 just before it) and the
    continuous runs' (steps, preemptions, evicted, restored)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import scheduler as S

    cfg, sizes = configs.get("qwen3-4b"), SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    params = M.cast_params(M.init_params(gen, cfg, device=dev),
                           torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    run = ServeRun(torch, dev, cfg, params, "serve")
    run.generate(random_prompt(torch, np, cfg, dev, sizes["batch"],
                               sizes["prompt"], seed), sizes["new"],
                 {"init_and_cast_s": t_init})
    for wire in WIRES:
        run.disagg(wire)
    run.drop_handoff_state()
    reqs = serve_requests(np, S.Request, cfg.vocab, seed)
    runs = run.continuous(
        (("cusz", None, sizes["tight_pages"],
          reqs[:sizes["cusz_requests"]], sizes["max_batch"]),
         ("int8-block", "int8-block", sizes["tight_pages"], reqs,
          sizes["max_batch"]),
         ("int8-block-big", "int8-block", sizes["big_pages"], reqs,
          sizes["max_batch"])))
    continuous_same_tokens("serve:continuous", runs, "int8-block",
                           "int8-block-big")
    counts = {k: schedule_counts(v[1]) for k, v in runs.items()}
    total = run.total
    del params, run, runs
    torch.cuda.empty_cache()
    return total, counts


def phase_serve_deepseek(torch, dev, seed: int, qwen_counts) -> dict:
    """MLA + MoE serving at deepseek-v2-236b's published widths, depth cut
    to DEEPSEEK_LAYERS: generate (with the number of assignments dropped
    over capacity in prefill), the disaggregated handoff of the latent
    cache over the four wires, and the continuous scheduler on the
    qwen3-4b phase's requests and pools, whose counts must be that
    phase's (and the rehearsed ones at the default seed)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import scheduler as S

    cfg = dataclasses.replace(configs.get("deepseek-v2-236b"),
                              n_layers=DEEPSEEK_LAYERS)
    sizes = SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    params = M.cast_params(M.init_params(gen, cfg, device=dev),
                           torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    prompt = random_prompt(torch, np, cfg, dev, sizes["batch"],
                           sizes["prompt"], seed)

    # the assignments prefill drops over capacity (a prefill of its own,
    # outside the timed phases: reading the counts syncs per layer)
    seen, keep_route = [], moe.route

    def recording_route(p, c, x):
        r = keep_route(p, c, x)
        seen.append((int((~r.keep).sum()), r.keep.numel(), r.cap))
        return r

    moe.route = recording_route
    try:
        run = ServeRun(torch, dev, cfg, params, "serve:deepseek")
        run.E.prefill(params, cfg, prompt, run.scfg)
    finally:
        moe.route = keep_route
    torch.cuda.reset_peak_memory_stats()
    run.generate(prompt, sizes["new"], {
        "depth_cut": f"{cfg.n_layers} of 60 layers",
        "init_and_cast_s": t_init, "init_peak_device_bytes": init_peak,
        "prefill_dropped_assignments": sum(d for d, _, _ in seen),
        "prefill_assignments": sum(n for _, n, _ in seen),
        "prefill_capacity": seen[0][2]})
    for wire in WIRES:
        run.disagg(wire)
    run.drop_handoff_state()
    reqs = serve_requests(np, S.Request, cfg.vocab, seed)
    runs = run.continuous(
        (("cusz", None, sizes["tight_pages"],
          reqs[:sizes["cusz_requests"]], sizes["max_batch"]),
         ("int8-block", "int8-block", sizes["tight_pages"], reqs,
          sizes["max_batch"]),
         ("int8-block-big", "int8-block", sizes["big_pages"], reqs,
          sizes["max_batch"])))
    continuous_same_tokens("serve:deepseek:continuous", runs, "int8-block",
                           "int8-block-big")
    counts = {k: schedule_counts(v[1]) for k, v in runs.items()}
    emit({"phase": "serve:deepseek:schedule", "counts": counts,
          "qwen3_4b_counts": qwen_counts,
          "rehearsed": SERVE_COUNTS if seed == 0 else None})
    require(counts == qwen_counts and (seed != 0 or counts == SERVE_COUNTS),
            f"serve:deepseek: schedule {counts} differs from the qwen3-4b "
            f"phase's {qwen_counts} or the rehearsal's {SERVE_COUNTS}")
    total = run.total
    del params, run, runs
    torch.cuda.empty_cache()
    return total


def phase_serve_mamba2(torch, dev, seed: int) -> dict:
    """Mamba2/SSD serving at mamba2-1.3b's published width and depth:
    generate, the disaggregated handoff (the state crosses lossless, bit
    for bit) and the continuous scheduler with the state sidecar on a
    pool tight enough to preempt, whose tokens must equal a big pool's
    and whose counts the rehearsal's."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import scheduler as S

    cfg, sizes = configs.get("mamba2-1.3b"), SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    params = M.cast_params(M.init_params(gen, cfg, device=dev),
                           torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    run = ServeRun(torch, dev, cfg, params, "serve:mamba2")
    run.generate(random_prompt(torch, np, cfg, dev, sizes["batch"],
                               sizes["prompt"], seed), sizes["new"],
                 {"init_and_cast_s": t_init})
    run.disagg("int8-block")
    run.drop_handoff_state()
    rng = np.random.default_rng(seed + 2)
    reqs = [S.Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n
                                                 ).astype(np.int32),
                      max_new=MAMBA2["max_new"])
            for i, n in enumerate(MAMBA2["prompts"])]
    runs = run.continuous(
        (("int8-block", "int8-block", MAMBA2["tight_pages"], reqs,
          MAMBA2["max_batch"]),
         ("int8-block-big", "int8-block", MAMBA2["big_pages"], reqs,
          MAMBA2["max_batch"])))
    continuous_same_tokens("serve:mamba2:continuous", runs, "int8-block",
                           "int8-block-big")
    counts = {k: schedule_counts(v[1]) for k, v in runs.items()}
    emit({"phase": "serve:mamba2:schedule", "counts": counts,
          "rehearsed": MAMBA2_COUNTS})
    require(counts == MAMBA2_COUNTS,
            f"serve:mamba2: schedule {counts} differs from the "
            f"rehearsal's {MAMBA2_COUNTS}")
    total = run.total
    del params, run, runs
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# train:step at qwen3-4b's published width and depth; train:compress and
# train:restart at its width with the depth cut to TRAIN_CUT_LAYERS
TRAIN = dict(batch=4, seq=512, steps=4, compress_steps=3, npods=2,
             restart_steps=(4, 6), checkpoint_every=2, eb_valrel=1e-3,
             snapshot_every=2)
TRAIN_CUT_LAYERS = 2
# H100 SXM data sheet: dense bf16 tensor-core peak
BF16_FLOP_PER_S = 989e12


def _train_cfg(layers=None):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get("qwen3-4b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _state_bytes(torch, tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


class _Spy:
    """Wraps `owner.name` for the extent of a `with`: each returning
    call's seconds and result (and, through `on_call`, whatever the
    caller wants kept from its arguments)."""

    def __init__(self, owner, name: str, on_call=None):
        self.owner, self.name, self.on_call = owner, name, on_call
        self.seconds: list = []
        self.results: list = []

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def wrapped(*args, **kwargs):
            if self.on_call is not None:
                self.on_call(*args, **kwargs)
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            self.results.append(out)
            return out
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def profile_train_step(torch, step_fn, params, opt, toks) -> tuple:
    """One train step under a device-only `torch.profiler` window: the
    device's busy time (sum of kernel times) against the host clock, and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_call = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    return out, {"wall_s": wall, "device_busy_s": busy,
                 "device_busy_share": busy / wall if rows else None,
                 "kernels_per_step": sum(r[2] for r in rows),
                 "profiler_s": time.perf_counter() - t_call,
                 "top": [{"name": k[:80], "ms": t / 1e3, "calls": c}
                         for k, t, c in rows[:8]]}


def phase_train_step(torch, dev, seed: int) -> dict:
    """`Trainer.run` at qwen3-4b's published width and depth: 36 layers,
    4.02 B f32 master weights from a generator seeded by `seed`, AdamW
    with f32 moments, 4 steps of 4 x 512 tokens from the bigram stream,
    bf16 compute.  The last step runs under a device-only profiler."""
    from repro_torch.kernels import dispatch
    from repro_torch.train import trainer as TR
    from repro_torch.train.train_step import TrainConfig

    cfg, sizes = _train_cfg(), TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lcfg = TR.LoopConfig(steps=sizes["steps"], batch=sizes["batch"],
                         seq=sizes["seq"], seed=seed, checkpoint_dir=None)
    tr = TR.Trainer(cfg, TrainConfig(), lcfg, device=dev)
    step_fn, calls, prof = tr.step_fn, [], {}

    def step(params, opt, toks):
        calls.append(len(calls))
        if len(calls) < sizes["steps"]:
            return step_fn(params, opt, toks)
        out, prof["last_step"] = profile_train_step(torch, step_fn, params,
                                                    opt, toks)
        return out
    tr.step_fn = step
    dispatch.reset_launches()
    t0 = time.perf_counter()
    # snapshots after steps 0 and 2: the second reuses the first's buffers
    snap_bytes, every = [], TR.SNAPSHOT_EVERY
    TR.SNAPSHOT_EVERY = sizes["snapshot_every"]
    try:
        with _Spy(TR.HostSnapshot, "take", lambda self, state:
                  snap_bytes.append(_state_bytes(torch, state))) as snap:
            hist = tr.run()
    finally:
        TR.SNAPSHOT_EVERY = every
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    n_params = cfg.param_count()
    tokens = sizes["batch"] * sizes["seq"]
    # steady steps: not the first (allocator and library warm-up), not the
    # profiled last
    steady = [h["dt"] for h in hist[1:-1]]
    step_s = sum(steady) / len(steady)
    flop = 6 * n_params * tokens
    losses = [h["loss"] for h in hist]
    rec = {"phase": "train:step", "arch": cfg.name, "layers": cfg.n_layers,
           "params": n_params, "batch": sizes["batch"], "seq": sizes["seq"],
           "steps": len(hist), "losses": losses,
           "step_s": [h["dt"] for h in hist], "steady_step_s": step_s,
           "tokens_per_s": tokens / step_s, "run_s": t_run,
           "host_snapshot_s": snap.seconds,
           "host_snapshot_bytes": snap_bytes,
           "host_peak_rss_bytes": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_flop_per_step": flop,
           "model_flop_share_of_bf16_peak": flop / step_s / BF16_FLOP_PER_S,
           "profile_last_step": prof.get("last_step"),
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require(len(hist) == sizes["steps"]
            and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0],
            f"train:step: losses {losses}")
    require(len(snap.seconds) == 2,
            f"train:step: {len(snap.seconds)} host snapshots, not 2")
    del tr, hist
    torch.cuda.empty_cache()
    return counts


def phase_train_compress(torch, dev, seed: int) -> dict:
    """qwen3-4b at full width, 2 of 36 layers: int8 pod-compressed grads
    over 2 pods, the int8 weight STE, 2 microbatches and int8 AdamW
    moments, 3 steps through `make_train_step` with the batch in the
    podded layout [2, 2, 512].  The pod mean of layers[0].mlp.w_up's grad
    must hold its bound, every quantized weight `max_weight_error`."""
    from repro_torch.core import weights as W
    from repro_torch.data import pipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TT
    from repro_torch.tree import leaves

    cfg, sizes = _train_cfg(TRAIN_CUT_LAYERS), TRAIN
    npods = sizes["npods"]
    tcfg = TT.TrainConfig(grad_compress="int8", npods=npods,
                          weight_compress="int8", microbatches=2,
                          adamw=adamw.AdamWConfig(quantized_moments=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                           device=dev)
    opt = adamw.init(params, tcfg.adamw)
    weight_err = W.max_weight_error(params)
    step = TT.make_train_step(cfg, tcfg)
    pod = {}

    def keep_w_up(grads_podded, mode, n):
        pod["g"] = grads_podded["layers"][0]["mlp"]["w_up"].clone()
    dispatch.reset_launches()
    losses, dts = [], []
    with _Spy(TT.G, "compressed_psum_mean", keep_w_up) as psum:
        for s in range(sizes["compress_steps"]):
            toks = torch.from_numpy(pipeline.host_batch(
                cfg.vocab, sizes["batch"], sizes["seq"], s, seed).reshape(
                npods, sizes["batch"] // npods, sizes["seq"])).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, toks)
            losses.append(float(loss))
            dts.append(time.perf_counter() - t0)
    counts = dispatch.launch_counts()
    # the last step's pod mean of w_up's grad against the plain mean
    g = pod["g"]
    got = TT.G.compressed_psum_mean({"w": g}, "int8", npods)["w"]
    qeff = 127 // npods
    bound = float(g.abs().max()) / qeff / 2
    err = float((got - g.mean(0)).abs().max())
    n_params = sum(t.numel() for t in leaves(params))
    f32_moments = 2 * 4 * n_params
    moment_bytes = _state_bytes(torch, (opt.m, opt.v))
    rec = {"phase": "train:compress", "arch": cfg.name,
           "layers": cfg.n_layers, "params": n_params,
           "pods": npods, "microbatches": tcfg.microbatches,
           "tokens_shape": [npods, sizes["batch"] // npods, sizes["seq"]],
           "losses": losses, "step_s": dts,
           "psum_calls": len(psum.seconds), "psum_s": psum.seconds,
           "w_up_pod_mean_err": err, "w_up_bound": bound,
           "max_weight_error": weight_err,
           "moment_bytes": moment_bytes, "moment_bytes_f32": f32_moments,
           "moment_ratio": moment_bytes / f32_moments,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require(all(math.isfinite(v) for v in losses)
            and len(psum.seconds) == sizes["compress_steps"],
            f"train:compress: {losses}")
    require(err <= bound * (1 + 1e-6) + 2.0 ** -24 * float(g.abs().max()),
            f"train:compress: pod mean off by {err} > bound {bound}")
    require(0 < weight_err <= 1 / 254 + 2.0 ** -23,
            f"train:compress: max_weight_error {weight_err}")
    del params, opt, pod, g, got
    torch.cuda.empty_cache()
    return counts


def phase_train_restart(torch, dev, seed: int) -> dict:
    """Checkpoint and restart at qwen3-4b's width, 2 layers, the default
    `TrainConfig`: run A (4 steps) saves after steps 1 and 3 through the
    AsyncWriter (cusz params at eb_valrel 1e-3, the AdamW moments
    lossless) under one injected transient write failure; run B resumes
    A's files at step 4 and runs to 6; run C runs 6 steps without
    checkpoints.  A's losses must match C's, B's must follow C's, and the
    restored state must be within the stored bound."""
    import json
    import os
    import shutil

    import numpy as np

    from repro_torch import codecs
    from repro_torch.dist import chaos
    from repro_torch.io import checkpoint as CK
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as TR
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.tree import leaves, leaves_with_path

    cfg, sizes = _train_cfg(TRAIN_CUT_LAYERS), TRAIN
    tcfg = TrainConfig()
    steps_a, steps_bc = sizes["restart_steps"]
    # moments lossless: dual-quant can give a small v back as exactly 0
    # beside a non-zero m, and m / (sqrt(0) + eps) blows the update up
    policy = CK.CheckpointPolicy(codec="cusz", eb_valrel=sizes["eb_valrel"],
                                 rules=(("::.m::", "lossless"),
                                        ("::.v::", "lossless")))
    probe_key = "0::layers::0::mlp::w_up"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def loop(steps, d):
        return TR.LoopConfig(steps=steps, batch=sizes["batch"],
                             seq=sizes["seq"], seed=seed,
                             checkpoint_every=sizes["checkpoint_every"],
                             checkpoint_dir=d, checkpoint_policy=policy)

    def spy_state(tr):
        seen, step_fn = {}, tr.step_fn

        def step(params, opt, toks):
            out = step_fn(params, opt, toks)
            seen["state"] = out[1:]
            return out
        tr.step_fn = step
        return seen

    saved = {}

    def keep_probe(ckpt_dir, step, tree, **kw):
        saved[step] = tree[0]["layers"][0]["mlp"]["w_up"].clone()

    with tempfile.TemporaryDirectory() as d:
        dispatch.reset_launches()
        a = TR.Trainer(cfg, tcfg, loop(steps_a, d), device=dev)
        seen_a = spy_state(a)
        t0 = time.perf_counter()
        with chaos.use_chaos(chaos.from_spec("writer:failures=1")) as monkey, \
                _Spy(CK, "save_checkpoint", keep_probe) as save, \
                _Spy(CK, "_write_step") as write, \
                _Spy(CK, "AsyncWriter") as writers:
            hist_a = a.run()
        t_a = time.perf_counter() - t0
        # B resumes from step 3; step 1's files only take disk space
        shutil.rmtree(os.path.join(d, "step_00000001"))
        step_dir = os.path.join(d, "step_00000003")
        man = json.load(open(os.path.join(step_dir, "manifest.json")))
        shard_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                          for f in os.listdir(step_dir)
                          if f.endswith(".npz"))
        state_a = seen_a["state"]
        raw_bytes = _state_bytes(torch, state_a)
        b = TR.Trainer(cfg, tcfg, loop(steps_bc, d), device=dev)
        t0 = time.perf_counter()
        with _Spy(CK, "load_checkpoint") as load:
            hist_b = b.run()
        t_b = time.perf_counter() - t0
        c = TR.Trainer(cfg, tcfg, loop(steps_bc, None), device=dev)
        hist_c = c.run()
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()

        # the restored state against A's last one (after step 3, saved)
        restored, rstep = CK.load_checkpoint(d, TR.state_template(cfg, tcfg),
                                             step=3, device=dev)
        fails, codec_of = [], {}
        for (path, x), y in zip(leaves_with_path(state_a),
                                leaves(restored)):
            key = CK._leaf_key(path)
            e = man["tensors"][key]
            codec_of[key] = e["codec"]
            if e["codec"] == "lossless":
                ok = torch.equal(x, y)
            else:
                eb = float(e["shards"][0]["header"]["params"]["eb"])
                ok = float((y - x).abs().max()) <= eb * (1 + 1e-5) \
                    + 4 * 2.0 ** -23 * float(x.abs().max())
            if not ok:
                fails.append(key)
        types_ok = type(restored[1]) is adamw.AdamWState \
            and int(restored[1].count) == int(state_a[1].count) == steps_a
        # the probe leaf's container, made again by the plain versions
        e = man["tensors"][probe_key]
        sh = e["shards"][0]
        arrays = np.load(os.path.join(step_dir, CK._SHARD_FMT.format(
            int(sh["shard"]))))
        prefix = f"{probe_key}::__c__::0::"
        stored = codecs.from_arrays(sh["header"], {
            k[len(prefix):]: arrays[k] for k in arrays.files
            if k.startswith(prefix)})
        codec = policy.make_codec("cusz")
        chk = plain_route_check(
            torch, dispatch, lambda: [codec.pack(codec.encode(saved[3]))],
            lambda ps: codecs.decode(ps[0], device=dev), [stored],
            lambda x, y: torch.equal(x, y))
    la = [h["loss"] for h in hist_a]
    lb = [h["loss"] for h in hist_b]
    lc = [h["loss"] for h in hist_c]
    a_vs_c = max(abs(x - y) / abs(y) for x, y in zip(la, lc[:steps_a]))
    b_vs_c = max(abs(x - y) / abs(y) for x, y in zip(lb, lc[steps_a:]))
    missing = [k for k in PATH_KERNELS["cusz"] if counts[k] == 0]
    retries = sum(w.n_retries for w in writers.results)
    rec = {"phase": "train:restart", "arch": cfg.name,
           "layers": cfg.n_layers, "eb_valrel": policy.eb_valrel,
           "steps": {"A": [h["step"] for h in hist_a],
                     "B": [h["step"] for h in hist_b],
                     "C": [h["step"] for h in hist_c]},
           "losses": {"A": la, "B": lb, "C": lc},
           "a_vs_c_max_rel": a_vs_c, "a_equals_c_bitwise": la == lc[:steps_a],
           "b_vs_c_max_rel": b_vs_c,
           "caller_blocked_s": save.seconds, "write_s": write.seconds,
           "load_s": load.seconds, "run_s": {"A": t_a, "B": t_b},
           "raw_bytes": raw_bytes, "stored_bytes": shard_bytes,
           "ratio": raw_bytes / shard_bytes,
           "leaves_by_codec": {c: sum(v == c for v in codec_of.values())
                               for c in sorted(set(codec_of.values()))},
           "leaf_codecs": codec_of,
           "write_faults": [e["kind"] for e in monkey.events],
           "writer_retries": retries, "restored_step": rstep,
           "leaves_failing": fails, "types_ok": types_ok,
           "plain_route_leaf": {"key": probe_key, **chk},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kernels_missing": missing,
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require([h["step"] for h in hist_b] == list(range(steps_a, steps_bc))
            and len(save.seconds) == 2 and retries == 1,
            f"train:restart: resume or saves wrong: {rec['steps']}")
    require(not fails and types_ok and rstep == 3,
            f"train:restart: restored state: {fails}, types {types_ok}")
    require(a_vs_c <= 1e-6 and b_vs_c <= 1e-2,
            f"train:restart: losses A {la} B {lb} C {lc}")
    require(not missing and chk["ok"],
            f"train:restart: kernels {missing}, plain route {chk}")
    del a, b, c, state_a, restored, saved
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the mesh: one rank of a real process group (NCCL on the card), the
# reference's axis names at size 1
# ---------------------------------------------------------------------------

MESH = dict(train_steps=3, batch=4, seq=512, new=16, eb_valrel=1e-3,
            nshards=4)


def _block_bound(torch, x, block: int):
    """Per value, the int8-block codec's bound along the last dim: half a
    step (block amax / 127 / 2) plus the rounding of the decoded value to
    x's dtype."""
    xf = x.float()
    shape = xf.shape[:-1] + (xf.shape[-1] // block, block)
    amax = xf.reshape(shape).abs().amax(-1, keepdim=True)
    ulp = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -23
    return (amax / 127 / 2 * (1 + 1e-6) + amax * ulp).expand(
        shape).reshape(xf.shape)


def phase_mesh_train(torch, dev, seed: int) -> dict:
    """qwen3-4b at full width, 2 of 36 layers, on a ("pod", "data",
    "model") mesh: parameters placed by `param_specs(fsdp=True)`, so the
    int8 weight gather acts on every quantizable layer leaf;
    weight_compress int8, a2a_compress none; 3 steps of 4 x 512 tokens.
    The same steps mesh-less, with `compress_for_gather` on the same
    leaves, must give losses equal within 1e-6 relative.  Step 1 runs
    under `CommDebugMode`, step 2 under a device-only profiler (both
    runs), for the step time and the kernels per step.  Then 3 steps
    with int8 AdamW moments, on the mesh and mesh-less: losses bit-equal."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core import weights as W
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.context import use_mesh, use_param_specs
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TT
    from repro_torch.tree import leaves_with_path, tree_map

    cfg, sizes = _train_cfg(TRAIN_CUT_LAYERS), MESH
    tcfg = TT.TrainConfig(weight_compress="int8", a2a_compress="none")
    plain = TT.TrainConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = LM.make_mesh((1, 1, 1), ("pod", "data", "model"), dev.type)
    params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                           device=dev)
    twin = tree_map(torch.clone, params)
    pspecs = SH.param_specs(params, mesh, fsdp=True)
    placed = SH.place(params, SH.param_shardings(params, mesh, fsdp=True))
    del params
    gathered = [path for path, sp in leaves_with_path(pspecs["layers"])
                if W._has_data(sp)]

    def batch(s):
        return torch.from_numpy(pipeline.host_batch(
            cfg.vocab, sizes["batch"], sizes["seq"], s, seed)).to(dev)

    def run(step_fn, params, opt, wrap):
        losses, dts, extra = [], [], {}
        for s in range(sizes["train_steps"]):
            toks = wrap(batch(s))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s == 1:
                comm = CommDebugMode()
                with comm:
                    loss, params, opt = step_fn(params, opt, toks)
                extra["comm_counts"] = {
                    str(k): v for k, v in comm.get_comm_counts().items()}
            elif s == 2:
                (loss, params, opt), extra["profile"] = profile_train_step(
                    torch, step_fn, params, opt, toks)
            else:
                loss, params, opt = step_fn(params, opt, toks)
            losses.append(float(loss))
            dts.append(time.perf_counter() - t0)
        return losses, dts, extra

    dispatch.reset_launches()
    with use_mesh(mesh), use_param_specs(pspecs):
        on = run(TT.make_train_step(cfg, tcfg), placed,
                 adamw.init(placed, tcfg.adamw),
                 lambda t: SH.NamedSharding(mesh, SH.batch_spec(mesh))
                 .place(t))
    counts = dict(dispatch.launch_counts())
    del placed

    def meshless(params, opt, toks):
        use = dict(params)
        use["layers"] = W.compress_for_gather(params["layers"])
        loss, grads = TT._microbatched_grads(use, cfg, plain, toks, None)
        del use
        params, opt = adamw.update(grads, opt, params, plain.adamw)
        return loss, params, opt

    off = run(meshless, twin, adamw.init(twin, plain.adamw), lambda t: t)
    rel = max(abs(a - b) / abs(b) for a, b in zip(on[0], off[0]))
    del twin
    torch.cuda.empty_cache()
    # int8 AdamW moments: the mesh step and the mesh-less one, same setting
    qcfg = TT.TrainConfig(adamw=adamw.AdamWConfig(quantized_moments=True))
    qlosses = {}
    for where in ("mesh", "meshless"):
        p = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                          device=dev)
        step_fn = TT.make_train_step(cfg, qcfg)
        wrap = (lambda t: t)
        if where == "mesh":
            p = SH.place(p, SH.param_shardings(p, mesh, fsdp=True))
            wrap = (lambda t: SH.NamedSharding(mesh, SH.batch_spec(mesh))
                    .place(t))
        opt = adamw.init(p, qcfg.adamw)
        qlosses[where] = []
        with (use_mesh(mesh) if where == "mesh" else use_mesh(None)), \
                use_param_specs(pspecs if where == "mesh" else None):
            for st in range(sizes["train_steps"]):
                loss, p, opt = step_fn(p, opt, wrap(batch(st)))
                qlosses[where].append(float(loss))
        del p, opt
        torch.cuda.empty_cache()
    q_equal = qlosses["mesh"] == qlosses["meshless"]
    rec = {"phase": "mesh:train", "arch": cfg.name, "layers": cfg.n_layers,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend(),
           "weight_compress": tcfg.weight_compress,
           "gathered_leaves": len(gathered),
           "losses": {"mesh": on[0], "meshless": off[0]},
           "max_rel_diff": rel,
           "step_s": {"mesh": on[1], "meshless": off[1]},
           "profiled_step_s": {"mesh": on[2]["profile"]["wall_s"],
                               "meshless": off[2]["profile"]["wall_s"]},
           "kernels_per_step": {
               "mesh": on[2]["profile"]["kernels_per_step"],
               "meshless": off[2]["profile"]["kernels_per_step"]},
           "device_busy_share": {
               "mesh": on[2]["profile"]["device_busy_share"],
               "meshless": off[2]["profile"]["device_busy_share"]},
           "comm_counts": on[2]["comm_counts"],
           "comm_counts_meshless": off[2]["comm_counts"],
           "int8_moments_losses": qlosses,
           "int8_moments_bit_equal": q_equal,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require(gathered and all(math.isfinite(v) for v in on[0] + off[0])
            and rel <= 1e-6,
            f"mesh:train: losses {on[0]} against mesh-less {off[0]}")
    require(q_equal and all(math.isfinite(v) for v in qlosses["mesh"]),
            f"mesh:train: int8 moments, losses {qlosses}")
    torch.cuda.empty_cache()
    return counts


def phase_mesh_moe(torch, dev, seed: int) -> dict:
    """deepseek-v2-236b at its published widths, 2 of 60 layers, on a
    ("data", "model") mesh: one forward of 4 x 512 tokens with the MoE
    all-to-all compressed (`use_a2a_compress("int8-block")`) against the
    uncompressed one (each timed after one untimed warm-up).  The logits
    must be finite and the dispatch tensor that crossed compressed
    within the int8-block bound of the one that went in."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.dist import context as ctx
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get("deepseek-v2-236b"),
                              n_layers=DEEPSEEK_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = LM.make_mesh((1, 1), ("data", "model"), dev.type)
    params = M.cast_params(M.init_params(
        torch.Generator(dev).manual_seed(seed), cfg, device=dev),
        torch.bfloat16)
    placed = SH.place(params, SH.param_shardings(params, mesh))
    del params
    prompt = random_prompt(torch, np, cfg, dev, MESH["batch"], MESH["seq"],
                           seed)
    toks = ctx.resolve_sharding(mesh, prompt.shape, "data").place(prompt)
    crossed, keep = [], moe._compressed_reshard

    def spy(x, to_spec, from_spec):
        out = keep(x, to_spec, from_spec)
        if not crossed:
            crossed.append((x.full_tensor(), out.full_tensor()))
        return out

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = M.forward(placed, cfg, toks)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    dispatch.reset_launches()
    secs = {}
    moe._compressed_reshard = spy
    try:
        with ctx.use_mesh(mesh), torch.no_grad():
            forward()
            plain, secs["plain"] = forward()
            finite_plain = bool(torch.isfinite(plain.full_tensor()).all())
            del plain
            with ctx.use_a2a_compress("int8-block"):
                forward()
                crossed.clear()
                logits, secs["int8-block"] = forward()
    finally:
        moe._compressed_reshard = keep
    counts = dict(dispatch.launch_counts())
    full = logits.full_tensor()
    finite = bool(torch.isfinite(full).all())
    x, y = crossed[0]
    err = (y.float() - x.float()).abs()
    within = bool((err <= _block_bound(torch, x, moe._qblock(
        x.shape[-1]))).all())
    rec = {"phase": "mesh:moe", "arch": cfg.name,
           "depth_cut": f"{cfg.n_layers} of 60 layers",
           "tokens": list(prompt.shape), "logits": list(full.shape),
           "forward_s": secs, "compressed_over_plain":
           secs["int8-block"] / secs["plain"],
           "dispatch_shape": list(x.shape),
           "dispatch_max_err": float(err.max()),
           "dispatch_within_bound": within, "logits_finite": finite,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require(finite and finite_plain and within,
            f"mesh:moe: finite {finite}/{finite_plain}, bound {within}")
    del placed, logits, full, crossed
    torch.cuda.empty_cache()
    return counts


def phase_mesh_reshard(torch, dev, seed: int) -> dict:
    """qwen3-4b at its published width and depth: prefill 4 x 512 on mesh
    A, `encode_handoff` on the int8-block and cusz wires,
    `reshard_caches(mesh=B)`, 16 greedy tokens on mesh B by the sharded
    decode (`mesh_decode_step`: parameters placed FSDP, caches by the
    decode cache rule; seconds per step timed apart).  The int8-block
    leg must adopt every cache tensor with no decode and give the
    mesh-less `generate`'s tokens; the cusz leg runs kernels 1-6, and its
    first cache tensor's containers, encoded from the mesh-placed leaf,
    must equal the plain versions' byte for byte."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import kvcache as KV
    from repro_torch.dist import context as ctx
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    cfg = configs.get("qwen3-4b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh_a = LM.make_mesh((1, 1), ("data", "model"), dev.type)
    mesh_b = LM.make_mesh((1, 1), ("data", "model"), dev.type)
    params = M.cast_params(M.init_params(
        torch.Generator(dev).manual_seed(seed), cfg, device=dev),
        torch.bfloat16)
    scfg = E.ServeConfig(s_max=SERVE["s_max"], compressed_kv=True)
    prompt = random_prompt(torch, np, cfg, dev, MESH["batch"], MESH["seq"],
                           seed)
    want = E.generate(params, cfg, prompt, MESH["new"], scfg)
    pa = SH.place(params, SH.param_shardings(params, mesh_a))
    pb = SH.place(params, SH.param_shardings(params, mesh_b, fsdp=True))
    del params
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with ctx.use_mesh(mesh_a):
        last, caches, plen = E.prefill(
            pa, cfg, ctx.resolve_sharding(mesh_a, prompt.shape, "data")
            .place(prompt), scfg)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    last_b = ctx.resolve_sharding(mesh_b, last.shape, "data").place(
        last.full_tensor())
    legs, total = {}, {}
    for wire in ("int8-block", "cusz"):
        t0 = time.perf_counter()
        with ctx.use_mesh(mesh_a):
            h = E.encode_handoff(caches, cfg, scfg, wire=wire, plen=plen)
        hs = dict(E.LAST_HANDOFF_STATS)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ctx.use_mesh(mesh_b):
            cb = E.reshard_caches(h, cfg, scfg)
            rs = dict(E.LAST_RESHARD_STATS)
            q = cb.entries[0][0].q
            on_b = q.device_mesh is mesh_b and q.dtype == torch.int8
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            toks = E.decode_tokens(pb, cfg, scfg, last_b, cb, plen,
                                   MESH["new"]).full_tensor()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        legs[wire] = {"handoff": hs, "reshard": rs, "encode_s": t_enc,
                      "reshard_decode_s": t2 - t0, "reshard_s": t1 - t0,
                      "decode_s_per_step": (t2 - t1) / MESH["new"],
                      "q_on_mesh_b": on_b,
                      "tokens_equal_meshless": bool(torch.equal(toks,
                                                                want)),
                      "token_agreement": float((toks == want).float()
                                               .mean())}
        if wire == "cusz":
            counts = dict(dispatch.launch_counts())
            leaf = caches.entries[0][0]
            parts = h.entries[0][0]
            legs[wire]["plain_route_leaf"] = plain_route_check(
                torch, dispatch,
                lambda: KV.kv_wire_encode(
                    E._gather(leaf), E.HANDOFF_SEQ_AXIS, wire="cusz",
                    source_dtype=scfg.compute_dtype),
                lambda ps: KV.kv_wire_restore(ps, E.HANDOFF_SEQ_AXIS,
                                              dtype=scfg.compute_dtype,
                                              device=dev),
                parts, lambda a, b: torch.equal(a, b))
        del h, cb
    n_cache = 2 * len(cfg.pattern)      # K and V, stacked over layers
    missing = [k for k in PATH_KERNELS["cusz"] if counts[k] == 0]
    rec = {"phase": "mesh:reshard", "arch": cfg.name,
           "layers": cfg.n_layers, "tokens": list(prompt.shape),
           "new": MESH["new"], "prefill_s": t_prefill, "legs": legs,
           "cache_tensors": n_cache, "kernels_missing": missing,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    i8 = legs["int8-block"]
    require(i8["reshard"]["adopted_quantkv"] == n_cache
            and i8["reshard"]["decoded"] == 0 and i8["q_on_mesh_b"]
            and i8["tokens_equal_meshless"],
            f"mesh:reshard: int8-block leg {i8}")
    require(not missing and legs["cusz"]["plain_route_leaf"]["ok"]
            and legs["cusz"]["q_on_mesh_b"],
            f"mesh:reshard: cusz leg, kernels missing {missing}")
    del pa, pb, caches, last, last_b
    torch.cuda.empty_cache()
    return counts


def phase_mesh_checkpoint(torch, dev, seed: int) -> dict:
    """The 2-layer qwen3-4b parameters placed FSDP on mesh A, saved with
    a cusz policy (eb_valrel 1e-3) in one file and through the
    AsyncWriter in 4; `load_checkpoint(shardings=)` onto mesh B must be
    bit-equal between the two, one cusz leaf's stored container must be
    the plain versions' encode of the gathered leaf, and the
    `use_restore_compress("int8-block")` leg of a lossless save must hold
    its bound with fewer wire bytes than raw ones."""
    import json
    import os

    import numpy as np

    from repro_torch import codecs
    from repro_torch.dist import context as ctx
    from repro_torch.dist import sharding as SH
    from repro_torch.io import checkpoint as CK
    from repro_torch.io.async_writer import AsyncWriter
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    cfg, sizes = _train_cfg(TRAIN_CUT_LAYERS), MESH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh_a = LM.make_mesh((1, 1), ("data", "model"), dev.type)
    mesh_b = LM.make_mesh((1, 1), ("data", "model"), dev.type)
    params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                           device=dev)
    placed = SH.place(params, SH.param_shardings(params, mesh_a, fsdp=True))
    shard_b = SH.param_shardings(params, mesh_b, fsdp=True)
    policy = CK.CheckpointPolicy(codec="cusz", eb_valrel=sizes["eb_valrel"])
    probe = "layers::0::mlp::w_up"
    secs = {}
    with tempfile.TemporaryDirectory() as d:
        d1, d4, dl = (os.path.join(d, x) for x in ("one", "four", "raw"))
        dispatch.reset_launches()
        t0 = time.perf_counter()
        CK.save_checkpoint(d1, 0, placed, policy=policy, nshards=1)
        secs["save_sync"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with AsyncWriter(max_pending=1) as w:
            CK.save_checkpoint(d4, 0, placed, policy=policy,
                               nshards=sizes["nshards"], writer=w)
            secs["save_async_caller"] = time.perf_counter() - t0
            w.wait()
        secs["save_async"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ctx.use_mesh(mesh_b):
            a, _ = CK.load_checkpoint(d1, params, shardings=shard_b)
            secs["load_one"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            b, _ = CK.load_checkpoint(d4, params, shardings=shard_b)
            torch.cuda.synchronize()
            secs["load_four"] = time.perf_counter() - t0
        stats = dict(CK.LAST_RESTORE_STATS)
        counts = dict(dispatch.launch_counts())
        equal = all(torch.equal(x.full_tensor(), y.full_tensor())
                    for x, y in zip(leaves(a), leaves(b)))
        on_b = all(x.device_mesh is mesh_b for x in leaves(b))
        del a, b
        # one cusz leaf of the 4-shard save against the plain versions
        man = json.load(open(os.path.join(d4, "step_00000000",
                                          "manifest.json")))
        e = man["tensors"][probe]
        stored = []
        for i, sh in enumerate(e["shards"]):
            arrays = np.load(os.path.join(d4, "step_00000000",
                                          CK._SHARD_FMT.format(
                                              int(sh["shard"]))))
            prefix = f"{probe}::__c__::{i}::"
            stored.append(codecs.from_arrays(sh["header"], {
                k[len(prefix):]: arrays[k] for k in arrays.files
                if k.startswith(prefix)}))
        codec = policy.make_codec("cusz")
        leaf = placed["layers"][0]["mlp"]["w_up"]
        axis = e["axis"]

        def plain_encode():
            whole = leaf.full_tensor()
            if axis is None:
                return [codec.pack(codec.encode(whole))]
            return [codec.pack(p) for p in codec.encode_parts(
                whole, int(axis), len(e["shards"]))]
        chk = plain_route_check(
            torch, dispatch, plain_encode,
            lambda ps: [codecs.decode(p, device=dev) for p in ps], stored,
            lambda x, y: all(torch.equal(u, v) for u, v in zip(x, y)))
        # the restore-leg wire on a lossless save
        CK.save_checkpoint(dl, 0, placed, nshards=sizes["nshards"])
        with ctx.use_mesh(mesh_b):
            plain, _ = CK.load_checkpoint(dl, params, shardings=shard_b)
            t0 = time.perf_counter()
            with ctx.use_restore_compress("int8-block"):
                coded, _ = CK.load_checkpoint(dl, params,
                                              shardings=shard_b)
            torch.cuda.synchronize()
            secs["load_recoded"] = time.perf_counter() - t0
        rstats = dict(CK.LAST_RESTORE_STATS)
        worst = 0.0
        for x, y in zip(leaves(plain), leaves(coded)):
            x, y = x.full_tensor(), y.full_tensor()
            worst = max(worst, float((x - y).abs().max())
                        / max(float(x.abs().max()) / 127.0, 1e-30))
    missing = [k for k in PATH_KERNELS["cusz"] if counts[k] == 0]
    rec = {"phase": "mesh:checkpoint", "arch": cfg.name,
           "layers": cfg.n_layers, "eb_valrel": policy.eb_valrel,
           "nshards": sizes["nshards"], "seconds": secs,
           "restore_stats": stats, "bit_equal_1_vs_4": equal,
           "placed_on_mesh_b": on_b, "plain_route_leaf": {"key": probe,
                                                          **chk},
           "recode_stats": rstats, "recode_err_in_steps": worst,
           "kernels_missing": missing,
           "launches": {k: v for k, v in counts.items() if v}}
    emit(rec)
    require(equal and on_b and chk["ok"] and not missing,
            f"mesh:checkpoint: equal {equal}, on B {on_b}, plain route "
            f"{chk}, kernels missing {missing}")
    require(rstats["recoded_leaves"] > 0 and worst <= 0.51
            and rstats["wire_bytes"] < rstats["raw_bytes"],
            f"mesh:checkpoint: restore leg {rstats}, err {worst} steps")
    del placed, params, plain, coded
    torch.cuda.empty_cache()
    return counts


#: dry-run cells on a fake group of 256 ranks: (arch, shape, layers kept
#: of the published depth, or None for all of it)
DRYRUN_CELLS = (("qwen3-4b", "decode_32k", None),
                ("qwen3-4b", "prefill_32k", 2),
                ("deepseek-v2-236b", "train_4k", 2),
                ("mamba2-1.3b", "train_4k", 4))
#: wall seconds from the dry-run cells' common start by which each must
#: have ended
DRYRUN_CAP_S = 240.0


def dryrun_child(arch: str, shape: str, layers: int) -> int:
    """One dry-run cell in this process (started by `phase_dryrun` with
    the card hidden): the config cut to `layers` (0: its published
    depth), the record printed as the last line."""
    import dataclasses

    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.launch import dryrun

    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rec = dryrun.run_cell(arch, shape, False, force=True, cfg=cfg,
                          out_dir=str(ROOT / "chiprun_out" / "dryrun"))
    rec["layers"] = f"{cfg.n_layers} of {configs.get(arch).n_layers}"
    print(json.dumps(rec, default=str), flush=True)
    return 0


def phase_dryrun() -> None:
    """The dry-run cells (`DRYRUN_CELLS`), each in a process of its own
    (the fake process group cannot share a process with the NCCL one)
    with the card hidden, all started together; a cell fails unless its
    process ends within `DRYRUN_CAP_S` of that start and reports
    ``status: "ok"``.  Per cell: the per-rank memory, collective counts,
    build seconds, torch version and the process's own wall seconds."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    logs = ROOT / "chiprun_out" / "dryrun"
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for arch, shape, layers in DRYRUN_CELLS:
            stem = logs / f"{arch}__{shape}"
            out, err = (open(f"{stem}.{x}", "w+") for x in ("out", "err"))
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--dryrun-cell", arch, shape, str(layers or 0)],
                stdout=out, stderr=err, text=True, env=env, cwd=str(ROOT)))
        ends = [None] * len(procs)        # each process's own end
        while None in ends and time.perf_counter() - t0 < DRYRUN_CAP_S:
            for i, p in enumerate(procs):
                if ends[i] is None and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for (arch, shape, _), p, end, (out, err) in zip(DRYRUN_CELLS, procs,
                                                    ends, files):
        out.seek(0)
        err.seek(0)
        lines = [ln for ln in out.read().splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {
            "status": "error", "error": err.read()[-2000:]}
        out.close()
        err.close()
        emit({"phase": f"dryrun:{arch}:{shape}",
              "status": rec.get("status"), "layers": rec.get("layers"),
              "cell": rec.get("cell"), "torch": rec.get("torch"),
              "n_ranks": rec.get("n_chips"),
              "build_s": rec.get("lower_s"),
              "per_rank_GiB": (rec.get("memory") or {}).get(
                  "per_device_total_GiB"),
              "collective_counts": rec.get("collective_counts"),
              "collective_bytes_by_op": rec.get("collective_by_op"),
              "flops_per_rank": rec.get("flops_per_device"),
              "roofline": rec.get("roofline"),
              "useful_flops_ratio": rec.get("useful_flops_ratio"),
              "wall_s": end, "error": rec.get("error")})
        require(end is not None, f"dryrun:{arch}:{shape}: past the "
                f"{DRYRUN_CAP_S:.0f} s cap")
        require(p.returncode == 0 and rec.get("status") == "ok",
                f"dryrun:{arch}:{shape}: {rec.get('error')}")


MESH_PHASES = (("mesh:train", phase_mesh_train),
               ("mesh:moe", phase_mesh_moe),
               ("mesh:reshard", phase_mesh_reshard),
               ("mesh:checkpoint", phase_mesh_checkpoint))


def timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": "timing", "name": name,
          "seconds": time.perf_counter() - t0})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the consumer, serve and train phases' "
                         "weights, caches and tokens")
    ap.add_argument("--dryrun-cell", nargs=3, default=None,
                    metavar=("ARCH", "SHAPE", "LAYERS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dryrun_cell:
        arch, shape, layers = args.dryrun_cell
        return dryrun_child(arch, shape, int(layers))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_env(torch)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, torch, dev)
    timed("golden", phase_golden, torch)
    timed("quality", phase_quality, torch)
    per_path = timed("main", phase_main, torch, dev)
    per_path["v1"] = timed("v1", phase_v1, torch, dev)
    per_path["codecs"] = timed("codecs", phase_codecs, torch, dev,
                               args.seed)
    per_path["kv"] = timed("kv", phase_kv, torch, dev, args.seed)
    per_path["checkpoint"] = timed("checkpoint", phase_checkpoint, torch,
                                   dev, args.seed)
    per_path["serve"], qwen_counts = timed("serve", phase_serve, torch, dev,
                                           args.seed)
    per_path["serve:deepseek"] = timed("serve:deepseek",
                                       phase_serve_deepseek, torch, dev,
                                       args.seed, qwen_counts)
    per_path["serve:mamba2"] = timed("serve:mamba2", phase_serve_mamba2,
                                     torch, dev, args.seed)
    for name, fn in (("train:step", phase_train_step),
                     ("train:compress", phase_train_compress),
                     ("train:restart", phase_train_restart)):
        torch.cuda.empty_cache()
        per_path[name] = timed(name, fn, torch, dev, args.seed)
    # the mesh phases on a one-rank NCCL group, torn down before the
    # summary
    from repro_torch.launch import mesh as LM
    with LM.process_group("cuda"):
        for name, fn in MESH_PHASES:
            torch.cuda.empty_cache()
            per_path[name] = timed(name, fn, torch, dev, args.seed)
    timed("dryrun", phase_dryrun)
    # launches summed over the three codecs' main paths, the consumer,
    # serve, train and mesh phases
    summary = [{**kernels[k],
                "launches": sum(c[k] for c in per_path.values())}
               for k in KERNELS]
    for row in summary:
        require(all(row[key] is not None and math.isfinite(row[key])
                    for key in ("ms", "plain_ms", "bound_ms")),
                f"kernel {row['name']} has no timing")
        require(row["launches"] > 0,
                f"kernel {row['name']} never launched on a main path")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
