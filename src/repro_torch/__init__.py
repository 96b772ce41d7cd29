"""PyTorch port of the cuSZ reproduction, with hand-written Hopper kernels.

The layout mirrors `repro` (the JAX package, which stays the reference):

    codecs/    codec registry + self-describing container (all eight ids)
    core/      dual-quant, canonical Huffman, stages, compressor, metrics,
               zfp transform, KV-cache codec layer
    io/        async writer + sharded checkpoints
    dist/      shard planning + the single-process distribution context
               (the KV reshard / eviction codec hooks)
    configs/   the ten architecture configs, `reduced`, the shape set
    models/    the dense GQA model stack (config, layers, attention,
               model); MoE, MLA and Mamba/SSM are the next slice
    serve/     serving engine (prefill, KV handoff, reshard, decode), the
               paged KV pool and the continuous-batching scheduler
    launch/    the `serve` command line
    kernels/   dispatch layer + one ops/ref pair per CUDA kernel
    csrc/      the CUDA C++ sources, built with nvcc at first use
    data/      synthetic SDRBench-like fields (numpy copy of the reference)

Entry points run on the device of their input: a CUDA tensor goes through
the CUDA kernels, a CPU tensor through the plain PyTorch versions.  Numpy
input, packed containers and new parameters or caches go to CUDA unless
the caller passes ``device="cpu"``.
"""
