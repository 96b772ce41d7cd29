"""PyTorch port of the cuSZ reproduction, with hand-written Hopper kernels.

The layout mirrors `repro` (the JAX package, which stays the reference):

    codecs/    codec registry + self-describing container (all eight ids)
    core/      dual-quant, canonical Huffman, stages, compressor, metrics,
               zfp transform, KV-cache codec layer, gradient and weight
               compression (PREQUANT on the pod mean and the weights)
    io/        async writer + sharded checkpoints
    dist/      shard planning, the single-process distribution context,
               fault detection and mitigation, seeded fault injection
    configs/   the ten architecture configs, `reduced`, the shape set
    models/    the model stack: dense GQA, MLA, MoE, Mamba2/SSD, hybrid
    optim/     AdamW with optional int8 block-quantized moments
    train/     the chunked-CE train step and the training loop
    serve/     serving engine (prefill, KV handoff, reshard, decode), the
               paged KV pool and the continuous-batching scheduler
    launch/    the `serve` and `train` command lines
    kernels/   dispatch layer + one ops/ref pair per CUDA kernel
    csrc/      the CUDA C++ sources, built with nvcc at first use
    data/      synthetic SDRBench-like fields and the synthetic LM token
               stream (numpy copies of the reference's)
    tree.py    trees of tensors visited in JAX's pytree order

Entry points run on the device of their input: a CUDA tensor goes through
the CUDA kernels, a CPU tensor through the plain PyTorch versions.  Numpy
input, packed containers and new parameters or caches go to CUDA unless
the caller passes ``device="cpu"``.
"""
