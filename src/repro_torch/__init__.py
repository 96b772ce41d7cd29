"""PyTorch port of the cuSZ reproduction, with hand-written Hopper kernels.

The layout mirrors `repro` (the JAX package, which stays the reference):

    codecs/    codec registry + self-describing container (all eight ids)
    core/      dual-quant, canonical Huffman, stages, compressor, metrics,
               zfp transform, KV-cache codec layer
    io/        async writer + sharded checkpoints
    dist/      shard planning
    kernels/   dispatch layer + one ops/ref pair per CUDA kernel
    csrc/      the CUDA C++ sources, built with nvcc at first use
    data/      synthetic SDRBench-like fields (numpy copy of the reference)

Entry points run on the device of their input: a CUDA tensor goes through
the CUDA kernels, a CPU tensor through the plain PyTorch versions.  Numpy
input and packed containers go to CUDA unless the caller passes
``device="cpu"``.
"""
