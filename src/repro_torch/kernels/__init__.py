"""Hand-written CUDA kernels for the cuSZ hot path, each with ops.py (the
dispatching wrapper that launches the kernel and counts its launches) and
ref.py (the plain PyTorch version, used for CPU tensors and as the oracle
the kernel is held against on the card).  `dispatch` is the policy layer;
`_build` compiles `csrc/*.cu` with nvcc at first use.
"""
from . import dispatch  # noqa: F401  (import first: ops modules register)
from . import (bitshuffle, deflate, encode, histogram,  # noqa: F401
               huffman, inflate, interp, lorenzo)
