"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the yardstick of every roofline
share the benchmark reports.  A card set below 700 W runs slower under
load: the run prints its power limit beside the shares."""

#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: bf16 / fp16 dense tensor-core FLOP per second (the `mfu` of model cells)
BF16_FLOPS = 989e12
#: float32 FLOP per second outside the tensor cores
FP32_FLOPS = 67e12
#: last-level (L2) cache bytes
L2_BYTES = 50 * 2 ** 20
