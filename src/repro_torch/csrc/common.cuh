// Shared helpers for the repro_torch CUDA kernels.
//
// Every entry point is a plain C function: it takes raw device pointers
// and the caller's stream (PyTorch's current stream), launches without
// synchronising, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

static inline long long rt_cdiv(long long a, long long b) {
    return (a + b - 1) / b;
}

// Make `device` current for this library's CUDA runtime.  The runtime is
// linked statically, so its current device is its own: PyTorch's does not
// carry over, and every entry point takes the device of its tensors.
static inline cudaError_t rt_use_device(int device) {
    return cudaSetDevice(device);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static inline cudaError_t rt_allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
