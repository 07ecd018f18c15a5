// Shared helpers for the dvd_tpu_torch Hopper kernels.
//
// Every kernel library entry point has a plain C signature (loaded with
// ctypes): raw device pointers, sizes, a dtype code and the CUDA stream.
// It returns cudaGetLastError() right after the launch, so a launch that
// CUDA refuses (too many threads, too much shared memory) reaches the
// Python wrapper as a nonzero code instead of passing silently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dvd {

// dtype codes shared with dvd_tpu_torch/ops/kernels/build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace dvd
