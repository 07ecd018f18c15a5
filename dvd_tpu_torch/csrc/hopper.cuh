// Hopper building blocks shared by the tensor-core kernels
// (attention_wgmma.cu, conv3x3_wgmma.cu and their f32 counterparts
// attention_f32x6.cu, conv3x3_f32x6.cu): cp.async copies, the async-proxy
// fence, wgmma's fences and groups, shared-memory matrix descriptors, bf16
// packing and the three-way bf16 split of f32 values.
#pragma once

#include "common.cuh"

namespace dvd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4, 8 or 16) bytes; src_bytes 0 fills them with zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the copies landed through the generic proxy; wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across the
// asynchronous wgmma boundaries
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (0: none, 1: 128-byte,
// 3: 32-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 pair (a, b) as three packed bf16 pairs h + m + l, each half as
// pack_bf16 lays it out: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m),
// rounded to nearest.  Both differences are exact in f32, and h + m + l ==
// x exactly for |x| in [2^-100, 2^100] (ops/kernels/conv3x3.py:split3_bf16 is
// the same arithmetic in torch).
__device__ __forceinline__ void split3_pack(float a, float b, uint32_t& h,
                                            uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hv);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 mv = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(mv);
  h = bf16x2_bits(hv);
  m = bf16x2_bits(mv);
  l = bf16x2_bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

}  // namespace dvd
