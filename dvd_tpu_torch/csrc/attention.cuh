// Building blocks shared by the two K1 kernels (attention_wgmma.cu,
// bf16; attention_f32x6.cu, f32): the (b, h, t) strides, the swizzled
// bf16 tile layout their descriptors name, P.V's wgmma with A from
// registers and an MN-major B, and exp2.
#pragma once

#include "hopper.cuh"

namespace dvd {

struct Strides {
  long long b, h, t;
};

// Shared-memory layout of a bf16 tile of R rows x DH columns: DH / kCols
// column blocks, each R rows of kRowBytes, 16-byte chunks swizzled within
// each 8-row atom as the wgmma descriptors' swizzle mode says.  Dh 16 and
// 32 take blocks of 16 columns (32-byte rows, the 32-byte swizzle): a
// 32-wide row is two such blocks, each a k16 step of S and an n16 product
// of P V, so both head dims use the one small-block layout.  Dh 72
// (DiT-XL/2's 16 heads of 72; bf16 kernel only) is one 64-column block
// followed by a tail: a 16-column block in the 32-byte swizzle whose
// columns 72-79 the kernel zeroes and the copies never write, so the
// tail is one k16 step of S and one n16 product of P V.
template <int DH>
struct Layout {
  static_assert(DH % 64 == 0 || DH == 16 || DH == 32 || DH == 72,
                "64-column blocks, or 16-column ones at Dh 16 and 32, or "
                "one 64-column block and a 16-column tail at Dh 72");
  static constexpr int kRowBytes = DH >= 64 ? 128 : 32;
  static constexpr int kCols = kRowBytes / 2;  // columns per block
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr uint64_t kMode = DH >= 64 ? 1 : 3;  // 128- or 32-byte swizzle
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // stride of 8-row groups
  static constexpr int kBlocks = DH / kCols;        // full blocks
  static constexpr int kTail = DH % kCols;          // the tail's data columns (8 or 0)
  static constexpr int kPadded = kBlocks * kCols + (kTail ? 16 : 0);  // columns in smem
  static constexpr uint64_t kTailMode = 3;          // the tail's 32-byte swizzle
  static constexpr uint32_t kTailAtom = 8 * 32;     // its 8-row groups

  // byte offset of the tail's chunk c (0: data, 1: the zeroed columns) of
  // row r in a tile of R rows
  template <int R>
  static __device__ __forceinline__ uint32_t tail_offset(int r, int c) {
    const uint32_t o = r * 32 + c * 16;
    return kBlocks * (R * kRowBytes) + (o ^ (((o >> 7) & 1) << 4));
  }

  // byte offset of chunk c (8 columns) of row r in a tile of R rows
  template <int R>
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    if constexpr (kTail != 0)
      if (c == kBlocks * kChunks) return tail_offset<R>(r, 0);
    const uint32_t o = r * kRowBytes + (c % kChunks) * 16;
    return (c / kChunks) * (R * kRowBytes) + (o ^ (((o >> 7) & (kChunks - 1)) << 4));
  }
};

// the head dims both kernels have an instance for; the bf16 kernel adds 72
// (attention_wgmma.cu)
#define DVD_FOR_EACH_DH(X) X(16) X(32) X(64) X(128) X(192) X(256)

#define DVD_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) = A (64 x 16, bf16 registers) B (16 x 64, smem, MN-major)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DVD_D8(0), DVD_D8(8), DVD_D8(16), DVD_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 16, f32) = A (64 x 16, bf16 registers) B (16 x 16, smem, MN-major)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                             uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : DVD_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef DVD_D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace dvd
