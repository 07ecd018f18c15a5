// The fused unwarp: K3's gather with the whole coordinate build in front of
// it and the output conversion behind it, one kernel per batch.
//
// Replaces, on the card, what the JAX package computes around the TPU
// kernel dvd_tpu/ops/pallas/grid_sample.py: gather_bilinear_planar (:122)
// in dvd_tpu/evaluation/pipeline.py: unwarp_native and unwarp_fixed.  Per
// output pixel (i, j) of image b, with (h, w) the page's size:
//   1. the flow (S, S, 2) upsampled to (h, w) at (i, j), align_corners=True
//      with the border clamp, as two two-tap lerps (rows, then columns);
//      native: the f32 taps of evaluation/pipeline.py: _upsample_axis;
//      fixed: the taps of ops/resize.py's interpolation matrices (built in
//      f64, rounded to f32);
//   2. the grid ((f + base) * 2 - 1) * shrink, base = (j / (w - 1),
//      i / (h - 1)) (native: f32 division; fixed: utils/grids.py's f64
//      linspace rounded to f32);
//   3. native only: that grid mapped from [-1, 1]-in-(h, w) into the
//      (Hc, Wc) canvas, (g + 1) * (w - 1) / (Wc - 1) - 1;
//   4. the unnormalisation (g + 1) * 0.5 * (size - 1);
//   5. K3's 'zeros' gather from the NHWC source (uint8 or f32), whose C
//      values of a corner are adjacent;
//   6. an NHWC output: f32, or uint8 as evaluation/driver.py: unwarp_u8
//      (rintf, round half to even as torch.round, then the clamp to
//      [0, 255]).
// Every coordinate step rounds as the plain composition's tensor
// operations do (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction),
// so the native coordinates equal the plain ones.
//
// What bounds it on the H100: bytes.  At the dataset path's batch,
// (4, 2048, 2048, 3) uint8 in and out and a (4, 64, 64, 2) flow, each read
// or written once is 100.7 MB: 0.030 ms at 3.35 TB/s.  The unfused path
// made (B, P, S, 2) and (B, P, P, 2) gathers of the flow, about eight
// elementwise passes over (B, P, P) f32 planes, an f32 NCHW copy of the
// source and a uint8 pass of the output: about 1.5 GB of traffic in about
// 20 launches.
//
// Design: a block stages its image's flow (32 KB at S = 64) in shared
// memory once and walks the image (one wave of resident blocks over the
// batch, from the occupancy API), each thread 4 adjacent pixels of one row:
// the row's taps and base once, each pixel's column taps, lerps and
// coordinates in registers, the 4 x C corner loads through the read-only
// path, and the 4 x C outputs stored as 32-bit words (uint8) or 16-byte
// vectors (f32) where the row width is a multiple of 4.  All index
// arithmetic is 32-bit (the first version divided 64-bit flat indices,
// which the card emulates, for every pixel).  Nothing but the output
// touches device memory.
#include <algorithm>

#include "bilinear.cuh"

namespace {

using dvd::kGatherThreads;

constexpr int kPix = 4;   // adjacent pixels of one row per thread

// Flow taps of canvas position ``pos`` on an axis of ``size`` page pixels
// upsampled from the flow's S samples: indices i0, i1 and weights w0, w1.
template <int kNative>
__device__ __forceinline__ void axis_taps(int pos, int size, int S, int& i0,
                                          int& i1, float& w0, float& w1) {
  if constexpr (kNative) {
    float src = __fdiv_rn(__fmul_rn((float)pos, (float)(S - 1)),
                          __fsub_rn((float)size, 1.f));
    src = fminf(fmaxf(src, 0.f), (float)(S - 1));
    const float f0 = floorf(src);
    const float frac = __fsub_rn(src, f0);
    i0 = (int)f0;
    i1 = min(i0 + 1, S - 1);
    w0 = __fsub_rn(1.f, frac);
    w1 = frac;
  } else {
    if (S == 1) {
      i0 = i1 = 0;
      w0 = 1.f;
      w1 = 0.f;
      return;
    }
    const double src =
        size == 1 ? 0.0 : (double)((long long)pos * (S - 1)) / (double)(size - 1);
    const int lo = min((int)floor(src), S - 1);
    const int hi = min(lo + 1, S - 1);
    const double frac = src - (double)lo;
    i0 = lo;
    i1 = hi;
    if (lo == hi) {   // the matrix's two taps fall on one entry
      w0 = (float)((1.0 - frac) + frac);
      w1 = 0.f;
    } else {
      w0 = (float)(1.0 - frac);
      w1 = (float)frac;
    }
  }
}

// utils/grids.py: base_grid: torch.linspace(0, 1, n) in f64 (the half
// below n / 2 from the start, the rest from the end), rounded to f32
__device__ __forceinline__ float linspace01(int i, int n) {
  if (n == 1) return 0.f;
  const double step = 1.0 / (double)(n - 1);
  const double v = i < n / 2 ? step * (double)i : 1.0 - step * (double)(n - 1 - i);
  return (float)v;
}

__device__ __forceinline__ float load_in(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_in(const unsigned char* p) {
  return (float)__ldg(p);
}

// uint8 out: round half to even, clamp to [0, 255], cast
__device__ __forceinline__ unsigned char to_u8(float v) {
  return (unsigned char)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(unsigned char* p, float v) { *p = to_u8(v); }

// the 4 x C results of one thread as whole words: C 16-byte vectors (f32)
// or C 32-bit words (uint8)
template <int C>
__device__ __forceinline__ void store_words(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < C; ++k) dvd::store_vec<4>(dst + 4 * k, v + 4 * k);
}
template <int C>
__device__ __forceinline__ void store_words(unsigned char* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const unsigned int word = (unsigned int)to_u8(v[4 * k]) |
                              ((unsigned int)to_u8(v[4 * k + 1]) << 8) |
                              ((unsigned int)to_u8(v[4 * k + 2]) << 16) |
                              ((unsigned int)to_u8(v[4 * k + 3]) << 24);
    reinterpret_cast<unsigned int*>(dst)[k] = word;
  }
}

template <typename Tin, typename Tout, int kNative, int C>
__global__ void __launch_bounds__(kGatherThreads) unwarp_kernel(
    const Tin* __restrict__ src, const float* __restrict__ flow,
    const int* __restrict__ hw, Tout* __restrict__ out, int S, int Hc, int Wc,
    float shrink, int vec) {
  extern __shared__ float sflow[];   // this image's (S, S, 2) flow
  const int b = blockIdx.y;
  const int n2 = S * S * 2;
  const float* fb = flow + (long long)b * n2;
  for (int i = threadIdx.x; i < n2; i += kGatherThreads) sflow[i] = fb[i];
  __syncthreads();

  const int h = kNative ? hw[2 * b] : Hc;
  const int w = kNative ? hw[2 * b + 1] : Wc;
  const float hm1 = __fsub_rn((float)h, 1.f), wm1 = __fsub_rn((float)w, 1.f);
  const float cx = (float)(Wc - 1), cy = (float)(Hc - 1);
  const float hx = 0.5f * cx, hy = 0.5f * cy;
  const long long npix = (long long)Hc * Wc;
  const Tin* img = src + (long long)b * npix * C;
  Tout* dimg = out + (long long)b * npix * C;

  // a thread's pixels are kPix adjacent ones of one row: the row's taps
  // and base are computed once, and every index fits 32 bits
  const int groups_per_row = (Wc + kPix - 1) / kPix;
  const int n_groups = Hc * groups_per_row;
  for (int gi = blockIdx.x * kGatherThreads + threadIdx.x; gi < n_groups;
       gi += gridDim.x * kGatherThreads) {
    const int i = gi / groups_per_row;
    const int j0 = (gi - i * groups_per_row) * kPix;
    const int valid = min(kPix, Wc - j0);
    int y0, y1;
    float wy0, wy1;
    axis_taps<kNative>(i, h, S, y0, y1, wy0, wy1);
    const float by = kNative ? __fdiv_rn((float)i, hm1) : linspace01(i, Hc);
    float res[kPix * C];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int j = j0 + (p < valid ? p : 0);
      int x0, x1;
      float wx0, wx1;
      axis_taps<kNative>(j, w, S, x0, x1, wx0, wx1);
      float g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // rows first, then columns
        const float r0 = __fadd_rn(__fmul_rn(sflow[(y0 * S + x0) * 2 + e], wy0),
                                   __fmul_rn(sflow[(y1 * S + x0) * 2 + e], wy1));
        const float r1 = __fadd_rn(__fmul_rn(sflow[(y0 * S + x1) * 2 + e], wy0),
                                   __fmul_rn(sflow[(y1 * S + x1) * 2 + e], wy1));
        const float fl = __fadd_rn(__fmul_rn(r0, wx0), __fmul_rn(r1, wx1));
        float base = by;
        if (e == 0)
          base = kNative ? __fdiv_rn((float)j, wm1) : linspace01(j, Wc);
        g[e] = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(fl, base), 2.f), 1.f),
                         shrink);
      }
      if constexpr (kNative) {   // [-1, 1] of the page -> of the canvas
        g[0] = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(g[0], 1.f), wm1), cx), 1.f);
        g[1] = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(g[1], 1.f), hm1), cy), 1.f);
      }
      const dvd::Corners k = dvd::corners<true>(dvd::unnormalize(g[0], hx),
                                                dvd::unnormalize(g[1], hy),
                                                Hc, Wc);
      float v[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c][0] = load_in(img + k.o00 * C + c);
        v[c][1] = load_in(img + k.o01 * C + c);
        v[c][2] = load_in(img + k.o10 * C + c);
        v[c][3] = load_in(img + k.o11 * C + c);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        res[p * C + c] = dvd::blend(k, v[c][0], v[c][1], v[c][2], v[c][3]);
    }
    Tout* dst = dimg + (i * Wc + j0) * C;
    if (vec && valid == kPix) {
      store_words<C>(dst, res);
    } else {
#pragma unroll
      for (int e = 0; e < kPix * C; ++e)
        if (e < valid * C) put(dst + e, res[e]);
    }
  }
}

template <typename Tin, typename Tout, int kNative>
cudaError_t launch_unwarp_c(const void* src, const float* flow, const int* hw,
                            void* out, int B, int Hc, int Wc, int C, int S,
                            float shrink, int vec, cudaStream_t s) {
  const size_t smem = (size_t)S * S * 2 * sizeof(float);
  const int groups = Hc * ((Wc + kPix - 1) / kPix);
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  // one wave of resident blocks over the batch (each block stages its
  // image's flow once and walks its image), fewer for a small image
#define DVD_UNWARP(CC)                                                        \
  do {                                                                        \
    auto kern = unwarp_kernel<Tin, Tout, kNative, CC>;                        \
    if (smem > 48 * 1024) {                                                   \
      cudaError_t e = cudaFuncSetAttribute(                                   \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
      if (e != cudaSuccess) return e;                                         \
    }                                                                         \
    int per_sm = 1;                                                           \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,              \
                                                  kGatherThreads, smem);      \
    const int per_image =                                                     \
        std::min(dvd::ceil_div(groups, kGatherThreads),                       \
                 dvd::ceil_div((long long)std::max(per_sm, 1) * sms, B));     \
    kern<<<dim3(per_image, B), kGatherThreads, smem, s>>>(                    \
        (const Tin*)src, flow, hw, (Tout*)out, S, Hc, Wc, shrink, vec);       \
  } while (0)
  switch (C) {
    case 1: DVD_UNWARP(1); break;
    case 3: DVD_UNWARP(3); break;
    case 4: DVD_UNWARP(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef DVD_UNWARP
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_unwarp(const void* src, const float* flow, const int* hw,
                          void* out, int out_u8, int native, int B, int Hc,
                          int Wc, int C, int S, float shrink, int vec,
                          cudaStream_t s) {
  if (native) {
    if (out_u8)
      return launch_unwarp_c<Tin, unsigned char, 1>(src, flow, hw, out, B, Hc,
                                                    Wc, C, S, shrink, vec, s);
    return launch_unwarp_c<Tin, float, 1>(src, flow, hw, out, B, Hc, Wc, C, S,
                                          shrink, vec, s);
  }
  if (out_u8) return cudaErrorInvalidValue;   // unwarp_fixed returns floats
  return launch_unwarp_c<Tin, float, 0>(src, flow, hw, out, B, Hc, Wc, C, S,
                                        shrink, vec, s);
}

}  // namespace

// The fused unwarp.  src (B, Hc, Wc, C) uint8 (src_u8) or f32; flow
// (B, S, S, 2) f32; native != 0: hw (B, 2) int32 gives each page's (h, w)
// inside the canvas, else the page is the whole (Hc, Wc) and hw is unused;
// out (B, Hc, Wc, C) uint8 (out_u8, native only) or f32.  C is 1, 3 or 4;
// vec != 0: every pointer 16-byte aligned and Wc % 4 == 0.
extern "C" int dvd_unwarp(const void* src, int src_u8, const void* flow,
                          const void* hw, void* out, int out_u8, int native,
                          int B, int Hc, int Wc, int C, int S, float shrink,
                          int vec, void* stream) {
  if (B <= 0 || B > 65535 || Hc <= 0 || Wc <= 0 || S <= 0 ||
      (long long)Hc * Wc * C >= (1LL << 31) ||
      (size_t)S * S * 2 * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fl = (const float*)flow;
  const int* h = (const int*)hw;
  cudaError_t err =
      src_u8 ? launch_unwarp<unsigned char>(src, fl, h, out, out_u8, native, B,
                                            Hc, Wc, C, S, shrink, vec, s)
             : launch_unwarp<float>(src, fl, h, out, out_u8, native, B, Hc, Wc,
                                    C, S, shrink, vec, s);
  return (int)err;
}
