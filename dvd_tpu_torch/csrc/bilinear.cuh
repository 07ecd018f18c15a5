// Device helpers shared by K3 (grid_sample.cu: the gather and its
// coordinate gradient K4) and the fused unwarp (unwarp.cu).
//
// Semantics are dvd_tpu/ops/grid_sample.py's (align_corners=True): the
// floor of the pixel coordinate, the clamp of the corner to [-2, size]
// before the int conversion (a far-out coordinate must not overflow int,
// and a corner out of range stays out of range), the corner order (y0 x0,
// y0 x1, y1 x0, y1 x1), the weight products and, in 'zeros' mode, the
// per-corner validity masks.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn): nvcc would otherwise contract them into FMAs,
// and the plain twins round each tensor operation separately.
#pragma once

#include "common.cuh"

namespace dvd {

constexpr int kGatherThreads = 256;

// The four corners of one sample point: offsets y * W + x into an H x W
// plane (clamped into it, so every address is safe) and their weights.
struct Corners {
  int o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

// The decomposition shared by the gather and its gradient: clamped corner
// indices, fractional weights and, in 'zeros' mode, per-axis validity.
struct Taps {
  int x0, x1, y0, y1;               // clamped into the plane
  float wx0, wx1, wy0, wy1;         // weights, validity-masked in 'zeros'
  float vx0, vx1, vy0, vy1;         // validity (1 in 'border' mode)
};

template <bool kZeros>
__device__ __forceinline__ Taps taps(float x, float y, int H, int W) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f), ty = __fsub_rn(y, y0f);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const int x1 = x0 + 1, y1 = y0 + 1;
  Taps t;
  t.vx0 = t.vx1 = t.vy0 = t.vy1 = 1.f;
  if (kZeros) {
    t.vx0 = (x0 >= 0 && x0 < W) ? 1.f : 0.f;
    t.vx1 = (x1 >= 0 && x1 < W) ? 1.f : 0.f;
    t.vy0 = (y0 >= 0 && y0 < H) ? 1.f : 0.f;
    t.vy1 = (y1 >= 0 && y1 < H) ? 1.f : 0.f;
  }
  t.wx0 = __fmul_rn(__fsub_rn(1.f, tx), t.vx0);
  t.wx1 = __fmul_rn(tx, t.vx1);
  t.wy0 = __fmul_rn(__fsub_rn(1.f, ty), t.vy0);
  t.wy1 = __fmul_rn(ty, t.vy1);
  t.x0 = min(max(x0, 0), W - 1);
  t.x1 = min(max(x1, 0), W - 1);
  t.y0 = min(max(y0, 0), H - 1);
  t.y1 = min(max(y1, 0), H - 1);
  return t;
}

template <bool kZeros>
__device__ __forceinline__ Corners corners(float x, float y, int H, int W) {
  const Taps t = taps<kZeros>(x, y, H, W);
  Corners k;
  k.o00 = t.y0 * W + t.x0;
  k.o01 = t.y0 * W + t.x1;
  k.o10 = t.y1 * W + t.x0;
  k.o11 = t.y1 * W + t.x1;
  k.w00 = __fmul_rn(t.wy0, t.wx0);
  k.w01 = __fmul_rn(t.wy0, t.wx1);
  k.w10 = __fmul_rn(t.wy1, t.wx0);
  k.w11 = __fmul_rn(t.wy1, t.wx1);
  return k;
}

// sum over the corners in the reference's order, each product rounded
__device__ __forceinline__ float blend(const Corners& k, float v00, float v01,
                                       float v10, float v11) {
  float acc = __fmul_rn(v00, k.w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, k.w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, k.w10));
  return __fadd_rn(acc, __fmul_rn(v11, k.w11));
}

// [-1, 1] -> pixel coordinate, align_corners=True, as ops/grid_sample.py:
// (g + 1) * 0.5 * (size - 1).  ``half`` is 0.5 * (size - 1), exact in f32,
// and halving is exact, so (g + 1) * half rounds to the same value.
__device__ __forceinline__ float unnormalize(float g, float half) {
  return __fmul_rn(__fadd_rn(g, 1.f), half);
}

// vectors of PIX floats (2 or 4): loads through the read-only path
__device__ __forceinline__ void unpack(float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(float2 v, float* o) {
  o[0] = v.x; o[1] = v.y;
}

template <int PIX>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (PIX == 4) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), o);
  } else {
    unpack(__ldg(reinterpret_cast<const float2*>(p)), o);
  }
}

template <int PIX>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (PIX == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The pixel coordinates of PIX adjacent output pixels starting at flat
// index ``first`` of an (N, P, Q) plane; ``valid`` of them exist (the
// rest read as 0, a safe coordinate).  kGrid: the interleaved [-1, 1] grid
// (N, P, Q, 2), unnormalised here with ``hx``/``hy`` = 0.5 * (size - 1);
// else the pixel-coordinate planes ``a`` = gx and ``b`` = gy.  ``vec``:
// every address 16-byte aligned and valid == PIX.
template <int PIX, int kGrid>
__device__ __forceinline__ void load_coords(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            long long first, int valid,
                                            bool vec, float hx, float hy,
                                            float* x, float* y) {
  if constexpr (kGrid) {
    float v[2 * PIX];
    const float* g = a + first * 2;
    if (vec) {
#pragma unroll
      for (int i = 0; i < PIX / 2; ++i) load_vec<4>(g + 4 * i, v + 4 * i);
    } else {
#pragma unroll
      for (int i = 0; i < 2 * PIX; ++i) v[i] = i < 2 * valid ? __ldg(g + i) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      x[p] = unnormalize(v[2 * p], hx);
      y[p] = unnormalize(v[2 * p + 1], hy);
    }
  } else {
    if (vec) {
      load_vec<PIX>(a + first, x);
      load_vec<PIX>(b + first, y);
    } else {
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        x[p] = p < valid ? __ldg(a + first + p) : 0.f;
        y[p] = p < valid ? __ldg(b + first + p) : 0.f;
      }
    }
  }
}

}  // namespace dvd
