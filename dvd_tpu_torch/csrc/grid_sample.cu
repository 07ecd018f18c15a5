// K3: bilinear gather and K4: its coordinate gradient, align_corners=True,
// 'zeros' (per-corner validity) or 'border' padding, f32.
//
// K3 replaces dvd_tpu/ops/pallas/grid_sample.py: gather_bilinear_planar
// (_gather_kernel): a planar image (N, C, H, W) sampled at N x P x Q points
// -> (N, C, P, Q).  The points come either as the [-1, 1] grid (N, P, Q, 2),
// x then y interleaved, unnormalised inside the kernel (the entry of
// grid_sample, warp and warp_const_src), or as the pixel-coordinate planes
// gx, gy (N, P, Q) of the Pallas kernel's own contract.  One kernel body
// serves both: only the coordinate loader differs.
//
// K4 replaces gather_bilinear_grad_planar (_gather_grad_kernel): the
// gradient of sum(ct * K3(img, grid)) with respect to the [-1, 1] grid,
// (N, P, Q, 2), the factor 0.5 * (size - 1) of the unnormalisation applied
// inside:
//   d/dgx = 0.5 (W - 1) sum_c ct_c sum_{dy,dx} wy[dy] dwx[dx] I_c[corner]
//   d/dgy = 0.5 (H - 1) sum_c ct_c sum_{dy,dx} dwy[dy] wx[dx] I_c[corner]
// with dwx = [-vx0, +vx1] in 'zeros' mode (the validity masks are constant
// in the coordinates) and [-1, +1] in 'border'.  No image gradient: the
// source of the training loss's warp is data.
//
// What bounds them on the H100: bytes.  Per output point K3 reads 8 bytes
// of coordinates and writes 4 bytes per channel; the four corners of a
// smooth flow come from L1/L2 (a 64^2 x 256-channel source is 16 KB per
// channel and 4 MB per image, well inside the 50 MB L2).  At the sampler's
// feature re-warp, (8, 256, 64, 64), that is 33.5 MB in, 33.5 MB out:
// 0.020 ms at 3.35 TB/s.  K4 reads the coordinates, the cotangent and the
// corners and writes 8 bytes per point: 0.025 ms at the loss's
// (10, 2, 512, 512).
//
// Design.  The first port ran one thread per output point and walked C at
// run time: at the re-warp that is 32K threads, one block per SM, each
// thread's 256 channel steps waiting on the previous step's four loads --
// bound by latency, at 15% of the byte bound.  Here the grid is (point
// tiles, channel groups, N): a thread owns PIX (2 or 4) adjacent output
// points and G channels (a template parameter: 1-4 for the few-channel
// images, 8 for feature maps).  It loads its coordinates as vectors,
// decomposes each point once, issues all 4 G corner loads through the
// read-only path before the first product, and stores each channel's
// PIX results as one vector.  The host picks G from C and PIX from the
// size of the launch (2 where 4 would leave fewer than two waves of
// blocks), so the re-warp runs 524K threads in 2048 blocks.
//
// Shared memory and TMA: skipped.  The corners of a point are
// data-dependent addresses, which a TMA box cannot express, and a
// channel's plane is read by every point of the plane with little reuse
// per block; staging a 16 KB plane per block would read more bytes into
// shared memory than the block writes.  The 50 MB L2 holds the whole
// source of every main-path shape, so the read-only cache path is the
// staging.  K4: the same layout, C a template parameter (1-4, a loop
// above that), the cotangent loaded as vectors beside the coordinates,
// both sums in registers, no atomics (deterministic).
#include "bilinear.cuh"

namespace {

using dvd::kGatherThreads;

template <int G, int PIX, bool kZeros, int kGrid>
__global__ void __launch_bounds__(kGatherThreads) gather_bilinear_kernel(
    const float* __restrict__ img, const float* __restrict__ ca,
    const float* __restrict__ cb, float* __restrict__ out, int C, int H,
    int W, int PQ, float hx, float hy, int vec) {
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * G;
  const int pix0 = (blockIdx.x * kGatherThreads + threadIdx.x) * PIX;
  if (pix0 >= PQ) return;
  const int valid = min(PIX, PQ - pix0);
  const bool vfull = vec && valid == PIX;
  float x[PIX], y[PIX];
  dvd::load_coords<PIX, kGrid>(ca, cb, (long long)n * PQ + pix0, valid, vfull,
                               hx, hy, x, y);
  const long long hw = (long long)H * W;
  const float* src = img + ((long long)n * C + c0) * hw;
  float res[G][PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const dvd::Corners k = dvd::corners<kZeros>(x[p], y[p], H, W);
    float v[G][4];
    // every corner load of the group first, then the products
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (G == 1 || c0 + g < C) {
        const float* pl = src + g * hw;
        v[g][0] = __ldg(pl + k.o00);
        v[g][1] = __ldg(pl + k.o01);
        v[g][2] = __ldg(pl + k.o10);
        v[g][3] = __ldg(pl + k.o11);
      } else {
        v[g][0] = v[g][1] = v[g][2] = v[g][3] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      res[g][p] = dvd::blend(k, v[g][0], v[g][1], v[g][2], v[g][3]);
  }
  float* dst = out + ((long long)n * C + c0) * PQ + pix0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (G > 1 && c0 + g >= C) break;
    if (vfull) {
      dvd::store_vec<PIX>(dst + (long long)g * PQ, res[g]);
    } else {
#pragma unroll
      for (int p = 0; p < PIX; ++p)
        if (p < valid) dst[(long long)g * PQ + p] = res[g][p];
    }
  }
}

// one channel's contribution to both coordinate sums of one point
__device__ __forceinline__ void grad_terms(const dvd::Taps& t, float v00,
                                           float v01, float v10, float v11,
                                           float& sx, float& sy) {
  // dwx = [-vx0, vx1], dwy = [-vy0, vy1] (vx = vy = 1 in 'border' mode);
  // the weight products first, then times the corner, in the reference's
  // corner order
  const float ax0 = __fmul_rn(t.wy0, -t.vx0), ax1 = __fmul_rn(t.wy0, t.vx1);
  const float ax2 = __fmul_rn(t.wy1, -t.vx0), ax3 = __fmul_rn(t.wy1, t.vx1);
  const float ay0 = __fmul_rn(-t.vy0, t.wx0), ay1 = __fmul_rn(-t.vy0, t.wx1);
  const float ay2 = __fmul_rn(t.vy1, t.wx0), ay3 = __fmul_rn(t.vy1, t.wx1);
  sx = __fmul_rn(v00, ax0);
  sx = __fadd_rn(sx, __fmul_rn(v01, ax1));
  sx = __fadd_rn(sx, __fmul_rn(v10, ax2));
  sx = __fadd_rn(sx, __fmul_rn(v11, ax3));
  sy = __fmul_rn(v00, ay0);
  sy = __fadd_rn(sy, __fmul_rn(v01, ay1));
  sy = __fadd_rn(sy, __fmul_rn(v10, ay2));
  sy = __fadd_rn(sy, __fmul_rn(v11, ay3));
}

// CT: C as a template parameter (1-4), or 0 for a run-time loop over C
template <int CT, int PIX, bool kZeros>
__global__ void __launch_bounds__(kGatherThreads) gather_bilinear_grad_kernel(
    const float* __restrict__ img, const float* __restrict__ grid,
    const float* __restrict__ ct, float* __restrict__ gg, int C, int H, int W,
    int PQ, float hx, float hy, int vec) {
  const int n = blockIdx.y;
  const int pix0 = (blockIdx.x * kGatherThreads + threadIdx.x) * PIX;
  if (pix0 >= PQ) return;
  const int valid = min(PIX, PQ - pix0);
  const bool vfull = vec && valid == PIX;
  float x[PIX], y[PIX];
  dvd::load_coords<PIX, 1>(grid, nullptr, (long long)n * PQ + pix0, valid,
                           vfull, hx, hy, x, y);
  const long long hw = (long long)H * W;
  const float* src = img + (long long)n * C * hw;
  const float* cot = ct + (long long)n * C * PQ + pix0;
  float res[2 * PIX];
  if constexpr (CT > 0) {
    float g[CT][PIX];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (vfull) {
        dvd::load_vec<PIX>(cot + (long long)c * PQ, g[c]);
      } else {
#pragma unroll
        for (int p = 0; p < PIX; ++p)
          g[c][p] = p < valid ? __ldg(cot + (long long)c * PQ + p) : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const dvd::Taps t = dvd::taps<kZeros>(x[p], y[p], H, W);
      const int o00 = t.y0 * W + t.x0, o01 = t.y0 * W + t.x1;
      const int o10 = t.y1 * W + t.x0, o11 = t.y1 * W + t.x1;
      float v[CT][4];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float* pl = src + c * hw;
        v[c][0] = __ldg(pl + o00);
        v[c][1] = __ldg(pl + o01);
        v[c][2] = __ldg(pl + o10);
        v[c][3] = __ldg(pl + o11);
      }
      float accx = 0.f, accy = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float sx, sy;
        grad_terms(t, v[c][0], v[c][1], v[c][2], v[c][3], sx, sy);
        accx = __fadd_rn(accx, __fmul_rn(g[c][p], sx));
        accy = __fadd_rn(accy, __fmul_rn(g[c][p], sy));
      }
      res[2 * p] = __fmul_rn(accx, hx);
      res[2 * p + 1] = __fmul_rn(accy, hy);
    }
  } else {
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const dvd::Taps t = dvd::taps<kZeros>(x[p], y[p], H, W);
      const int o00 = t.y0 * W + t.x0, o01 = t.y0 * W + t.x1;
      const int o10 = t.y1 * W + t.x0, o11 = t.y1 * W + t.x1;
      float accx = 0.f, accy = 0.f;
      if (p < valid) {
        for (int c = 0; c < C; ++c) {
          const float* pl = src + c * hw;
          const float g = __ldg(cot + (long long)c * PQ + p);
          float sx, sy;
          grad_terms(t, __ldg(pl + o00), __ldg(pl + o01), __ldg(pl + o10),
                     __ldg(pl + o11), sx, sy);
          accx = __fadd_rn(accx, __fmul_rn(g, sx));
          accy = __fadd_rn(accy, __fmul_rn(g, sy));
        }
      }
      res[2 * p] = __fmul_rn(accx, hx);
      res[2 * p + 1] = __fmul_rn(accy, hy);
    }
  }
  float* dst = gg + ((long long)n * PQ + pix0) * 2;
  if (vfull) {
#pragma unroll
    for (int i = 0; i < PIX / 2; ++i) dvd::store_vec<4>(dst + 4 * i, res + 4 * i);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * PIX; ++i)
      if (i < 2 * valid) dst[i] = res[i];
  }
}

// The launch plan of K3: G channels per thread (C itself up to 4, else
// 8), ceil(C / G) channel groups, PIX points per thread (4, or 2 where 4
// would give fewer than two waves of 256-thread blocks on 132 SMs), and
// the blocks along the points.
struct GatherPlan {
  int g, pix, groups, blocks;
};

constexpr long long kTwoWaves = 2LL * 132 * 2048;

GatherPlan gather_plan(int N, int C, long long PQ) {
  GatherPlan p;
  p.g = C <= 4 ? C : 8;
  p.groups = (C + p.g - 1) / p.g;
  p.pix = (long long)N * p.groups * ((PQ + 3) / 4) >= kTwoWaves ? 4 : 2;
  p.blocks = dvd::ceil_div(PQ, (long long)kGatherThreads * p.pix);
  return p;
}

struct GatherArgs {
  const float *img, *ca, *cb;
  float* out;
  int C, H, W, PQ;
  float hx, hy;
  int vec;
};

template <int G, int PIX>
void launch_gather(const GatherArgs& a, bool zeros, bool grid, dim3 blocks,
                   cudaStream_t s) {
#define DVD_GATHER(Z, GR)                                                     \
  gather_bilinear_kernel<G, PIX, Z, GR><<<blocks, kGatherThreads, 0, s>>>(    \
      a.img, a.ca, a.cb, a.out, a.C, a.H, a.W, a.PQ, a.hx, a.hy, a.vec)
  if (zeros) {
    if (grid) DVD_GATHER(true, 1); else DVD_GATHER(true, 0);
  } else {
    if (grid) DVD_GATHER(false, 1); else DVD_GATHER(false, 0);
  }
#undef DVD_GATHER
}

template <int G>
void launch_gather_g(const GatherArgs& a, bool zeros, bool grid, int pix,
                     dim3 blocks, cudaStream_t s) {
  if (pix == 4)
    launch_gather<G, 4>(a, zeros, grid, blocks, s);
  else
    launch_gather<G, 2>(a, zeros, grid, blocks, s);
}

template <int CT, int PIX>
void launch_grad(const float* img, const float* grid, const float* ct,
                 float* gg, int C, int H, int W, int PQ, float hx, float hy,
                 int vec, bool zeros, dim3 blocks, cudaStream_t s) {
  if (zeros)
    gather_bilinear_grad_kernel<CT, PIX, true><<<blocks, kGatherThreads, 0, s>>>(
        img, grid, ct, gg, C, H, W, PQ, hx, hy, vec);
  else
    gather_bilinear_grad_kernel<CT, PIX, false><<<blocks, kGatherThreads, 0, s>>>(
        img, grid, ct, gg, C, H, W, PQ, hx, hy, vec);
}

template <int CT>
void launch_grad_c(const float* img, const float* grid, const float* ct,
                   float* gg, int C, int H, int W, int PQ, float hx, float hy,
                   int vec, bool zeros, int pix, dim3 blocks, cudaStream_t s) {
  if (pix == 4)
    launch_grad<CT, 4>(img, grid, ct, gg, C, H, W, PQ, hx, hy, vec, zeros,
                       blocks, s);
  else
    launch_grad<CT, 2>(img, grid, ct, gg, C, H, W, PQ, hx, hy, vec, zeros,
                       blocks, s);
}

bool sizes_ok(int N, int C, int H, int W, long long PQ) {
  return N > 0 && C > 0 && H > 0 && W > 0 && PQ > 0 && N <= 65535 &&
         (long long)H * W < (1LL << 31) && PQ < (1LL << 31) - 8;
}

}  // namespace

// K3's plan for (N, C, P * Q): out[0..3] = G, PIX, groups, blocks.
extern "C" int dvd_gather_bilinear_plan(int N, int C, long long PQ, int* out) {
  const GatherPlan p = gather_plan(N, C, PQ);
  out[0] = p.g;
  out[1] = p.pix;
  out[2] = p.groups;
  out[3] = p.blocks;
  return 0;
}

// K3.  grid != 0: ``ca`` is the [-1, 1] grid (N, P, Q, 2) and ``cb`` is
// unused; else ``ca``, ``cb`` are the pixel-coordinate planes gx, gy
// (N, P, Q).  vec != 0: every pointer 16-byte aligned and P * Q % 4 == 0.
extern "C" int dvd_gather_bilinear(const void* img, const void* ca,
                                   const void* cb, void* out, int N, int C,
                                   int H, int W, long long P, long long Q,
                                   int zeros, int grid, int vec, void* stream) {
  const long long pq = P * Q;
  if (!sizes_ok(N, C, H, W, pq)) return (int)cudaErrorInvalidValue;
  const GatherPlan p = gather_plan(N, C, pq);
  if (p.groups > 65535) return (int)cudaErrorInvalidValue;
  const GatherArgs a{(const float*)img, (const float*)ca, (const float*)cb,
                     (float*)out, C, H, W, (int)pq, 0.5f * (float)(W - 1),
                     0.5f * (float)(H - 1), vec};
  const dim3 blocks(p.blocks, p.groups, N);
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.g) {
    case 1: launch_gather_g<1>(a, zeros, grid, p.pix, blocks, s); break;
    case 2: launch_gather_g<2>(a, zeros, grid, p.pix, blocks, s); break;
    case 3: launch_gather_g<3>(a, zeros, grid, p.pix, blocks, s); break;
    case 4: launch_gather_g<4>(a, zeros, grid, p.pix, blocks, s); break;
    default: launch_gather_g<8>(a, zeros, grid, p.pix, blocks, s); break;
  }
  return (int)cudaGetLastError();
}

// K4: img (N, C, H, W), grid (N, P, Q, 2) in [-1, 1], ct (N, C, P, Q) ->
// gg (N, P, Q, 2), all float32.  vec as K3's.
extern "C" int dvd_gather_bilinear_grad(const void* img, const void* grid,
                                        const void* ct, void* gg, int N, int C,
                                        int H, int W, long long P, long long Q,
                                        int zeros, int vec, void* stream) {
  const long long pq = P * Q;
  if (!sizes_ok(N, C, H, W, pq)) return (int)cudaErrorInvalidValue;
  const int pix = (long long)N * ((pq + 3) / 4) >= kTwoWaves ? 4 : 2;
  const dim3 blocks(dvd::ceil_div(pq, (long long)kGatherThreads * pix), N);
  const float hx = 0.5f * (float)(W - 1), hy = 0.5f * (float)(H - 1);
  const float *im = (const float*)img, *gr = (const float*)grid,
              *co = (const float*)ct;
  float* o = (float*)gg;
  cudaStream_t s = (cudaStream_t)stream;
  const bool z = zeros != 0;
  switch (C) {
    case 1: launch_grad_c<1>(im, gr, co, o, C, H, W, (int)pq, hx, hy, vec, z, pix, blocks, s); break;
    case 2: launch_grad_c<2>(im, gr, co, o, C, H, W, (int)pq, hx, hy, vec, z, pix, blocks, s); break;
    case 3: launch_grad_c<3>(im, gr, co, o, C, H, W, (int)pq, hx, hy, vec, z, pix, blocks, s); break;
    case 4: launch_grad_c<4>(im, gr, co, o, C, H, W, (int)pq, hx, hy, vec, z, pix, blocks, s); break;
    default: launch_grad_c<0>(im, gr, co, o, C, H, W, (int)pq, hx, hy, vec, z, pix, blocks, s); break;
  }
  return (int)cudaGetLastError();
}

// Error text for the codes the entry points return (read by the wrappers).
extern "C" const char* dvd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
