// K3: bilinear gather, align_corners=True, 'zeros' or 'border' padding.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/grid_sample.py:
// gather_bilinear_planar (_gather_kernel).  Contract: a planar image
// (N, C, H, W) float32 and unnormalised pixel coordinates gx, gy (N, P, Q)
// float32 -> (N, C, P, Q) float32.  Corner weights are masked per corner
// by validity in 'zeros' mode; 'border' clamps the corner indices.
//
// What bounds it on the H100: bytes.  Per output pixel it reads 8 bytes of
// coordinates and 4 corners per channel, and writes 4 bytes per channel;
// there are ~8 FLOPs per channel.  At the slice's shapes (the 512^2 unwarp,
// (4, 3, 512, 512), ~25 MB of traffic, and the sampler's feature re-warp,
// (8, 256, 64, 64), ~70 MB) a smooth flow makes the corner reads hit L1/L2,
// so the floor is the coordinate read plus the output write.
//
// Design: one thread per output pixel, looping over C, so the coordinate
// decomposition, the corner indices and the four weights are computed once
// per pixel (as the TPU's _gather_kernel does for its gradient twin).
// Corners are read straight from global memory: a GPU gathers natively, so
// the TPU kernel's strip-mining over (8, 128) blocks and its tiling gates
// (P%8, Q%128, H%8, W%128, the plane-size cap) do not apply -- any shape
// is taken.  Neighbouring threads handle neighbouring output pixels, so
// the output stores and (for smooth flows) the corner loads coalesce.
#include "common.cuh"

namespace {

template <bool kZeros>
__global__ void __launch_bounds__(256) gather_bilinear_kernel(
    const float* __restrict__ img, const float* __restrict__ gx,
    const float* __restrict__ gy, float* __restrict__ out, int C, int H, int W,
    long long PQ) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = blockIdx.y;
  if (pix >= PQ) return;
  const float x = gx[n * PQ + pix];
  const float y = gy[n * PQ + pix];
  // floorf, not truncation: negative coordinates round down
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float tx = x - x0f;
  const float ty = y - y0f;
  // Clamp before the int conversion (a far-out coordinate must not
  // overflow int).  [-2, size] keeps every validity test below unchanged:
  // a corner that is out of range stays out of range.
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  float wx0 = 1.f - tx, wx1 = tx, wy0 = 1.f - ty, wy1 = ty;
  if (kZeros) {
    wx0 = (x0 >= 0 && x0 < W) ? wx0 : 0.f;
    wx1 = (x1 >= 0 && x1 < W) ? wx1 : 0.f;
    wy0 = (y0 >= 0 && y0 < H) ? wy0 : 0.f;
    wy1 = (y1 >= 0 && y1 < H) ? wy1 : 0.f;
  }
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
  const long long i00 = (long long)yc0 * W + xc0, i01 = (long long)yc0 * W + xc1;
  const long long i10 = (long long)yc1 * W + xc0, i11 = (long long)yc1 * W + xc1;
  // corner order and weight products follow dvd_tpu/ops/grid_sample.py
  const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
  const long long hw = (long long)H * W;
  const float* src = img + n * C * hw;
  float* dst = out + n * C * PQ + pix;
  for (int c = 0; c < C; ++c) {
    const float* p = src + c * hw;
    float acc = p[i00] * w00;
    acc += p[i01] * w01;
    acc += p[i10] * w10;
    acc += p[i11] * w11;
    dst[c * PQ] = acc;
  }
}

// K4: the gradient of K3's zeros/border gather with respect to the
// unnormalised coordinates, summed over C against the output cotangent.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/grid_sample.py:
// gather_bilinear_grad_planar (_gather_grad_kernel), the backward of the
// composed-warp training loss (ops/grid_sample.py: warp_const_src).
// Contract: img (N, C, H, W), gx, gy (N, P, Q), ct (N, C, P, Q), all
// float32 -> ggx, ggy (N, P, Q) float32:
//   ggx = sum_c ct_c * sum_{dy,dx} wy[dy] * dwx[dx] * I_c[corner]
//   ggy = sum_c ct_c * sum_{dy,dx} dwy[dy] * wx[dx] * I_c[corner]
// with dwx = [-vx0, +vx1] (validity-masked in 'zeros' mode, exactly what
// autodiff of the gather gives, since the masks are constant in the
// coordinates) and dwx = [-1, +1] in 'border' mode.  No image gradient:
// the source of the loss warp is data.
//
// What bounds it on the H100: bytes.  Per output pixel it reads 8 bytes
// of coordinates and, per channel, 4 bytes of cotangent and 4 corners, and
// writes 8 bytes; ~12 FLOPs per channel.  At the training loss's shape,
// (10, 2, 512, 512), each input read once and each output written once is
// ~84 MB, ~25 us at 3.35 TB/s.
//
// Design: the TPU kernel keeps the whole image in VMEM and turns the
// gather into lane shuffles over (8, 128) bands; none of that carries
// over.  As K3: one thread per output pixel decomposes its coordinate
// once (floor, fractions, clamped corners, validity), loops over C,
// and accumulates both sums in f32 registers.  The gradient is per output
// pixel (no image cotangent is scattered), so there are no atomics and
// the result is deterministic.  Any shape is taken.
template <bool kZeros>
__global__ void __launch_bounds__(256) gather_bilinear_grad_kernel(
    const float* __restrict__ img, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ ct,
    float* __restrict__ ggx, float* __restrict__ ggy, int C, int H, int W,
    long long PQ) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = blockIdx.y;
  if (pix >= PQ) return;
  const float x = gx[n * PQ + pix];
  const float y = gy[n * PQ + pix];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float tx = x - x0f;
  const float ty = y - y0f;
  // clamp before the int conversion, as K3 (validity is unchanged)
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  float wx0 = 1.f - tx, wx1 = tx, wy0 = 1.f - ty, wy1 = ty;
  float dwx0 = -1.f, dwx1 = 1.f, dwy0 = -1.f, dwy1 = 1.f;
  if (kZeros) {
    const float vx0 = (x0 >= 0 && x0 < W) ? 1.f : 0.f;
    const float vx1 = (x1 >= 0 && x1 < W) ? 1.f : 0.f;
    const float vy0 = (y0 >= 0 && y0 < H) ? 1.f : 0.f;
    const float vy1 = (y1 >= 0 && y1 < H) ? 1.f : 0.f;
    wx0 *= vx0; wx1 *= vx1; wy0 *= vy0; wy1 *= vy1;
    dwx0 = -vx0; dwx1 = vx1; dwy0 = -vy0; dwy1 = vy1;
  }
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
  const long long i00 = (long long)yc0 * W + xc0, i01 = (long long)yc0 * W + xc1;
  const long long i10 = (long long)yc1 * W + xc0, i11 = (long long)yc1 * W + xc1;
  const long long hw = (long long)H * W;
  const float* src = img + n * C * hw;
  const float* cot = ct + n * C * PQ + pix;
  float accx = 0.f, accy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* p = src + c * hw;
    const float g = cot[c * PQ];
    const float v00 = p[i00], v01 = p[i01], v10 = p[i10], v11 = p[i11];
    // sum over the corners, then times ct_c (the corner order of
    // dvd_tpu/ops/grid_sample.py)
    const float sx = wy0 * dwx0 * v00 + wy0 * dwx1 * v01 +
                     wy1 * dwx0 * v10 + wy1 * dwx1 * v11;
    const float sy = dwy0 * wx0 * v00 + dwy0 * wx1 * v01 +
                     dwy1 * wx0 * v10 + dwy1 * wx1 * v11;
    accx += g * sx;
    accy += g * sy;
  }
  ggx[n * PQ + pix] = accx;
  ggy[n * PQ + pix] = accy;
}

}  // namespace

extern "C" int dvd_gather_bilinear_grad(const void* img, const void* gx,
                                        const void* gy, const void* ct,
                                        void* ggx, void* ggy, int N, int C,
                                        int H, int W, long long P, long long Q,
                                        int zeros, void* stream) {
  const long long pq = P * Q;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || pq <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(dvd::ceil_div(pq, 256), N);
  cudaStream_t s = (cudaStream_t)stream;
  if (zeros)
    gather_bilinear_grad_kernel<true><<<grid, 256, 0, s>>>(
        (const float*)img, (const float*)gx, (const float*)gy,
        (const float*)ct, (float*)ggx, (float*)ggy, C, H, W, pq);
  else
    gather_bilinear_grad_kernel<false><<<grid, 256, 0, s>>>(
        (const float*)img, (const float*)gx, (const float*)gy,
        (const float*)ct, (float*)ggx, (float*)ggy, C, H, W, pq);
  return (int)cudaGetLastError();
}

extern "C" int dvd_gather_bilinear(const void* img, const void* gx, const void* gy,
                                   void* out, int N, int C, int H, int W,
                                   long long P, long long Q, int zeros,
                                   void* stream) {
  const long long pq = P * Q;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || pq <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(dvd::ceil_div(pq, 256), N);
  cudaStream_t s = (cudaStream_t)stream;
  if (zeros)
    gather_bilinear_kernel<true><<<grid, 256, 0, s>>>(
        (const float*)img, (const float*)gx, (const float*)gy, (float*)out, C,
        H, W, pq);
  else
    gather_bilinear_kernel<false><<<grid, 256, 0, s>>>(
        (const float*)img, (const float*)gx, (const float*)gy, (float*)out, C,
        H, W, pq);
  return (int)cudaGetLastError();
}

// Error text for the codes the entry points return (read by the wrappers).
extern "C" const char* dvd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
