// K2: 'SAME' 3x3 convolution, dilation d, NCHW, with a per-channel
// float32 epilogue y = acc * scale + bias, an optional ReLU, and the output
// stored in the input's dtype.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar
// (_conv_kernel).  The scale/bias contract is kept: frozen BN and the conv
// bias are folded into (scale, bias) once per weight set (see
// dvd_tpu_torch/models/layers.py:fold_conv_bn), and plain convs pass
// scale = 1.  Inputs:
// x (B, Cin, H, W), w (Cout, Cin, 3, 3) in x's dtype (float32 or bfloat16),
// scale and bias (Cout,) float32.  Accumulation is float32.
//
// What bounds it on the H100: at the big layers, FLOPs (the DiT pyramid's
// 256->256 convs at 128^2 are ~19 GFLOP per image against ~17 MB of bf16
// traffic); at U2NetP's 16-channel layers at 288^2, bytes (~0.4 GFLOP
// against ~5 MB).  This first version runs the products on the CUDA cores
// in float32, not on the tensor cores: right first; tensor cores next.
//
// Design: a direct convolution.  One block per (image, 32- or 16-channel
// Cout tile, 8 x 32 output tile), one thread per output pixel holding the
// Cout tile's accumulators in registers.  The block loops over Cin in
// chunks of 8: it stages the input tile plus a halo of `d` on every side
// (zero outside the plane, which is the 'SAME' padding that the TPU
// kernel's row/col masks restore) and the chunk's weights, laid out
// [ci][tap][co] so each thread reads four output channels' weights with one
// broadcast 16-byte load.  This covers the four cases the TPU kernel
// special-cased: planes of any H x W (odd ones included), dilation 8 on a
// 9 x 9 plane (most taps read the zero halo), Cin 3 or 4 at the image
// entry (the chunk is zero-padded in shared memory), and Cin up to 1024.
#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 32;  // output tile: 8 rows x 32 columns
constexpr int kThreads = kTH * kTW;
constexpr int kCC = 8;            // input channels per staged chunk
// Largest dilation whose halo-padded tile fits the 227 KB a block may use
// (kCC * (8 + 2d) * (32 + 2d) floats plus the weights).
constexpr int kMaxDilation = 32;

// Dynamic shared memory per block: the chunk's weights, then its input
// tile with the halo.
size_t smem_bytes(int cot, int dil) {
  const int ih = kTH + 2 * dil, iw = kTW + 2 * dil;
  return ((size_t)kCC * 9 * cot + (size_t)kCC * ih * iw) * sizeof(float);
}

template <typename T, int COT>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int Cin, int Cout, int H, int W, int dil, int relu,
    int tiles_x) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [kCC][9][COT]
  float* in_s = w_s + kCC * 9 * COT;             // [kCC][IH][IW]
  const int IH = kTH + 2 * dil, IW = kTW + 2 * dil;

  const int tid = threadIdx.x;
  const int ty = tid / kTW, tx = tid % kTW;
  const int tile_y = blockIdx.x / tiles_x, tile_x = blockIdx.x % tiles_x;
  const int co0 = blockIdx.y * COT;
  const long long b = blockIdx.z;
  const int oy0 = tile_y * kTH, ox0 = tile_x * kTW;
  const long long hw = (long long)H * W;
  const T* xb = x + b * Cin * hw;

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCC) {
    __syncthreads();  // previous chunk consumed
    const int n_in = kCC * IH * IW;
    for (int i = tid; i < n_in; i += kThreads) {
      const int ci = i / (IH * IW);
      const int rem = i - ci * IH * IW;
      const int iy = rem / IW, ix = rem - (rem / IW) * IW;
      const int gy = oy0 - dil + iy, gx = ox0 - dil + ix, gc = c0 + ci;
      float val = 0.f;
      if (gc < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = dvd::to_f32(xb[gc * hw + (long long)gy * W + gx]);
      in_s[i] = val;
    }
    for (int i = tid; i < kCC * 9 * COT; i += kThreads) {
      const int co = i % COT;
      const int tap = (i / COT) % 9;
      const int ci = i / (9 * COT);
      const int gco = co0 + co, gc = c0 + ci;
      w_s[i] = (gco < Cout && gc < Cin)
                   ? dvd::to_f32(w[((long long)gco * Cin + gc) * 9 + tap])
                   : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kCC; ++ci) {
      const float* in_c = in_s + ci * IH * IW;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const float val = in_c[(ty + ky * dil) * IW + tx + kx * dil];
        const float4* wp =
            reinterpret_cast<const float4*>(w_s + (ci * 9 + tap) * COT);
#pragma unroll
        for (int q = 0; q < COT / 4; ++q) {
          const float4 wv = wp[q];
          acc[4 * q + 0] = fmaf(val, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(val, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(val, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(val, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= H || ox >= W) return;
  T* ob = out + b * Cout * hw + (long long)oy * W + ox;
#pragma unroll
  for (int c = 0; c < COT; ++c) {
    const int gco = co0 + c;
    if (gco < Cout) {
      float y = fmaf(acc[c], scale[gco], bias[gco]);
      if (relu) y = fmaxf(y, 0.f);
      ob[gco * hw] = dvd::from_f32<T>(y);
    }
  }
}

template <typename T, int COT>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int B, int Cin, int Cout, int H, int W, int dil,
           int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(COT, dil);
  auto kern = conv3x3_kernel<T, COT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = dvd::ceil_div(W, kTW), tiles_y = dvd::ceil_div(H, kTH);
  dim3 grid(tiles_x * tiles_y, dvd::ceil_div(Cout, COT), B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)scale, (const float*)bias,
      (T*)out, Cin, Cout, H, W, dil, relu, tiles_x);
  return (int)cudaGetLastError();
}

// Output channels per block: 16 for the narrow layers, else 32.
int cout_tile(int Cout) { return Cout <= 16 ? 16 : 32; }

template <typename T>
int dispatch_cot(const void* x, const void* w, const void* scale,
                 const void* bias, void* out, int B, int Cin, int Cout, int H,
                 int W, int dil, int relu, cudaStream_t s) {
  if (cout_tile(Cout) == 16)
    return launch<T, 16>(x, w, scale, bias, out, B, Cin, Cout, H, W, dil, relu, s);
  return launch<T, 32>(x, w, scale, bias, out, B, Cin, Cout, H, W, dil, relu, s);
}

}  // namespace

// Dynamic shared memory per block for Cout output channels at dilation dil.
extern "C" long long dvd_conv3x3_smem_bytes(int Cout, int dil) {
  return (long long)smem_bytes(cout_tile(Cout), dil);
}

extern "C" int dvd_conv3x3(const void* x, const void* w, const void* scale,
                           const void* bias, void* out, int B, int Cin,
                           int Cout, int H, int W, int dil, int relu,
                           int dtype, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || dil < 1 ||
      dil > kMaxDilation || B > 65535 || (Cout + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dvd::kFloat32)
    return dispatch_cot<float>(x, w, scale, bias, out, B, Cin, Cout, H, W, dil,
                               relu, s);
  if (dtype == dvd::kBFloat16)
    return dispatch_cot<__nv_bfloat16>(x, w, scale, bias, out, B, Cin, Cout, H,
                                       W, dil, relu, s);
  return (int)cudaErrorInvalidValue;
}
