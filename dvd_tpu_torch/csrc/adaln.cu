// adaLN-Zero's elementwise passes around each DiT sublayer, fused: the
// pre-norm `modulate(layer_norm(x), shift, scale)` and the gated residual
// `x + gate * y`.
//
// Replaces no TPU kernel: dvd_tpu's DiT block (dvd_tpu/models/dit.py,
// DiTBlock) leaves both to XLA, which fuses them on the TPU.  Eager PyTorch
// runs the pre-norm as five full-tensor passes (a cast to f32, the norm, a
// cast back, `* (1 + scale)`, `+ shift`) and the residual as two (`gate *
// y`, `+ x`), four of them broadcasting against strided slices of the
// block's adaLN output through PyTorch's generic elementwise kernel.  In
// the DiT-XL/2 cells each runs 672 times a batch on (8, 1024, 1152) bf16.
//
// Two entries, both over (rows, D) rows of x with the conditioners' row
// n = row / tokens (shift, scale and gate are (N, D) views with a row
// stride of their own, so the strided columns of the block's adaLN output
// need no copy):
// - dvd_ln_modulate: out = (x - mean) * rstd * (1 + scale[n]) + shift[n],
//   mean and the biased variance in f32, rstd = rsqrt(var + eps), no
//   affine; with null shift and scale the plain layer norm.  Computed in
//   f32 and rounded to x's type once (eager PyTorch rounds four times).
// - dvd_gate_residual: out = x + gate[n] * y, one f32 fma rounded once
//   (eager: twice).
//
// What bounds them on the H100: bytes.  At (8, 1024, 1152) bf16 the norm
// reads x and writes out, 37.7 MB, 11.3 us at 3.35 TB/s; the residual reads
// x and y and writes out, 56.6 MB, 16.9 us.  The conditioners are 8 rows,
// read from L2.
//
// Design:
// - values move in units of consecutive elements, 16 bytes where they can:
//   4 values in f32; in bf16 8 (one 16-byte access) for the norm at widths
//   of kWideFrom (1024) and up whose pointers and conditioner strides allow
//   it, else 4 (one 8-byte access), as in the residual.  Below 1024 a lane
//   holds fewer than 4 wide units and the lanes left idle on a row's last
//   step cost more than the wider accesses save.  On the H100, from CUDA
//   graphs over inputs of five times the L2: at (8, 1024, 384) wide units
//   read 0.0076 ms against 0.0073, at (8, 1024, 1152) 0.0166 against
//   0.0181 (the byte bound 0.0113);
// - the norm reads its row from device memory once, with cp.async into
//   shared memory (each lane copies, and later reads, only its own units:
//   no barrier), so no register holds a unit in flight and registers do
//   not bound the rows in flight: at (8, 1024, 1152) bf16 eight blocks of
//   eight rows fit on an SM, and the card holds all 8192 rows at once.
//   The three passes over the row (the sum, the squared deviations about
//   the mean, which cannot cancel where a row's mean is large, and the
//   output) read shared memory.  W warps share a row, W in {1, 2, 4, 8}
//   the least that leaves each lane at most kMaxValues values: one warp a
//   row at 384 and 1152, four at the 'para' final layer's 4608; the
//   partial sums of a row's warps meet in shared memory.  A block's rows
//   take at most 8 x kMaxValues x 32 x 4 bytes = 45 KB of shared memory
//   (f32), under the 48 KB a launch may take without asking.  Pipelining
//   the rows instead (fewer resident blocks, each copying its next rows
//   while it reduces the current ones) measured 1.08-2.2x slower at every
//   width on the H100;
// - the residual is one unit a thread, a grid of (units of a conditioner
//   row / 256, N) blocks, so a thread finds its gate row without a 64-bit
//   division.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxValues = 44;               // values a lane holds, at most
constexpr int kWideFrom = 1024;              // bf16 widths of 16-byte units

// A unit's raw bits, as they lie in memory: BYTES bytes, BYTES / sizeof(T)
// values.
template <typename T, int BYTES>
struct Unit;
template <>
struct Unit<float, 16> {
  using Raw = float4;
};
template <>
struct Unit<__nv_bfloat16, 8> {
  using Raw = uint2;
};
template <>
struct Unit<__nv_bfloat16, 16> {
  using Raw = uint4;
};
// units of 4 values: the residual's, and the norm's below kWideFrom
template <typename T>
using Narrow = typename Unit<T, 4 * sizeof(T)>::Raw;

__device__ __forceinline__ void unpack(const float4& q, float v[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  v[0] = f.x;
  v[1] = f.y;
}

__device__ __forceinline__ void unpack(const uint2& q, float v[4]) {
  unpack_bf16x2(q.x, v);
  unpack_bf16x2(q.y, v + 2);
}

__device__ __forceinline__ void unpack(const uint4& q, float v[8]) {
  unpack_bf16x2(q.x, v);
  unpack_bf16x2(q.y, v + 2);
  unpack_bf16x2(q.z, v + 4);
  unpack_bf16x2(q.w, v + 6);
}

__device__ __forceinline__ void pack(float4& q, const float v[4]) {
  q = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void pack(uint2& q, const float v[4]) {
  q = make_uint2(dvd::pack_bf16(v[0], v[1]), dvd::pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void pack(uint4& q, const float v[8]) {
  q = make_uint4(dvd::pack_bf16(v[0], v[1]), dvd::pack_bf16(v[2], v[3]),
                 dvd::pack_bf16(v[4], v[5]), dvd::pack_bf16(v[6], v[7]));
}

template <typename Raw, typename T>
__device__ __forceinline__ void load_unit(const T* p, float* v) {
  unpack(*reinterpret_cast<const Raw*>(p), v);
}

template <typename Raw, typename T>
__device__ __forceinline__ void store_unit(T* p, const float* v) {
  Raw q;
  pack(q, v);
  *reinterpret_cast<Raw*>(p) = q;
}

// The sum of `s` over the W warps of this thread's row (`red`: one slot a
// warp of the block).  Every thread of the block calls it (W is the same
// for all), so the barrier is reached by all.
__device__ __forceinline__ float row_sum(float s, float* red, int W) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (W == 1) return s;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = s;
  __syncthreads();
  const int first = warp - warp % W;
  float total = 0.f;
  for (int k = 0; k < W; ++k) total += red[first + k];
  return total;
}

template <typename T, typename Raw>
__global__ void __launch_bounds__(kThreads) ln_modulate_kernel(
    const T* __restrict__ x, const T* __restrict__ shift, const T* __restrict__ scale,
    T* __restrict__ out, long long rows, int tokens, int D, long long shift_stride,
    long long scale_stride, float eps, int W) {
  constexpr int V = sizeof(Raw) / sizeof(T);            // values a unit
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x >> 5;
  const int span = 32 * W;                              // threads a row
  const int t = (warp % W) * 32 + (threadIdx.x & 31);   // place in the row
  const int slot = warp / W;                            // row of the block
  const long long row = (long long)blockIdx.x * (kWarps / W) + slot;
  const bool live = row < rows;
  const int units = D / V;
  const Raw* buf = reinterpret_cast<const Raw*>(smem) + (long long)slot * units;
  if (live) {
    const T* xr = x + row * D;
    for (int u = t; u < units; u += span)
      dvd::cp_async<sizeof(Raw)>(dvd::smem_u32(buf + u), xr + V * u, sizeof(Raw));
  }
  dvd::cp_async_commit();
  dvd::cp_async_wait<0>();
  float v[V], s = 0.f;
  if (live)
    for (int u = t; u < units; u += span) {
      unpack(buf[u], v);
#pragma unroll
      for (int j = 0; j < V; j += 4) s += (v[j] + v[j + 1]) + (v[j + 2] + v[j + 3]);
    }
  const float inv_d = 1.f / (float)D;
  const float mean = row_sum(s, red[0], W) * inv_d;
  float q = 0.f;
  if (live)
    for (int u = t; u < units; u += span) {
      unpack(buf[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = v[j] - mean;
        q = fmaf(c, c, q);
      }
    }
  const float rstd = rsqrtf(row_sum(q, red[1], W) * inv_d + eps);
  if (!live) return;
  const long long n = row / tokens;
  T* orow = out + row * D;
  for (int u = t; u < units; u += span) {
    unpack(buf[u], v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (v[j] - mean) * rstd;
    if (shift != nullptr) {
      float sh[V], sc[V];
      load_unit<Raw>(shift + n * shift_stride + V * u, sh);
      load_unit<Raw>(scale + n * scale_stride + V * u, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = fmaf(v[j], 1.f + sc[j], sh[j]);
    }
    store_unit<Raw>(orow + V * u, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gate_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ gate, const T* __restrict__ y,
    T* __restrict__ out, int row_units, int d_units, long long gate_stride) {
  const int u = blockIdx.x * kThreads + threadIdx.x;   // unit within row n
  if (u >= row_units) return;
  const long long n = blockIdx.y;
  const long long at = 4 * (n * row_units + u);
  float a[4], g[4], b[4];
  load_unit<Narrow<T>>(x + at, a);
  load_unit<Narrow<T>>(gate + n * gate_stride + 4 * (u % d_units), g);
  load_unit<Narrow<T>>(y + at, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = fmaf(g[j], b[j], a[j]);
  store_unit<Narrow<T>>(out + at, a);
}

// W warps a row for a row of `units` units of V values (see the top), or
// 0 where 8 warps leave a lane more than kMaxValues values.
int ln_warps(int units, int V) {
  int w = 1;
  while (w <= kWarps && (units + 32 * w - 1) / (32 * w) * V > kMaxValues) w *= 2;
  return w <= kWarps ? w : 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename Raw>
cudaError_t launch_ln_units(const void* x, const void* shift, const void* scale, void* out,
                            long long rows, int tokens, int D, long long shift_stride,
                            long long scale_stride, float eps, int W, cudaStream_t stream) {
  const long long blocks = (rows + kWarps / W - 1) / (kWarps / W);
  const size_t smem = (size_t)(kWarps / W) * D * sizeof(T);
  ln_modulate_kernel<T, Raw><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)shift, (const T*)scale, (T*)out, rows, tokens, D,
      shift_stride, scale_stride, eps, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln(const void* x, const void* shift, const void* scale, void* out,
                      long long rows, int tokens, int D, long long shift_stride,
                      long long scale_stride, float eps, cudaStream_t stream) {
  if (sizeof(T) == 2 && D >= kWideFrom && D % 8 == 0 && aligned16(x) && aligned16(out) &&
      (shift == nullptr || (aligned16(shift) && aligned16(scale) && shift_stride % 8 == 0 &&
                            scale_stride % 8 == 0))) {
    using Wide = typename Unit<T, 16>::Raw;
    const int W = ln_warps(D / 8, 8);
    if (W > 0)
      return launch_ln_units<T, Wide>(x, shift, scale, out, rows, tokens, D, shift_stride,
                                      scale_stride, eps, W, stream);
  }
  return launch_ln_units<T, Narrow<T>>(x, shift, scale, out, rows, tokens, D, shift_stride,
                                       scale_stride, eps, ln_warps(D / 4, 4), stream);
}

}  // namespace

// x, out: (rows, D) contiguous; shift, scale: (rows / tokens, D) rows at
// the given strides (elements), or both null.  Every pointer 4-value
// aligned (8 bytes in bf16, 16 in f32), D a multiple of 4 and at most
// kMaxValues x kThreads (11264).
extern "C" int dvd_ln_modulate(const void* x, const void* shift, const void* scale,
                               void* out, long long rows, int tokens, int D,
                               long long shift_stride, long long scale_stride, float eps,
                               int dtype, void* stream) {
  if (rows <= 0 || tokens <= 0 || D <= 0 || D % 4 != 0 ||
      D > kMaxValues * kThreads || (shift == nullptr) != (scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dvd::kBFloat16)
    return (int)launch_ln<__nv_bfloat16>(x, shift, scale, out, rows, tokens, D,
                                         shift_stride, scale_stride, eps, s);
  if (dtype == dvd::kFloat32)
    return (int)launch_ln<float>(x, shift, scale, out, rows, tokens, D, shift_stride,
                                 scale_stride, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, y, out: (N, tokens, D) contiguous; gate: (N, D) rows at gate_stride
// (elements).  Pointers and D as above; tokens x D / 4 below 2^31 - 256.
extern "C" int dvd_gate_residual(const void* x, const void* gate, const void* y, void* out,
                                 int N, int tokens, int D, long long gate_stride, int dtype,
                                 void* stream) {
  const long long row_units = (long long)tokens * (D / 4);
  if (N <= 0 || N > 65535 || tokens <= 0 || D <= 0 || D % 4 != 0 ||
      row_units > (1LL << 31) - kThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((row_units + kThreads - 1) / kThreads), (unsigned)N);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dvd::kBFloat16)
    gate_residual_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)gate, (const __nv_bfloat16*)y,
        (__nv_bfloat16*)out, (int)row_units, D / 4, gate_stride);
  else if (dtype == dvd::kFloat32)
    gate_residual_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)gate, (const float*)y, (float*)out, (int)row_units,
        D / 4, gate_stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The runtime's last error, read and cleared: for the card tests, after a
// synchronize.
extern "C" int dvd_last_error() { return (int)cudaGetLastError(); }
