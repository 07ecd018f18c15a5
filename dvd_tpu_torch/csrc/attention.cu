// K1: non-causal, unmasked softmax(q k^T * scale) v, forward only.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/attention.py:fused_attention
// (_kernel).  Contract: q (B, H, Tq, Dh), k and v (B, H, Tk, Dh), float32 or
// bfloat16, each with its own (b, h, t) strides and a unit stride on Dh, so
// the split_heads views of a (B, T, H*Dh) projection are read in place.
// Logits, softmax and the P.V accumulation are float32; the output is
// written in q's dtype.  `scale` is an argument (1/8 in the DiT, 1/16 in the
// SATRN decoder), not 1/sqrt(Dh).
//
// What bounds it on the H100: FLOPs.  At the slice's shapes, (8, 6, 1024, 64)
// is 12.9 GFLOP against 6 MB of bf16 traffic and (8, 6, 1024, 256) is
// 51.5 GFLOP against 25 MB -- both far above the card's ~295 FLOP/byte
// ridge.  This first version runs the products on the CUDA cores in float32
// (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16 via wgmma):
// right first; tensor cores are the next step.
//
// Design: the Pallas kernel keeps a whole head's K and V resident in VMEM
// (1 MB at Dh 256); that does not fit an SM's 227 KB of shared memory.  So
// this kernel streams: one block per (b*h, 64-row q tile), K/V tiles of BK
// rows staged through shared memory, and an online softmax with a running
// max and sum per row in float32 (exp2 of pre-scaled logits).  Ragged Tk is
// masked (logit -inf), ragged Tq is not written; the TPU kernel's T%8
// assertion does not carry over.  p is kept in float32 before P.V; the TPU
// kernel casts the normalised p to v's dtype first, which for bf16 inputs
// differs by at most bf16 rounding of p (relative 2^-9 per term).
//
// Threads: 256 = 16 (ty) x 16 (tx).  Thread (ty, tx) owns rows ty*4..+3 and
// columns tx + 16*c of both the S tile and the O accumulator, so shared
// reads of K/V rows are conflict-free (row strides are odd) and Q/P reads
// broadcast.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;      // query rows per block
constexpr int kThreads = 256;
constexpr int kRM = 4;       // query rows per thread

struct Strides {
  long long b, h, t;
};

template <int DH>
__host__ __device__ constexpr int block_k() { return DH >= 256 ? 32 : 64; }

template <int DH>
constexpr size_t smem_floats() {
  constexpr int BK = block_k<DH>();
  return (size_t)kBQ * (DH + 1)      // Q tile, pre-scaled
         + (size_t)BK * (DH + 1)     // K tile
         + (size_t)BK * DH           // V tile
         + (size_t)kBQ * (BK + 1)    // S / P tile
         + 3 * kBQ;                  // running max, running sum, rescale
}

// Head dims with a kernel: 16 (the mini test DiT), 64 (DiT-S/B/L heads),
// and 64 * k for the SATRN decoder over k = 2, 3, 4 streams.
#define DVD_FOR_EACH_DH(X) X(16) X(64) X(128) X(192) X(256)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int Tq, int Tk, Strides qs, Strides ks,
    Strides vs, Strides os, float scale_log2) {
  constexpr int BK = block_k<DH>();
  constexpr int SC = BK / 16;  // S columns per thread
  constexpr int OC = DH / 16;  // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (DH + 1);
  float* Vs = Ks + BK * (DH + 1);
  float* Ps = Vs + BK * DH;
  float* row_m = Ps + kBQ * (BK + 1);
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int t = q0 + r;
    Qs[r * (DH + 1) + d] =
        t < Tq ? dvd::to_f32(qb[t * qs.t + d]) * scale_log2 : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[kRM][OC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int t = k0 + r;
      const bool ok = t < Tk;
      Ks[r * (DH + 1) + d] = ok ? dvd::to_f32(kb[t * ks.t + d]) : 0.f;
      Vs[r * DH + d] = ok ? dvd::to_f32(vb[t * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // S = (Q * scale * log2 e) K^T for this thread's 4 x SC micro-tile
    float s[kRM][SC];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[kRM], kv[SC];
#pragma unroll
      for (int r = 0; r < kRM; ++r) qa[r] = Qs[(ty * kRM + r) * (DH + 1) + d];
#pragma unroll
      for (int c = 0; c < SC; ++c) kv[c] = Ks[(tx + 16 * c) * (DH + 1) + d];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) s[r][c] = fmaf(qa[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int j = tx + 16 * c;
        Ps[(ty * kRM + r) * (BK + 1) + j] = (k0 + j < Tk) ? s[r][c] : -INFINITY;
      }
    __syncthreads();

    // online softmax: 4 threads per row, reduced with shuffles
    {
      const int row = tid >> 2, part = tid & 3;
      float* prow = Ps + row * (BK + 1);
      float mx = -INFINITY;
      for (int j = part; j < BK; j += 4) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = part; j < BK; j += 4) {
        const float p = exp2f(prow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float a = exp2f(m_old - m_new);
        row_a[row] = a;
        row_m[row] = m_new;
        row_l[row] = row_l[row] * a + sum;
      }
    }
    __syncthreads();

    // O = O * a + P V
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const float a = row_a[ty * kRM + r];
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] *= a;
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float p[kRM];
#pragma unroll
      for (int r = 0; r < kRM; ++r) p[r] = Ps[(ty * kRM + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = Vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRM; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int row = ty * kRM + r;
    const int t = q0 + row;
    if (t >= Tq) continue;
    const float inv = 1.f / row_l[row];
#pragma unroll
    for (int c = 0; c < OC; ++c)
      ob[t * os.t + tx + 16 * c] = dvd::from_f32<T>(acc[r][c] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  auto kern = attention_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(dvd::ceil_div(Tq, kBQ), B * H);
  const float log2e = 1.4426950408889634f;
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                         (T*)o, H, Tq, Tk, qs, ks, vs, os,
                                         scale * log2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
                int B, int H, int Tq, int Tk, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, cudaStream_t s) {
  switch (Dh) {
#define DVD_CASE(D) \
    case D: return launch<T, D>(q, k, v, o, B, H, Tq, Tk, qs, ks, vs, os, scale, s);
    DVD_FOR_EACH_DH(DVD_CASE)
#undef DVD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory per block for head dim Dh (-1: no kernel).
extern "C" long long dvd_attention_smem_bytes(int Dh) {
  switch (Dh) {
#define DVD_CASE(D) \
    case D: return (long long)(smem_floats<D>() * sizeof(float));
    DVD_FOR_EACH_DH(DVD_CASE)
#undef DVD_CASE
    default: return -1;
  }
}

extern "C" int dvd_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Tq, int Tk, int Dh,
                                 long long q_sb, long long q_sh, long long q_st,
                                 long long k_sb, long long k_sh, long long k_st,
                                 long long v_sb, long long v_sh, long long v_st,
                                 long long o_sb, long long o_sh, long long o_st,
                                 float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dvd::kFloat32)
    return dispatch_dh<float>(Dh, q, k, v, o, B, H, Tq, Tk, qs, ks, vs, os, scale, s);
  if (dtype == dvd::kBFloat16)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, H, Tq, Tk, qs, ks, vs, os,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
