// K1, bfloat16: non-causal, unmasked softmax(q k^T * scale) v, forward only,
// on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/attention.py:fused_attention
// (_kernel) for bf16 inputs; float32 goes to the split-product kernel in
// attention_f32x6.cu.  Contract: q (B, H, Tq, Dh), k and v (B, H, Tk, Dh), each
// with its own (b, h, t) strides (multiples of 8 elements, base pointers
// 16-byte aligned) and a unit stride on Dh, so the split_heads views of a
// (B, T, H*Dh) projection are read in place.  Logits and softmax in f32, p
// cast to bf16 before P.V, f32 accumulation, bf16 output.  Ragged Tq and Tk
// are masked here: K/V rows past Tk load as zeros and their logits are
// -inf; query rows past Tq load as zeros and are not written.
//
// What bounds it on the H100: operations.  (8, 6, 1024, 256) is 51.5 GFLOP
// against 25 MB of traffic (0.052 ms at 989 TFLOP/s against 0.0075 ms at
// 3.35 TB/s); (8, 6, 1024, 64) 12.9 GFLOP against 6 MB.  So both products
// run on the tensor cores, and the copies only have to keep them fed.
//
// Design:
// - A block is two consumer warpgroups (256 threads); each owns 64 query
//   rows (wgmma's M).  The two share every K/V tile, which halves the
//   L2->SM traffic per query row against one warpgroup per block.
// - Q (128 x Dh) is copied once per block and stays in shared memory.  K/V
//   tiles of 64 rows stream through a ring of kStages slots with cp.async.cg
//   16-byte copies (commit/wait groups): tile j+kStages-1 is in flight while
//   the products run on tile j.  One __syncthreads per tile both publishes
//   the tile that landed and frees the slot the next copy overwrites.
// - S = Q K^T: wgmma m64n64k16 with both operands in shared memory (Q and K
//   are K-major), Dh/16 steps into 32 f32 registers per thread.
// - Online softmax in registers: logits scaled by scale*log2(e), running row
//   max and row sum (each thread holds 2 rows; a row's max is reduced over
//   its 4-thread quad), ex2.approx, O rescaled once per tile, normalised
//   once at the end.
// - O += P V: P never touches shared memory.  The S accumulator, cast to
//   bf16 pairs, is already in the register layout of wgmma's A operand; V
//   is the B operand in its natural [Tk][Dh] layout (MN-major, transpose
//   bit set), one m64n64k16 per 64 columns of Dh (m64n16k16 at Dh 16).
// - Shared memory is in the swizzle the descriptors name: column blocks of
//   64 bf16 (128 bytes) in the 128-byte swizzle, or one 32-byte block in the
//   32-byte swizzle at Dh 16; each block of 8 rows is one swizzle atom.
//   Dh 256 is four column blocks, 192 three.
// - Sizes: Q 256*Dh bytes, a ring slot (K + V) 256*Dh bytes; 3 slots for
//   Dh <= 192, 2 at Dh 256 (64 KB + 128 KB = 192 KB of the 227 KB).  The O
//   accumulator is Dh/2 f32 registers per thread (128 at Dh 256), so Dh >= 128
//   runs one block per SM (255 registers a thread allowed); Dh <= 64 asks
//   for two blocks per SM (128 registers).
// - Rounding: p is cast to bf16 relative to the running max and normalised
//   by the f32 row sum at the end; the TPU kernel casts the normalised p.
//   The two differ by bf16 rounding of p (relative 2^-9 per term).
#include "attention.cuh"

namespace {

using namespace dvd;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64;                  // query rows per warpgroup
constexpr int kBQ = kBM * kWarpgroups;   // query rows per block
constexpr int kBK = 64;                  // K/V rows per tile

template <int DH>
__host__ __device__ constexpr int stages() { return DH >= 256 ? 2 : 3; }

template <int DH>
constexpr int smem_bytes() {
  // Q, the ring, and 1 KB to align the base to a 1024-byte swizzle atom
  return kBQ * DH * 2 + stages<DH>() * 2 * kBK * DH * 2 + 1024;
}

#define DVD_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) += A (64 x 16, smem, K-major) B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DVD_D8(0), DVD_D8(8), DVD_D8(16), DVD_D8(24)
      : "l"(a), "l"(b), "r"(1));
}

#undef DVD_D8

// copy rows [t0, t0 + R) of a (T, DH) bf16 matrix with row stride st into a
// swizzled tile; rows at or past T are zero-filled
template <int DH, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long st, int t0, int T, int tid) {
  constexpr int kCpr = DH / 8;  // 16-byte chunks per row
  constexpr int kN = R * kCpr;
#pragma unroll
  for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kN % kThreads != 0 && i >= kN) break;
    const int r = i / kCpr, c = i % kCpr;
    const bool ok = t0 + r < T;
    const __nv_bfloat16* g = ok ? src + (long long)(t0 + r) * st + c * 8 : src;
    cp_async<16>(dst + Layout<DH>::template offset<R>(r, c), g, ok ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 2 : 1) attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
    int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
    float scale_log2) {
  using L = Layout<DH>;
  constexpr int kS = stages<DH>();
  constexpr uint32_t kQBytes = kBQ * DH * 2, kTileBytes = kBK * DH * 2;
  constexpr int kNB = DH >= 64 ? DH / 64 : 1;  // P.V products per k step
  constexpr int kNO = DH >= 64 ? 32 : 8;       // O registers per product
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sq + kQBytes;  // slot s: K at ring + 2s tiles, V after it

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const int ntiles = (Tk + kBK - 1) / kBK;

  auto load_kv = [&](int tile) {
    const uint32_t slot = ring + (tile % kS) * 2 * kTileBytes;
    load_tile<DH, kBK>(slot, kb, ks.t, tile * kBK, Tk, tid);
    load_tile<DH, kBK>(slot + kTileBytes, vb, vs.t, tile * kBK, Tk, tid);
  };
  load_tile<DH, kBQ>(sq, qb, qs.t, q0, Tq, tid);
  load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kS - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[kNB][kNO];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < kNO; ++e) acc[n][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  const uint32_t q_wg = sq + wg * kBM * L::kRowBytes;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kS - 2>();  // tile j has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();          // ... everyone's; and slot (j - 1) % kS is free
    if (j + kS - 1 < ntiles) load_kv(j + kS - 1);
    cp_async_commit();
    const uint32_t sk = ring + (j % kS) * 2 * kTileBytes, sv = sk + kTileBytes;

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // columns 16kk..16kk+15: column block blk, 32-byte step off in its rows
      const uint32_t blk = kk * 16 / L::kCols, off = (kk * 16 % L::kCols) * 2;
      wgmma_ss_n64(s, make_desc(q_wg + blk * kBQ * L::kRowBytes + off, 16, L::kAtom, L::kMode),
                   make_desc(sk + blk * kBK * L::kRowBytes + off, 16, L::kAtom, L::kMode));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax; element e of s is row lane / 4 + 8 * ((e / 2) % 2),
    // column 8 * (e / 4) + 2 * (lane % 4) + e % 2 of this warp's 16 x 64 slab
    const int c0 = j * kBK + 2 * (lane % 4);
    const bool ragged = j * kBK + kBK > Tk;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float x = s[e] * scale_log2;
      s[e] = (!ragged || c0 + 8 * (e / 4) + e % 2 < Tk) ? x : -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = row_max[i];
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) mx = fmaxf(mx, fmaxf(s[e], s[e + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = ex2(row_max[i] - mx);  // 0 on the first tile
      row_max[i] = mx;                  // finite: every tile has a column < Tk
      float sum = 0.f;
#pragma unroll
      for (int e = 2 * i; e < 32; e += 4) {
        s[e] = ex2(s[e] - mx);
        s[e + 1] = ex2(s[e + 1] - mx);
        sum += s[e] + s[e + 1];
      }
      row_sum[i] = row_sum[i] * alpha[i] + sum;  // this thread's columns only
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int e = 0; e < kNO; ++e) acc[n][e] *= alpha[(e / 2) % 2];

    // P in wgmma's A-operand layout: k step kk takes columns 16kk..16kk+15
    uint32_t p[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[4 * kk + r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V
    fence_regs(p);
#pragma unroll
    for (int n = 0; n < kNB; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 rows (two 8-row atoms) of column block n; an n64 product spans
        // exactly one atom's width, so both byte offsets are the atom stride
        const uint64_t bd = make_desc(sv + n * kBK * L::kRowBytes + kk * 16 * L::kRowBytes,
                                      L::kAtom, L::kAtom, L::kMode);
        if constexpr (DH >= 64)
          wgmma_rs_n64(acc[n], p + 4 * kk, bd);
        else
          wgmma_rs_n16(acc[n], p + 4 * kk, bd);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kNB; ++n) fence_regs(acc[n]);
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)

  // normalise and write this thread's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = row_sum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int t = q0 + wg * kBM + warp * 16 + lane / 4 + 8 * i;
    if (t >= Tq) continue;
    __nv_bfloat16* orow = ob + (long long)t * os.t + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int c = 0; c < kNO / 4; ++c) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(
            acc[n][4 * c + 2 * i] * inv, acc[n][4 * c + 2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 64 + 8 * c) = val;
      }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  auto kern = attention_wgmma_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(dvd::ceil_div(Tq, kBQ), B * H);
  const float log2e = 1.4426950408889634f;
  kern<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, H, Tq, Tk, qs, ks, vs, os, scale * log2e);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, Strides s) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.t % 8 == 0;
}

}  // namespace

// Dynamic shared memory per block for head dim Dh (-1: no kernel).
extern "C" long long dvd_attention_wgmma_smem_bytes(int Dh) {
  switch (Dh) {
#define DVD_CASE(D) \
    case D: return (long long)smem_bytes<D>();
    DVD_FOR_EACH_DH(DVD_CASE)
#undef DVD_CASE
    default: return -1;
  }
}

extern "C" int dvd_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int Dh, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, float scale, int dtype,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  if (dtype != dvd::kBFloat16 || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      B * H > 65535 || !aligned(q, qs) || !aligned(k, ks) || !aligned(v, vs) ||
      !aligned(o, os))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
#define DVD_CASE(D) \
    case D: return launch<D>(q, k, v, o, B, H, Tq, Tk, qs, ks, vs, os, scale, s);
    DVD_FOR_EACH_DH(DVD_CASE)
#undef DVD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
