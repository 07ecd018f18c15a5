// K1, float32: non-causal, unmasked softmax(q k^T * scale) v, forward only,
// computed to f32 accuracy on Hopper's tensor cores: both products are six
// bf16 wgmmas over a three-way bf16 split of each operand.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/attention.py:fused_attention
// (_kernel) for float32 inputs (the f32 serving and training paths,
// model.compute_dtype="float32"); bfloat16 goes to attention_wgmma.cu.
// Contract: q (B, H, Tq, Dh), k and v (B, H, Tk, Dh) f32, each with its own
// (b, h, t) strides (multiples of 4 elements, base pointers 16-byte
// aligned) and a unit stride on Dh, so the split_heads views of a (B, T,
// H*Dh) projection are read in place; f32 output.  Ragged Tq and Tk are
// masked here: K/V rows past Tk load as zeros and their logits are -inf;
// query rows past Tq load as zeros and are not written.
//
// The split (hopper.cuh:split3_pack): x = h + m + l in bf16, exact; a
// product a b is l_a h_b + h_a l_b + m_a m_b + m_a h_b + h_a m_b + h_a h_b,
// smallest terms first, the dropped terms below 2^-24 of |a b| (the
// TPU's precision=HIGHEST, six bf16 passes).
//
// What bounds it on the H100: operations, at 989 / 6 = 165 TFLOP/s of
// f32-accurate products (scaled_dot_product_attention runs f32 on the CUDA
// cores, 67 TFLOP/s).  (8, 6, 1024, 256) is 51.5 GFLOP against 50 MB of
// f32 traffic: 0.312 ms against 0.015 ms at 3.35 TB/s.  So both products
// run on the tensor cores, and everything else has to fit around them.
//
// Design (attention_wgmma.cu's, with the split):
// - A block is two consumer warpgroups; they share every K/V tile.  Up to
//   Dh 192 each owns 64 query rows (wgmma's M).  At Dh 256 both take the
//   same 64 rows and each half of Dh: S's k16 steps over its half (the two
//   partial S exchanged through K's planes, added alike by both) and O's
//   columns over its half, which halves the O accumulator to 64 registers
//   a thread and keeps two warpgroups per SM.
// - Q stays in shared memory in f32 (16-byte chunks XOR-swizzled by the
//   row, so a warp's 8-byte fragment loads meet at most two to a bank).
//   Per k16 step of S = Q K^T each thread loads its A fragment (8
//   values), splits it in registers and issues six wgmmas with A from
//   registers; fragments are double-buffered, so a step's loads and
//   splits overlap the previous step's products.
// - K/V tiles of BK rows land in an f32 staging area with cp.async
//   16-byte copies and are split into three bf16 planes each, in the
//   swizzled layout the descriptors name (attention.cuh: Layout): K
//   K-major (S's B operand), V in its natural [Tk][Dh] layout (MN-major,
//   transpose bit set).  The splits run under the products: V(j) between
//   the k16 steps of S(j), K(j+1) between the column blocks of P(j) V(j)
//   (K's planes are free once S(j) is done).  Each thread splits only the
//   chunks it copied, so its own cp.async waits publish them; a barrier
//   after each split publishes the planes.
// - Online softmax in registers, as attention_wgmma.cu: logits scaled by
//   scale*log2(e), running row max and sum, ex2.approx, O rescaled once
//   per tile and normalised once at the end.
// - O += P V: P, the S accumulator, is already in the register layout of
//   wgmma's A operand; split in registers into three bf16 fragments, six
//   wgmmas per k16 step and 64 columns of Dh (per 16 columns, m64n16, at
//   Dh 16 and 32: attention.cuh's 16-column blocks).
// - The sums: the tensor cores truncate as they accumulate, so S's six
//   products of each k16 step, and P V's of each tile and 64 columns, go
//   into a fresh tensor-core accumulator that the CUDA cores add to the
//   f32 sum (csrc/conv3x3_f32x6.cu measures the drift otherwise).
// - Shared-memory plan (Q f32 + staging f32 for K and V + six bf16 planes
//   + 1 KB to align the swizzle atoms):
//     Dh 256: 64 rows, BK 32: 64 + 64 + 96 KB = 225 KB of the 227 KB
//     Dh 192: 128 rows, BK 32: 96 + 48 + 72 KB = 217 KB
//     Dh 128: 128 rows, BK 64: 64 + 64 + 96 KB = 225 KB
//     Dh 64:  128 rows, BK 64: 32 + 32 + 48 KB = 113 KB
//     Dh 32:  128 rows, BK 64: 16 + 16 + 24 KB = 57 KB
//     Dh 16:  128 rows, BK 64: 8 + 8 + 12 KB = 29 KB
//   The O accumulator is the warpgroup's Dh columns / 2 f32 registers a
//   thread (96 at Dh 192, 64 at Dh 256); every instance runs one block per
//   SM.
#include "attention.cuh"

namespace {

using namespace dvd;

template <int DH>
struct Cfg {
  // Dh 256: the two warpgroups share 64 query rows and each takes half of
  // Dh, for S (their partial sums exchanged through shared memory) and for
  // O; else each owns 64 rows and all of Dh
  static constexpr bool kHalf = DH >= 256;
  static constexpr int kThreads = 256;              // two warpgroups
  static constexpr int kBK = DH >= 192 ? 32 : 64;   // K/V rows per tile
  static constexpr int kBQ = kHalf ? 64 : 128;      // query rows per block
  static constexpr int kDW = kHalf ? DH / 2 : DH;   // Dh columns a warpgroup takes
  static constexpr uint32_t kQBytes = kBQ * DH * 4;
  static constexpr uint32_t kStageBytes = kBK * DH * 4;  // one f32 tile
  static constexpr uint32_t kPlaneBytes = kBK * DH * 2;  // one bf16 plane
  static constexpr int kSmem = kQBytes + 2 * kStageBytes + 6 * kPlaneBytes + 1024;
};

#define DVD_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32, f32) = A (64 x 16, bf16 registers) B (16 x 32, smem, K-major)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], const uint32_t* a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : DVD_D8(0), DVD_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) = A (64 x 16, bf16 registers) B (16 x 64, smem, K-major)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t* a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DVD_D8(0), DVD_D8(8), DVD_D8(16), DVD_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef DVD_D8

// one product into d: B K-major (S's K) or MN-major (P.V's V, n64 or n16)
template <bool KMAJOR, int N>
__device__ __forceinline__ void mma(float (&d)[N], const uint32_t* a, uint64_t b,
                                    int scale_d) {
  if constexpr (KMAJOR)
    wgmma_rs_k(d, a, b, scale_d);
  else if constexpr (N == 32)
    wgmma_rs_n64(d, a, b, scale_d);
  else
    wgmma_rs_n16(d, a, b, scale_d);
}

// the six products of one k16 step, smallest terms first, added to d or,
// where fresh, into d from zero: fr[0..2] are A's h, m, l fragments,
// b[0..2] the descriptors of B's h, m, l planes
template <bool KMAJOR, int N>
__device__ __forceinline__ void six(float (&d)[N], const uint32_t* const (&fr)[3],
                                    const uint64_t (&b)[3], bool fresh) {
  mma<KMAJOR>(d, fr[2], b[0], fresh ? 0 : 1);  // l h
  mma<KMAJOR>(d, fr[0], b[2], 1);              // h l
  mma<KMAJOR>(d, fr[1], b[1], 1);              // m m
  mma<KMAJOR>(d, fr[1], b[0], 1);              // m h
  mma<KMAJOR>(d, fr[0], b[1], 1);              // h m
  mma<KMAJOR>(d, fr[0], b[0], 1);              // h h
}

template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N], float (&part)[N]) {
  fence_regs(part);
#pragma unroll
  for (int e = 0; e < N; ++e) sum[e] += part[e];
}

// byte offset of the 16-byte chunk c (4 f32) of Q's row r: chunks are
// XOR-swizzled by r % 4 within each group of four (one k16 step's), so a
// half-warp's 8-byte fragment loads (rows r..r+3, two chunks each) meet at
// most two to a bank, and a step's offsets are the first step's plus 64
// bytes a step (immediates, not registers)
__device__ __forceinline__ uint32_t q_offset(int dh, int r, int c) {
  return r * dh * 4 + ((c ^ (r & 3)) * 16);
}

// ld.shared of two f32, in order with the wgmma fences around it
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// x, opaque to the compiler: what is computed from it stays after this
// point (register pressure: unrolled steps would otherwise compute every
// step's addresses and descriptors up front)
template <typename T>
__device__ __forceinline__ T pin(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::kThreads, 1) attention_f32x6_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int H, int Tq, int Tk,
    Strides qs, Strides ks, Strides vs, Strides os, float scale_log2) {
  using L = Layout<DH>;
  using C = Cfg<DH>;
  constexpr int kBK = C::kBK, kThreads = C::kThreads;
  constexpr int kChunks = DH / 4;              // 16-byte f32 chunks per row
  constexpr int kNB = C::kDW / L::kCols;  // P.V products per k step, one a block
  constexpr int kNO = L::kCols / 2;       // O registers per product (n64 or n16)
  constexpr int kNS = kBK / 2;                 // S registers per thread
  constexpr int kPK = kBK / 16;                // P.V k16 steps per tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  uint8_t* const gq = smem_raw + (sq - raw);  // the same bytes, generic
  // Q at sq, then the staging area (K then V, f32 [kBK][DH]), then the
  // planes (K h m l, V h m l)
  constexpr uint32_t kStage = C::kQBytes, kPlanes = kStage + 2 * C::kStageBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::kBQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int ntiles = (Tk + kBK - 1) / kBK;

  // rows [t0, t0 + R) of a (T, DH) f32 matrix, 16-byte chunk c of row r to
  // dst + off(r, c); rows at or past T are zero-filled; me: the thread
  auto load_rows = [&](auto off, uint32_t dst, const float* src, long long st,
                       int t0, int T, int R, int me) {
    for (int i = me; i < R * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = t0 + r < T;
      cp_async<16>(dst + off(r, c), ok ? src + (long long)(t0 + r) * st + c * 4 : src,
                   ok ? 16 : 0);
    }
  };
  // tile `tile` of K (which 0) or V (1) into its staging area: each thread
  // copies the 16-byte chunks i = me + it kThreads, which it alone splits
  auto load_mat = [&](int which, int tile, uint32_t base, int me) {
    load_rows([](int r, int c) { return (uint32_t)(r * kChunks + c) * 16; },
              base + kStage + which * C::kStageBytes, which ? vb : kb,
              which ? vs.t : ks.t, tile * kBK, Tk, kBK, me);
  };
  // split chunk i = me + it kThreads of the staged K (which 0) or V (1)
  // into the three bf16 planes: columns 4c..4c+3 of row r, half a 16-byte
  // chunk of the swizzled layout
  constexpr int kPer = kBK * kChunks / kThreads;  // chunks a thread splits
  static_assert(kPer * kThreads == kBK * kChunks, "whole chunks a thread");
  auto split_chunk = [&](uint8_t* g, int which, int me, int it) {
    const int i = me + it * kThreads, r = i / kChunks, c = i % kChunks;
    const float4 x =
        reinterpret_cast<const float4*>(g + kStage + which * C::kStageBytes)[i];
    uint32_t hv[2], mv[2], lv[2];
    split3_pack(x.x, x.y, hv[0], mv[0], lv[0]);
    split3_pack(x.z, x.w, hv[1], mv[1], lv[1]);
    uint8_t* const dst = g + kPlanes + 3 * which * C::kPlaneBytes +
                         L::template offset<kBK>(r, c / 2) + (c % 2) * 8;
    *reinterpret_cast<uint2*>(dst) = make_uint2(hv[0], hv[1]);
    *reinterpret_cast<uint2*>(dst + C::kPlaneBytes) = make_uint2(mv[0], mv[1]);
    *reinterpret_cast<uint2*>(dst + 2 * C::kPlaneBytes) = make_uint2(lv[0], lv[1]);
  };

  // Q and tile 0; K(0) split; K(1) in flight.  From here on each tile j
  // finds K(j) split, V(j) staged and K(j+1) in flight
  load_rows([](int r, int c) { return q_offset(DH, r, c); }, sq, qb, qs.t, q0, Tq,
            C::kBQ, tid);
  load_mat(0, 0, sq, tid);
  load_mat(1, 0, sq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kPer; ++it) split_chunk(gq, 0, tid, it);
  fence_proxy_async();
  if (ntiles > 1) load_mat(0, 1, sq, tid);
  cp_async_commit();

  float acc[kNB][kNO];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < kNO; ++e) acc[n][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  // this thread's rows of Q: lane / 4 and lane / 4 + 8 of its warp's 16;
  // its warpgroup's first Dh column
  const int qrow = (C::kHalf ? 0 : wg * 64) + warp * 16 + lane / 4;
  const int qcol = 2 * (lane % 4);
  const int dh0 = C::kHalf ? wg * C::kDW : 0;

  for (int j = 0; j < ntiles; ++j) {
    // the thread's index, its first row and the shared-memory base, opaque
    // to the compiler once per tile: every address below is the same in
    // every tile, and hoisted out of the tile loop they take more
    // registers than Dh 256 leaves
    int me = tid, row0 = qrow;
    uint32_t base = sq;
    asm volatile("" : "+r"(me), "+r"(row0), "+r"(base));
    uint8_t* const g = gq + (base - sq);  // the same bytes, generic

    cp_async_wait<1>();  // V(j) staged (the chunks this thread splits)
    __syncthreads();     // K(j)'s planes written (and fenced) by every
                         // thread; P V of tile j-1 done: V's planes free
    // this warpgroup's columns of K's and V's planes
    const uint32_t sk = base + kPlanes + dh0 / L::kCols * kBK * L::kRowBytes;
    const uint32_t sv = sk + 3 * C::kPlaneBytes;

    // S = Q K^T: each k16 step's six products into a fresh tensor-core
    // accumulator (sp), added to s in f32 on the CUDA cores (the tensor
    // cores truncate as they accumulate; csrc/conv3x3_f32x6.cu)
    constexpr int kSteps = C::kDW / 16;
    float s[kNS], sp[kNS];
#pragma unroll
    for (int e = 0; e < kNS; ++e) s[e] = sp[e] = 0.f;
    uint32_t qf[2][3][4];
    // this thread's Q fragment at step 0: the shared addresses of its k lo
    // and k hi columns in row lo (row hi is 8 rows on; step kk adds 64
    // bytes), and K's descriptor (step kk adds its column offset)
    const uint32_t qa[2] = {
        base + q_offset(DH, row0, (dh0 + qcol) / 4) + (qcol % 4) * 4,
        base + q_offset(DH, row0, (dh0 + qcol + 8) / 4) + (qcol % 4) * 4};
    const uint64_t kd = make_desc(sk, 16, L::kAtom, L::kMode);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      // built while step kk-1 runs on the tensor cores
      uint32_t(&fr)[3][4] = qf[kk & 1];
      // registers: (row lo, k lo), (row hi, k lo), (row lo, k hi), (row
      // hi, k hi), each two neighbouring columns: k lo = 16kk + 2(lane %
      // 4), k hi = k lo + 8
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 x = lds_f2(pin(qa[r / 2]) + kk * 64 + (r % 2) * 8 * DH * 4);
        split3_pack(x.x, x.y, fr[0][r], fr[1][r], fr[2][r]);
      }
      fence_regs(fr[0]);
      fence_regs(fr[1]);
      fence_regs(fr[2]);
      wgmma_wait<0>();  // step kk-1 is done
      if (kk >= 1) add_to(s, sp);
      wgmma_fence();
      // columns 16kk..16kk+15: column block blk, 32-byte step off in its
      // rows (a descriptor's address is in 16-byte units)
      const uint32_t blk = kk * 16 / L::kCols, off = (kk * 16 % L::kCols) * 2;
      const uint64_t kdk = pin(kd) + ((blk * kBK * L::kRowBytes + off) >> 4);
      const uint64_t bd[3] = {kdk, kdk + (C::kPlaneBytes >> 4),
                              kdk + (2 * C::kPlaneBytes >> 4)};
      const uint32_t* const frp[3] = {fr[0], fr[1], fr[2]};
      six<true>(sp, frp, bd, true);
      wgmma_commit();
      // V(j) into its planes while the products run
#pragma unroll
      for (int it = kk * kPer / kSteps; it < (kk + 1) * kPer / kSteps; ++it)
        split_chunk(g, 1, me, it);
    }
    wgmma_wait<0>();
    add_to(s, sp);
    if constexpr (C::kHalf) {
      // S = the two warpgroups' partial sums, exchanged through each one's
      // own half of K's h plane, which its products have finished reading
      // (the other half is the other warpgroup's): [kNS / 4][128 threads]
      // float4s.  s + other is the same sum in both (f32 addition commutes);
      // K(j+1)'s split overwrites the planes after the barrier below.
      constexpr uint32_t kHalfBytes = C::kDW / L::kCols * kBK * L::kRowBytes;
      float4* const mine = reinterpret_cast<float4*>(g + (sk - base));
      const float4* const other = wg ? mine - kHalfBytes / 16 : mine + kHalfBytes / 16;
      const int t = me % 128;
#pragma unroll
      for (int e = 0; e < kNS / 4; ++e)
        mine[e * 128 + t] = make_float4(s[4 * e], s[4 * e + 1], s[4 * e + 2], s[4 * e + 3]);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kNS / 4; ++e) {
        const float4 x = other[e * 128 + t];
        s[4 * e] += x.x;
        s[4 * e + 1] += x.y;
        s[4 * e + 2] += x.z;
        s[4 * e + 3] += x.w;
      }
    }
    fence_proxy_async();  // V's planes, written by threads, are read by wgmma
    __syncthreads();      // every V plane written; S is done with K's planes
    if (j + 1 < ntiles) load_mat(1, j + 1, base, me);
    cp_async_commit();

    // online softmax; element e of s is row lane / 4 + 8 * ((e / 2) % 2),
    // column 8 * (e / 4) + 2 * (lane % 4) + e % 2 of this warp's 16 x kBK slab
    const int c0 = j * kBK + qcol;
    const bool ragged = j * kBK + kBK > Tk;
#pragma unroll
    for (int e = 0; e < kNS; ++e) {
      const float x = s[e] * scale_log2;
      s[e] = (!ragged || c0 + 8 * (e / 4) + e % 2 < Tk) ? x : -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = row_max[i];
#pragma unroll
      for (int e = 2 * i; e < kNS; e += 4) mx = fmaxf(mx, fmaxf(s[e], s[e + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = ex2(row_max[i] - mx);  // 0 on the first tile
      row_max[i] = mx;                  // finite: every tile has a column < Tk
      float sum = 0.f;
#pragma unroll
      for (int e = 2 * i; e < kNS; e += 4) {
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

    // P in wgmma's A-operand layout, split: k step kk takes columns
    // 16kk..16kk+15, registers 4kk..4kk+3 of each split
    uint32_t p[3][4 * kPK];
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3_pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p[0][4 * kk + r],
                    p[1][4 * kk + r], p[2][4 * kk + r]);

    // O += P V: each 64 columns' products of the tile into a fresh
    // tensor-core accumulator (op), added to O in f32; K(j+1) split into
    // K's planes while the products run
    cp_async_wait<1>();  // K(j+1) staged (the chunks this thread splits)
    fence_regs(p[0]);
    fence_regs(p[1]);
    fence_regs(p[2]);
    const uint64_t vd = make_desc(sv, L::kAtom, L::kAtom, L::kMode);
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      float op[kNO];
#pragma unroll
      for (int e = 0; e < kNO; ++e) op[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPK; ++kk) {
        // 16 rows (two 8-row atoms) of column block n; an n64 product spans
        // exactly one atom's width, so both byte offsets are the atom stride
        const uint64_t vdk =
            pin(vd) + ((n * kBK * L::kRowBytes + kk * 16 * L::kRowBytes) >> 4);
        const uint64_t bd[3] = {vdk, vdk + (C::kPlaneBytes >> 4),
                                vdk + (2 * C::kPlaneBytes >> 4)};
        const uint32_t* const frp[3] = {p[0] + 4 * kk, p[1] + 4 * kk, p[2] + 4 * kk};
        six<false>(op, frp, bd, kk == 0);
      }
      wgmma_commit();
      if (j + 1 < ntiles) {
#pragma unroll
        for (int it = n * kPer / kNB; it < (n + 1) * kPer / kNB; ++it)
          split_chunk(g, 0, me, it);
      }
      wgmma_wait<0>();
      add_to(acc[n], op);
    }
    fence_proxy_async();  // K(j+1)'s planes are read by wgmma in tile j+1
    if (j + 2 < ntiles) load_mat(0, j + 2, base, me);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block (the last group is empty)

  // normalise and write this thread's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = row_sum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int t = q0 + qrow + 8 * i;
    if (t >= Tq) continue;
    float* orow = ob + (long long)t * os.t + dh0 + qcol;
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int c = 0; c < kNO / 4; ++c)
        *reinterpret_cast<float2*>(orow + n * L::kCols + 8 * c) =
            make_float2(acc[n][4 * c + 2 * i] * inv, acc[n][4 * c + 2 * i + 1] * inv);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  auto kern = attention_f32x6_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(dvd::ceil_div(Tq, C::kBQ), B * H);
  const float log2e = 1.4426950408889634f;
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, Tq, Tk, qs,
      ks, vs, os, scale * log2e);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, Strides s) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.t % 4 == 0;
}

}  // namespace

// Dynamic shared memory per block for head dim Dh (-1: no kernel).
extern "C" long long dvd_attention_f32x6_smem_bytes(int Dh) {
  switch (Dh) {
#define DVD_CASE(D) \
    case D: return (long long)Cfg<D>::kSmem;
    DVD_FOR_EACH_DH(DVD_CASE)
#undef DVD_CASE
    default: return -1;
  }
}

extern "C" int dvd_attention_fwd_f32x6(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int Dh, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, float scale, int dtype,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  if (dtype != dvd::kFloat32 || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
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
