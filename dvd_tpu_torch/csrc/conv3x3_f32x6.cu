// K2, float32: 'SAME' 3x3 convolution, dilation d, NCHW, with the f32
// epilogue y = acc * scale + bias and an optional ReLU, computed to f32
// accuracy on Hopper's tensor cores: an implicit GEMM whose every product
// is six bf16 wgmmas over a three-way bf16 split of each operand.
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar
// (_conv_kernel) for float32 inputs (the f32 serving and training paths,
// model.compute_dtype="float32"); bfloat16 goes to conv3x3_wgmma.cu.
// Inputs: x (B, Cin, H, W) f32; the weights as the split K-major copy that
// ops/kernels/conv3x3.py:k_major_weights_split builds from w (Cout, Cin,
// 3, 3): (3, Cout, nchunks * KC) bf16, planes h, m and l with h + m + l ==
// w exactly, Cin cut into chunks of CC channels (8 or 16, by Cin) and a
// chunk's KC columns tap-major, channel-minor (k = tap * CC + c), zero-
// padded to a multiple of 16; scale and bias (Cout,) f32.
//
// The split: x = h + m + l with h = bf16(x), m = bf16(x - h), l = bf16(x -
// h - m), exact for |x| in [2^-100, 2^100] (24 significant bits in three
// bf16 of 8).  A product a b is taken as l_a h_b + h_a l_b + m_a m_b + m_a
// h_b + h_a m_b + h_a h_b, smallest terms first; the dropped m l, l m and
// l l are below 2^-24 of |a b|, one f32 rounding.
// This is the TPU's precision=HIGHEST (six bf16 passes on the MXU).
//
// What bounds it on the H100: operations, at 989 / 6 = 165 TFLOP/s of
// f32-accurate products (against 67 TFLOP/s on the CUDA cores, where
// cuDNN's f32 conv runs).  256->256 at 128^2, batch 4, is 77.3 GFLOP
// against 34 MB (0.469 ms against 0.010 ms at 3.35 TB/s).
//
// Design (conv3x3_wgmma.cu's, with the split):
// - GEMM: M = output pixels (128 or 256 a block: MT = 1 or 2 m64 tiles per
//   warpgroup), N = Cout (BN = 8, 16 or 64 a block), K = 9 taps x Cin.  A
//   block is two consumer warpgroups (256 threads) over a TH x TW pixel
//   tile, chosen per launch on the host (fewest tiles, least halo).
// - Cin runs in chunks of CC channels through a 2-slot cp.async ring.  A
//   slot holds the chunk's three weight planes (the wgmma B operands,
//   K-major 8 x 8 core matrices, no swizzle) and its CC f32 input planes
//   over the halo'd tile ('SAME' zero pad by cp.async's zero fill; three
//   bands of rows or columns where d reaches past the tile).
// - A from registers: each thread loads its m64k16 fragment's 8 f32 values
//   (2 pixels x 4 channels; a tap is a shift of the staged planes, which no
//   descriptor can express) and splits them into three bf16 fragments in
//   registers.  Fragments are double-buffered: a step's six wgmmas per m64
//   tile run while the next step's loads and splits issue.
// - The sum: each k16 step's six products go into a fresh tensor-core
//   accumulator, which the CUDA cores then add to the running f32 sum.
//   The tensor cores truncate as they accumulate, so one accumulator over
//   the whole K drifts from the f32 sum (at Cin 130 and unit-scale inputs
//   a first version, one accumulator for all 6 x 74 products, was off by
//   1.26e-5 on an H100); per step the truncation touches 6 small products.
// - Shared-memory plan: a chunk's weights take 3 BN KC 2 bytes, 55.3 KB at
//   BN 64 and CC 16 (KC 144), 221 KB at BN 128: so BN is at most 64 and CC
//   at most 16, and where Cout is wide and the grid fills two waves a
//   block takes 256 pixels (MT 2), halving the weight bytes per output.
//   Two slots at BN 64, CC 16 and a 256-pixel 8 x 32 tile: 2 x (55.3 KB +
//   16 x 10 x 40 x 4 bytes) = 161 KB of the 227 KB.
// - f32 planes: copies of 16, 8 or 4 bytes (V = 4, 2 or 1 elements, the
//   largest that divides W, the tile width, x's alignment and, in band
//   mode, d); plane pitches are 4 mod 16 words, so the four channel pairs
//   of a warp's fragment load fall in different banks.
// - Epilogue: scale, bias and ReLU in f32, stored straight to the NCHW
//   output planes.
// The planner, the arguments, the pixel and position tables, the wgmma
// wrappers and the epilogue are conv3x3.cuh's, shared with
// conv3x3_wgmma.cu; this file holds the f32 geometry and the kernel body.
#include "conv3x3.cuh"

namespace {

using namespace dvd;
using namespace dvd::conv;

// BN 8-64, CC 8-16, three weight planes; past 227 KB a plan falls back
// from BN 64 to 16 and 8; copies of up to 16 bytes, as x's base allows
constexpr Geometry geometry(int xv) { return Geometry{4, 3, 16, 64, 8, xv}; }

// the largest copy width (4, 2 or 1 f32 elements) that x's base allows
int x_vec(const void* x) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  return a % 16 == 0 ? 4 : a % 8 == 0 ? 2 : 1;
}

template <int BN, int CC, int MT>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_f32x6_kernel(const Args<float> a) {
  constexpr int kK = chunk_k(CC), kSteps = kK / 16;
  constexpr int kPix = 2 * MT;  // pixels per thread
  constexpr uint32_t kPlaneBytes = BN * kK * 2, kBBytes = 3 * kPlaneBytes;
  constexpr int kCoreStride = (BN / 8) * 128;  // bytes between K core matrices
  const Plan& p = a.p;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t abytes = CC * p.ps * 4;
  // slot s: B planes at base + s kBBytes; A at base + 2 kBBytes + s abytes

  const int tid = threadIdx.x, q = tid % 4;
  const int y0 = (blockIdx.x / p.tiles_x) * p.th, x0 = (blockIdx.x % p.tiles_x) * p.tw;
  const int co0 = blockIdx.y * BN;
  const long long hw = (long long)a.H * a.W;
  const float* xb = a.x + (long long)blockIdx.z * a.Cin * hw;
  const long long wplane = (long long)a.Cout * a.nch * kK;  // elements per plane

  int pix[kPix], oy[kPix], ox[kPix];
  bool ok[kPix];
  thread_pixels(p, y0, x0, a.H, a.W, pix, oy, ox, ok);
  int2* const tab = reinterpret_cast<int2*>(gbase + 2 * kBBytes + 2 * abytes);
  table_positions(tab, p, y0, x0, a.d, a.H, a.W);
  // this thread's copies walk (channel, position) in steps of kThreads
  const int pos0 = tid % p.npos, ch0 = tid / p.npos;
  const int dpos = kThreads % p.npos, dch = kThreads / p.npos;
  __syncthreads();

  auto stage = [&](int c, int s) {
    // B: rows co0.. of each weight plane, chunk c's KC columns, into 8 x 8
    // core matrices: (n, k) at ((k / 8) (BN / 8) + n / 8) 128 + (n % 8) 16
    // + (k % 8) 2.  Lane pairs take a row's two neighbouring 16-byte
    // pieces (one 32-byte sector), then the next row.
    constexpr int kRowChunks = kK / 8;  // even
    for (int i = tid; i < 3 * BN * kRowChunks; i += kThreads) {
      const int pl = i / (BN * kRowChunks), j = i % (BN * kRowChunks);
      const int n = (j >> 1) % BN, kg = (j >> 1) / BN * 2 + (j & 1);
      const int co = co0 + n;
      const bool in = co < a.Cout;
      const __nv_bfloat16* src =
          a.wk + pl * wplane + ((long long)(in ? co : 0) * a.nch + c) * kK + kg * 8;
      cp_async<16>(base + s * kBBytes + pl * kPlaneBytes + kg * kCoreStride +
                       (n / 8) * 128 + (n % 8) * 16,
                   src, in ? 16 : 0);
    }
    // A: the chunk's CC input planes at the staged positions
    const int c0 = c * CC;
    const float* xc = xb + c0 * hw;
    const uint32_t sa = base + 2 * kBBytes + s * abytes;
    for (int pp = pos0, ch = ch0; ch < CC;) {
      const int2 t = tab[pp];
      const bool in = t.x >= 0 && c0 + ch < a.Cin;
      const float* src = in ? xc + ch * hw + t.x : xb;
      const uint32_t dst = sa + (ch * p.ps + t.y) * 4;
      if (p.v == 4)
        cp_async<16>(dst, src, in ? 16 : 0);
      else if (p.v == 2)
        cp_async<8>(dst, src, in ? 8 : 0);
      else
        cp_async<4>(dst, src, in ? 4 : 0);
      pp += dpos;
      ch += dch;
      if (pp >= p.npos) {
        pp -= p.npos;
        ++ch;
      }
    }
  };

  // acc: the running sum, in f32 adds on the CUDA cores; part: one k16
  // step's six products, the tensor cores' accumulator (started afresh
  // every step: the tensor cores truncate as they accumulate, so a long
  // chain of products would drift from the f32 sum)
  float acc[MT][BN / 2], part[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[t][e] = part[t][e] = 0.f;
    fence_regs(part[t]);
  }
  auto add_part = [&]() {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      fence_regs(part[t]);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[t][e] += part[t][e];
    }
  };
  const int rowoff = p.rstep * p.scp;
  // [buffer][split h, m, l][4 registers per m64 tile]
  uint32_t afrag[2][3][4 * MT];

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < a.nch; ++c) {
    cp_async_wait<0>();  // chunk c has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();     // ... everyone's; and the other slot is free
    if (c + 1 < a.nch) stage(c + 1, (c + 1) & 1);
    cp_async_commit();
    const int s = c & 1;
    const float* sa = reinterpret_cast<const float*>(gbase + 2 * kBBytes + s * abytes);
    const uint32_t sb = base + s * kBBytes;
    // channel 2q + e of pixel i at tap t: a0[i][e * ps + toff(t)]
    const float* a0[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) a0[i] = sa + 2 * q * p.ps + pix[i];

#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      // built while the step before this one runs on the tensor cores
      uint32_t(&fr)[3][4 * MT] = afrag[k & 1];
      // A fragment of m64 tile t at k16 step k: registers 4t..4t+3 hold
      // (row lo, k lo), (row hi, k lo), (row lo, k hi), (row hi, k hi),
      // each two neighbouring k: k lo = 2q, 2q+1, k hi = 2q+8, 2q+9
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // CC 16: tap k, channels 8h + 2q (+1); CC 8: tap 2k + h,
        // channels 2q (+1)
        const int tap = CC >= 16 ? k : 2 * k + h;
        const int cb = CC >= 16 ? 8 * h : 0;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          uint32_t hi = 0, mid = 0, lo = 0;
          if (tap < 9) {
            const int off = cb * p.ps + (tap / 3) * rowoff + p.cbase + (tap % 3) * p.cstep;
            split3_pack(a0[i][off], a0[i][off + p.ps], hi, mid, lo);
          }
          const int r = 4 * (i / 2) + 2 * h + i % 2;
          fr[0][r] = hi;
          fr[1][r] = mid;
          fr[2][r] = lo;
        }
      }
      fence_regs(fr[0]);
      fence_regs(fr[1]);
      fence_regs(fr[2]);
      wgmma_wait<0>();      // the step before this one is done
      if (k > 0) add_part();
      wgmma_fence();
      // B planes h, m, l of this k16 step
      const uint32_t bo = sb + 2 * k * kCoreStride;
      const uint64_t bh = make_desc(bo, kCoreStride, 128, 0);
      const uint64_t bm = make_desc(bo + kPlaneBytes, kCoreStride, 128, 0);
      const uint64_t bl = make_desc(bo + 2 * kPlaneBytes, kCoreStride, 128, 0);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        // smallest terms first: l h (into a fresh part), h l, m m, m h,
        // h m, h h
        wgmma_rs(part[t], fr[2] + 4 * t, bh, 0);
        wgmma_rs(part[t], fr[0] + 4 * t, bl, 1);
        wgmma_rs(part[t], fr[1] + 4 * t, bm, 1);
        wgmma_rs(part[t], fr[1] + 4 * t, bh, 1);
        wgmma_rs(part[t], fr[0] + 4 * t, bm, 1);
        wgmma_rs(part[t], fr[0] + 4 * t, bh, 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();    // the slot is read before the next barrier frees it
    add_part();
  }

  store_tile<BN, MT>(a, acc, co0, oy, ox, ok);
}

// instances: BN 8, 16, 64 at CC 8 and 16; 256-pixel blocks (MT 2) at BN
// 64 with CC 16
template <int CC>
int dispatch_bn(const Args<float>& a, int B, cudaStream_t s) {
  switch (a.p.bn) {
    case 8: return launch<8>(conv3x3_f32x6_kernel<8, CC, 1>, a, B, s);
    case 16: return launch<16>(conv3x3_f32x6_kernel<16, CC, 1>, a, B, s);
    default:
      if constexpr (CC == 16)
        if (a.p.mt == 2) return launch<64>(conv3x3_f32x6_kernel<64, CC, 2>, a, B, s);
      return launch<64>(conv3x3_f32x6_kernel<64, CC, 1>, a, B, s);
  }
}

}  // namespace

// The launch's plan for these sizes (x 16-byte aligned), into out[0..8]:
// BN, CC, MT, TH, TW, the copy width V in f32 elements, dynamic shared
// memory per block, blocks in the grid, and the split K-major weights'
// columns per output channel.  Returns 0, or -1 where the kernel takes no
// such input.
extern "C" int dvd_conv3x3_f32x6_plan(int B, int Cin, int Cout, int H, int W,
                                      int dil, long long* out) {
  Plan p;
  if (!sizes_taken(B, Cin, Cout, H, W, dil) ||
      !make_plan(geometry(4), Cin, Cout, H, W, dil, B, p))
    return kNotTaken;
  plan_values(p, B, Cin, Cout, out);
  return 0;
}

// x (B, Cin, H, W) f32, wk (3, Cout, nchunks * KC) bf16 as
// k_major_weights_split builds it, scale and bias (Cout,) f32, out (B,
// Cout, H, W) f32.  Returns -1 for an input the kernel does not take
// (sizes, a base not 4-byte aligned), else the launch's cudaError_t.
extern "C" int dvd_conv3x3_f32x6(const void* x, const void* wk, const void* scale,
                                 const void* bias, void* out, int B, int Cin,
                                 int Cout, int H, int W, int dil, int relu,
                                 void* stream) {
  Args<float> a{(const float*)x, (const __nv_bfloat16*)wk, (const float*)scale,
                (const float*)bias, (float*)out, Cin, Cout, H, W, dil, relu, 0, {}};
  if (!sizes_taken(B, Cin, Cout, H, W, dil) || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(wk) % 16 ||
      !make_plan(geometry(x_vec(x)), Cin, Cout, H, W, dil, B, a.p) ||
      (long long)dvd::ceil_div(Cout, a.p.bn) > 65535)
    return kNotTaken;
  a.nch = dvd::ceil_div(Cin, a.p.cc);
  cudaStream_t s = (cudaStream_t)stream;
  return a.p.cc == 8 ? dispatch_bn<8>(a, B, s) : dispatch_bn<16>(a, B, s);
}
