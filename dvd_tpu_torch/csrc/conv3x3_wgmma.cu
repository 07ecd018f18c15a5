// K2, bfloat16: 'SAME' 3x3 convolution, dilation d, NCHW, with the f32
// epilogue y = acc * scale + bias, an optional ReLU and a bf16 output, as
// an implicit GEMM on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar
// (_conv_kernel) for bf16 inputs; float32 goes to the split-product kernel
// in conv3x3_f32x6.cu.  Inputs: x (B, Cin, H, W) bf16 with a 16-byte aligned base;
// the weights as the K-major copy that ops/kernels/conv3x3.py:k_major_weights
// builds from w (Cout, Cin, 3, 3): (Cout, nchunks * KC) bf16, where Cin is
// cut into chunks of CC channels (8, 16 or 32, by Cin) and a chunk's KC
// columns run tap-major, channel-minor (k = tap * CC + c), zero-padded to a
// multiple of 16; scale and bias (Cout,) f32.  Products in bf16, sums in
// f32 (the tensor cores' accumulators).
//
// GEMM: M = output pixels (a TH x TW tile of 128 or 256 per block: MT = 1
// or 2 m64 tiles per warpgroup), N = output channels (BN = 8, 16, 64 or 128
// per block, by Cout), K = 9 taps x Cin.
//
// What bounds it on the H100: operations at the wide layers (256->256 at
// 128^2, batch 4, is 77.3 GFLOP against 34 MB: 0.078 ms at 989 TFLOP/s
// against 0.010 ms at 3.35 TB/s); U2NetP's 16-channel layers are small and
// near launch latency whatever the kernel does.  Inside the kernel the
// limit is the shared memory's issue rate against the tensor cores: a
// tap's A operand is the input tile shifted by (ky d, kx d) pixels, which
// in NCHW is a 2-byte shift for odd kx d, so neither a wgmma descriptor nor
// ldmatrix can read it.  Each thread builds its m64k16 A fragment instead,
// with 8 two-byte shared loads per k16 step (2 pixels x 4 channels), and
// issues wgmma with A from registers.  Per k16 step a warpgroup makes 32
// such loads (4 KB of shared reads) and the tensor cores do 64 x BN x 16
// products: at BN 128 that is one 2-byte load per 512 products, and the
// B tile (4 KB, read by wgmma) costs as much again.  So BN is as wide as
// Cout allows (up to 128) and two warpgroups share every staged tile.
//
// Design:
// - A block is two consumer warpgroups (256 threads) over 128 MT output
//   pixels and BN output channels; grid (pixel tiles, Cout / BN, batch).
//   The tile shape (TW columns by TH = 128 MT / TW rows) is chosen per
//   launch on the host from the plane and the dilation (fewest tiles, least
//   halo), so the 9^2, 18^2 and 36^2 planes fill most of the rows.
// - The copies into shared memory, not the tensor cores, set the pace at
//   the wide layers: a chunk's weights (BN x KC, 72 KB at BN 128) are
//   staged again by every block, and timing the kernel without its copies
//   halves it.  So where Cout is wide (BN 128) and the grid still fills
//   two waves, a block takes 256 pixels (MT = 2: each warpgroup runs two
//   m64 products per k16 step on one B tile), which halves the weight bytes
//   per output; small planes (36^2 and below) keep 128 to fill the SMs.
// - Cin runs in chunks of CC channels through a 2-slot cp.async ring:
//   chunk c+1 copies while chunk c computes, one __syncthreads per chunk.
//   A slot holds the chunk's BN x KC weights (the wgmma B operand, K-major,
//   no swizzle: 8 x 8 core matrices of 128 contiguous bytes, conflict-free
//   for wgmma) and the chunk's CC input planes over the halo'd tile, as
//   plain NCHW rows in shared memory.  The halo is the 'SAME' zero pad:
//   copies outside the plane use cp.async's zero fill.  Where the dilation
//   reaches past the tile (d >= TH or TW) only the three bands of rows or
//   columns the taps read are staged, not the gap between them.
// - Rows of planes whose W is not a multiple of 8 are not 16-byte aligned:
//   the copies are 16, 8 or 4 bytes wide (V = 8, 4 or 2 elements, the
//   largest that divides W, the tile width and, in band mode, d), and odd
//   W (9^2, odd test planes) is staged with plain 2-byte loads and stores.
// - Plane pitches are 8 mod 32 elements, so the four channels a warp's
//   load touches fall in different banks.
// - The staged positions' global and shared offsets are tabled once per
//   block, so a copy costs no division.
// - Narrow Cin stacks taps into K as the TPU kernel does: at CC 8 (Cin <=
//   8) one k16 step covers two taps, so Cin 3 or 4 costs 5 steps, not 9.
// - A fragments are double-buffered in registers, one k16 step per group:
//   a step's wgmmas run while the next step's loads issue
//   (wgmma.wait_group 1 frees the buffer two steps back).
// - Each thread fences (fence.proxy.async) before the barrier that
//   precedes a wgmma reading what the copies wrote.
// - Epilogue: the accumulators are in wgmma's layout (a thread holds 2
//   pixels x BN/4 channels); scale, bias and ReLU in f32, then stored
//   straight to the NCHW planes as bf16, 8 neighbouring pixels of one
//   channel (16 bytes) per 8 lanes.  Not staged through shared memory:
//   the output is 1/(9 Cin) of the operations' bytes at the wide layers.
// The planner, the arguments, the pixel and position tables, the wgmma
// wrappers and the epilogue are conv3x3.cuh's, shared with
// conv3x3_f32x6.cu; this file holds the bf16 geometry and the kernel body.
#include "conv3x3.cuh"

namespace {

using namespace dvd;
using namespace dvd::conv;

// BN 8-128, CC 8-32; past 227 KB a BN 128 plan falls back to 64 only
constexpr Geometry kGeom{2, 1, 32, 128, 64, 8};

template <int BN, int CC, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma_kernel(const Args<__nv_bfloat16> a) {
  constexpr int kK = chunk_k(CC), kSteps = kK / 16;
  constexpr int kPix = 2 * MT;  // pixels per thread
  constexpr uint32_t kBBytes = BN * kK * 2;
  constexpr int kCoreStride = (BN / 8) * 128;  // bytes between K core matrices
  const Plan& p = a.p;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t abytes = CC * p.ps * 2;
  // slot s: B at base + s kBBytes; A at base + 2 kBBytes + s abytes

  const int tid = threadIdx.x, q = tid % 4;
  const int y0 = (blockIdx.x / p.tiles_x) * p.th, x0 = (blockIdx.x % p.tiles_x) * p.tw;
  const int co0 = blockIdx.y * BN;
  const long long hw = (long long)a.H * a.W;
  const __nv_bfloat16* xb = a.x + (long long)blockIdx.z * a.Cin * hw;

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
    // B: rows co0.. of the K-major weights, chunk c's KC columns, into
    // 8 x 8 core matrices: (n, k) at ((k / 8) (BN / 8) + n / 8) 128 +
    // (n % 8) 16 + (k % 8) 2.  Lane pairs take a row's two neighbouring
    // 16-byte pieces (one 32-byte sector), then the next row.
    const uint32_t sb = base + s * kBBytes;
    constexpr int kRowChunks = kK / 8;  // even
    for (int i = tid; i < BN * kRowChunks; i += kThreads) {
      const int n = (i >> 1) % BN, kg = (i >> 1) / BN * 2 + (i & 1);
      const int co = co0 + n;
      const bool in = co < a.Cout;
      const __nv_bfloat16* src =
          a.wk + ((long long)(in ? co : 0) * a.nch + c) * kK + kg * 8;
      cp_async<16>(sb + kg * kCoreStride + (n / 8) * 128 + (n % 8) * 16, src, in ? 16 : 0);
    }
    // A: the chunk's CC input planes at the staged positions
    const int c0 = c * CC;
    const __nv_bfloat16* xc = xb + c0 * hw;
    const uint32_t sa = base + 2 * kBBytes + s * abytes;
    unsigned short* const sa_g = reinterpret_cast<unsigned short*>(gbase + 2 * kBBytes + s * abytes);
    for (int pp = pos0, ch = ch0; ch < CC;) {
      const int2 t = tab[pp];
      const bool in = t.x >= 0 && c0 + ch < a.Cin;
      const __nv_bfloat16* src = in ? xc + ch * hw + t.x : xb;
      const int dst = ch * p.ps + t.y;
      if (p.v == 8)
        cp_async<16>(sa + dst * 2, src, in ? 16 : 0);
      else if (p.v == 4)
        cp_async<8>(sa + dst * 2, src, in ? 8 : 0);
      else if (p.v == 2)
        cp_async<4>(sa + dst * 2, src, in ? 4 : 0);
      else  // odd W: a plain 2-byte load and store
        sa_g[dst] = in ? __ldg(reinterpret_cast<const unsigned short*>(src)) : (unsigned short)0;
      pp += dpos;
      ch += dch;
      if (pp >= p.npos) {
        pp -= p.npos;
        ++ch;
      }
    }
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[t][e] = 0.f;
    fence_regs(acc[t]);
  }
  const int rowoff = p.rstep * p.scp;
  uint32_t afrag[2][4 * MT];

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < a.nch; ++c) {
    cp_async_wait<0>();  // chunk c has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();     // ... everyone's; and the other slot is free
    if (c + 1 < a.nch) stage(c + 1, (c + 1) & 1);
    cp_async_commit();
    const int s = c & 1;
    const unsigned short* sa =
        reinterpret_cast<const unsigned short*>(gbase + 2 * kBBytes + s * abytes);
    const uint32_t sb = base + s * kBBytes;
    // channel 2q + e of pixel i at tap t: a0[i][e * ps + toff(t)]
    const unsigned short* a0[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) a0[i] = sa + 2 * q * p.ps + pix[i];

#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      uint32_t(&fr)[4 * MT] = afrag[k & 1];
      // A fragment of m64 tile t at k16 step k: registers 4t..4t+3 hold
      // (row lo, k lo), (row hi, k lo), (row lo, k hi), (row hi, k hi),
      // each two neighbouring k: k lo = 2q, 2q+1, k hi = 2q+8, 2q+9
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // CC >= 16: tap k / (CC / 16), channels 16 (k % (CC / 16)) + 8h +
        // 2q (+1); CC 8: tap 2k + h, channels 2q (+1)
        const int tap = CC >= 16 ? k / (CC / 16) : 2 * k + h;
        const int cb = CC >= 16 ? 16 * (k % (CC / 16)) + 8 * h : 0;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          uint32_t v = 0;
          if (tap < 9) {
            const int off = cb * p.ps + (tap / 3) * rowoff + p.cbase + (tap % 3) * p.cstep;
            v = (uint32_t)a0[i][off] | ((uint32_t)a0[i][off + p.ps] << 16);
          }
          fr[4 * (i / 2) + 2 * h + i % 2] = v;
        }
      }
      fence_regs(fr);
      wgmma_fence();
      const uint64_t bdesc = make_desc(sb + 2 * k * kCoreStride, kCoreStride, 128, 0);
#pragma unroll
      for (int t = 0; t < MT; ++t) wgmma_rs(acc[t], fr + 4 * t, bdesc, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done: its A is free
    }
    wgmma_wait<0>();    // the slot is read before the next barrier frees it
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
  }

  store_tile<BN, MT>(a, acc, co0, oy, ox, ok);
}

// instances: BN 8, 16, 64, 128 at every CC; 256-pixel blocks (MT 2) at
// BN 128 with CC 16 and 32
template <int BN, int CC>
int dispatch_mt(const Args<__nv_bfloat16>& a, int B, cudaStream_t s) {
  if constexpr (BN == 128 && CC >= 16)
    if (a.p.mt == 2) return launch<BN>(conv3x3_wgmma_kernel<BN, CC, 2>, a, B, s);
  return launch<BN>(conv3x3_wgmma_kernel<BN, CC, 1>, a, B, s);
}

template <int CC>
int dispatch_bn(const Args<__nv_bfloat16>& a, int B, cudaStream_t s) {
  switch (a.p.bn) {
    case 8: return dispatch_mt<8, CC>(a, B, s);
    case 16: return dispatch_mt<16, CC>(a, B, s);
    case 64: return dispatch_mt<64, CC>(a, B, s);
    default: return dispatch_mt<128, CC>(a, B, s);
  }
}

}  // namespace

// The launch's plan for these sizes, into out[0..8]: BN, CC, MT, TH, TW,
// the copy width V (1: plain loads), dynamic shared memory per block,
// blocks in the grid, and the K-major weights' columns per output channel.
// Returns 0, or -1 where the kernel takes no such input.
extern "C" int dvd_conv3x3_wgmma_plan(int B, int Cin, int Cout, int H, int W,
                                      int dil, long long* out) {
  Plan p;
  if (!sizes_taken(B, Cin, Cout, H, W, dil) || !make_plan(kGeom, Cin, Cout, H, W, dil, B, p))
    return kNotTaken;
  plan_values(p, B, Cin, Cout, out);
  return 0;
}

// x (B, Cin, H, W), wk (Cout, nchunks * KC) as k_major_weights builds it,
// scale and bias (Cout,) f32, out (B, Cout, H, W); all bf16 but scale and
// bias.  Returns -1 for an input the kernel does not take (sizes, a base
// not 16-byte aligned), else the launch's cudaError_t.
extern "C" int dvd_conv3x3_wgmma(const void* x, const void* wk, const void* scale,
                                 const void* bias, void* out, int B, int Cin,
                                 int Cout, int H, int W, int dil, int relu,
                                 void* stream) {
  Args<__nv_bfloat16> a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)wk,
                        (const float*)scale, (const float*)bias, (__nv_bfloat16*)out,
                        Cin, Cout, H, W, dil, relu, 0, {}};
  if (!sizes_taken(B, Cin, Cout, H, W, dil) || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wk) % 16 ||
      !make_plan(kGeom, Cin, Cout, H, W, dil, B, a.p) ||
      (long long)dvd::ceil_div(Cout, a.p.bn) > 65535)
    return kNotTaken;
  a.nch = dvd::ceil_div(Cin, a.p.cc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.p.cc) {
    case 8: return dispatch_bn<8>(a, B, s);
    case 16: return dispatch_bn<16>(a, B, s);
    default: return dispatch_bn<32>(a, B, s);
  }
}
