// K2, bfloat16: 'SAME' 3x3 convolution, dilation d, NCHW, with the f32
// epilogue y = acc * scale + bias, an optional ReLU and a bf16 output, as
// an implicit GEMM on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar
// (_conv_kernel) for bf16 inputs; float32 stays on the CUDA-core kernel in
// conv3x3.cu.  Inputs: x (B, Cin, H, W) bf16 with a 16-byte aligned base;
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
#include "hopper.cuh"

namespace {

using namespace dvd;

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kMinBlocks = 2 * 132;  // two waves on the H100's SMs
constexpr int kMaxDilation = 32;
constexpr long long kMaxSmem = 232448;  // the 227 KB a block may use
constexpr int kNotTaken = -1;  // the entry's code for an input it refuses

// input channels per chunk, by Cin (ops/kernels/conv3x3.py:chunk_channels)
int chunk_channels(int cin) { return cin <= 8 ? 8 : cin <= 16 ? 16 : 32; }

// output channels per block, by Cout
int block_n(int cout) { return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 64 ? 64 : 128; }

// K columns per chunk: 9 taps x cc, padded to wgmma's k step of 16
__host__ __device__ constexpr int chunk_k(int cc) { return (9 * cc + 15) / 16 * 16; }

// The launch's tiling and staging geometry, chosen on the host.
struct Plan {
  int th, tw, tiles_x, tiles;  // output tile TH x TW, tiles per row, in all
  int v;                       // copy width in elements (8, 4, 2; 1: plain)
  int sr, sc, scp, ps;         // staged rows, columns, row and plane pitch
  int npos;                    // staged (row, v columns) positions: sr sc / v
  int row_band, col_band;      // d >= TH (TW): three bands are staged
  int pad;                     // columns staged left of the tile (>= d)
  int rstep, cstep, cbase;     // tap (ky, kx) -> staged row ty + ky rstep,
                               // column tx + cbase + kx cstep
  int bn, cc, mt;              // BN, CC; m64 tiles per warpgroup
  long long smem;
};

long long smem_bytes(int bn, int cc, int ps, int npos) {
  // two slots of (B tile, A planes), the staged positions' table, and 128
  // bytes to align the base
  return 2LL * (bn * chunk_k(cc) * 2 + (long long)cc * ps * 2) + 8LL * npos + 128;
}

// The best tile for blocks of 128 * mt output pixels, or false where none
// fits in shared memory.
bool plan_tiles(int Cin, int Cout, int H, int W, int d, int mt, Plan& out) {
  long long best = -1;
  const int cc = chunk_channels(Cin), bm = 128 * mt;
  for (int tw = 1; tw <= (W < 64 ? W : 64); ++tw) {
    Plan q{};
    q.cc = cc;
    q.mt = mt;
    q.tw = tw;
    q.th = bm / tw < H ? bm / tw : H;
    int v = 8;
    while (v > 1 && (W % v || tw % v)) v /= 2;
    q.col_band = d >= tw;
    if (q.col_band)
      while (v > 1 && d % v) v /= 2;
    q.v = v;
    q.row_band = d >= q.th;
    q.rstep = q.row_band ? q.th : d;
    q.sr = q.th + 2 * q.rstep;
    q.pad = (d + v - 1) / v * v;
    q.sc = q.col_band ? 3 * tw : tw + 2 * q.pad;
    q.cstep = q.col_band ? tw : d;
    q.cbase = q.col_band ? 0 : q.pad - d;
    q.scp = (q.sc + 7) / 8 * 8;
    q.ps = (q.sr * q.scp + 23) / 32 * 32 + 8;  // 8 mod 32, >= sr * scp
    q.tiles_x = ceil_div(W, tw);
    q.tiles = q.tiles_x * ceil_div(H, q.th);
    q.npos = q.sr * (q.sc / v);
    q.bn = block_n(Cout);
    q.smem = smem_bytes(q.bn, cc, q.ps, q.npos);
    if (q.smem > kMaxSmem && q.bn == 128) {
      q.bn = 64;
      q.smem = smem_bytes(q.bn, cc, q.ps, q.npos);
    }
    if (q.smem > kMaxSmem) continue;
    // a tile's products against its staging; narrow copies cost more
    const long long per_px = v >= 4 ? 1 : v == 2 ? 2 : 4;
    const long long cost = (long long)q.tiles * (512 * mt + (long long)q.sr * q.sc * per_px);
    if (best < 0 || cost < best) {
      best = cost;
      out = q;
    }
  }
  return best >= 0;
}

// Blocks of 256 pixels (two m64 tiles per warpgroup) halve the weights
// staged per output at BN 128 where the grid still fills two waves; else
// 128 (at BN 64 the taller tile's halo and narrower copies cost more than
// the weights they save).
bool make_plan(int Cin, int Cout, int H, int W, int d, int B, Plan& out) {
  if (!plan_tiles(Cin, Cout, H, W, d, 1, out)) return false;
  Plan two;
  if (out.bn == 128 && out.cc >= 16 && plan_tiles(Cin, Cout, H, W, d, 2, two) &&
      two.bn == out.bn &&
      (long long)two.tiles * ceil_div(Cout, two.bn) * B >= kMinBlocks)
    out = two;
  return true;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wk;
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  int Cin, Cout, H, W, d, relu, nch;
  Plan p;
};

#define DVD_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DVD_ACC16(i) DVD_ACC4(i), DVD_ACC4(i + 4), DVD_ACC4(i + 8), DVD_ACC4(i + 12)
#define DVD_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : DVD_ACC4(0)
      : DVD_A4, "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : DVD_ACC4(0), DVD_ACC4(4)
      : DVD_A4, "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DVD_ACC16(0), DVD_ACC16(16)
      : DVD_A4, "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : DVD_ACC16(0), DVD_ACC16(16), DVD_ACC16(32), DVD_ACC16(48)
      : DVD_A4, "l"(b), "r"(1));
}

#undef DVD_A4
#undef DVD_ACC16
#undef DVD_ACC4

// global row of staged row sr (contiguous: from y0 - d; bands: TH rows at
// y0 - d, y0, y0 + d), and likewise for columns
__device__ __forceinline__ int staged_row(const Plan& p, int y0, int d, int sr) {
  return p.row_band ? y0 + sr % p.th + (sr / p.th - 1) * d : y0 - d + sr;
}
__device__ __forceinline__ int staged_col(const Plan& p, int x0, int d, int sc) {
  return p.col_band ? x0 + sc % p.tw + (sc / p.tw - 1) * d : x0 - p.pad + sc;
}

template <int BN, int CC, int MT>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_wgmma_kernel(const Args a) {
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

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  const int y0 = (blockIdx.x / p.tiles_x) * p.th, x0 = (blockIdx.x % p.tiles_x) * p.tw;
  const int co0 = blockIdx.y * BN;
  const long long hw = (long long)a.H * a.W;
  const __nv_bfloat16* xb = a.x + (long long)blockIdx.z * a.Cin * hw;

  // this thread's pixels: rows lane/4 and lane/4 + 8 of its warp's 16 in
  // each of its warpgroup's MT m64 tiles (pixel i: tile i / 2, row i % 2)
  int pix[kPix], oy[kPix], ox[kPix];
  bool ok[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int m = 128 * (i / 2) + 64 * wg + 16 * warp + lane / 4 + 8 * (i % 2);
    int ty = m / p.tw, tx = m % p.tw;
    ok[i] = ty < p.th && y0 + ty < a.H && x0 + tx < a.W;
    if (ty >= p.th) ty = tx = 0;  // rows past the tile: computed, not stored
    oy[i] = y0 + ty;
    ox[i] = x0 + tx;
    pix[i] = ty * p.scp + tx;
  }

  // the staged positions (row r, v columns from sc), once per block:
  // (offset in the plane or -1 outside it, offset in a staged plane)
  int2* const tab = reinterpret_cast<int2*>(gbase + 2 * kBBytes + 2 * abytes);
  {
    const int per_row = p.sc / p.v;
    for (int i = tid; i < p.npos; i += kThreads) {
      const int r = i / per_row, sc = i % per_row * p.v;
      const int gy = staged_row(p, y0, a.d, r), gx = staged_col(p, x0, a.d, sc);
      // W, gx and the tile are multiples of v: a copy is all in or all out
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      tab[i] = make_int2(in ? gy * a.W + gx : -1, r * p.scp + sc);
    }
  }
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
      for (int t = 0; t < MT; ++t) wgmma_rs(acc[t], fr + 4 * t, bdesc);
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done: its A is free
    }
    wgmma_wait<0>();    // the slot is read before the next barrier frees it
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
  }

  // acc[t][e]: pixel 2t + (e / 2) % 2, channel co0 + 8 (e / 4) + 2q + e % 2
  const long long out_b = (long long)blockIdx.z * a.Cout;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = 2 * t + (e / 2) % 2;
      const int co = co0 + 8 * (e / 4) + 2 * q + e % 2;
      if (!ok[i] || co >= a.Cout) continue;
      float y = fmaf(acc[t][e], a.scale[co], a.bias[co]);
      if (a.relu) y = fmaxf(y, 0.f);
      a.out[((out_b + co) * a.H + oy[i]) * a.W + ox[i]] = __float2bfloat16(y);
    }
}

template <int BN, int CC, int MT>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = conv3x3_wgmma_kernel<BN, CC, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.p.tiles, dvd::ceil_div(a.Cout, BN), B);
  kern<<<grid, kThreads, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// instances: BN 8, 16, 64, 128 at every CC; 256-pixel blocks (MT 2) at
// BN 128 with CC 16 and 32
template <int BN, int CC>
int dispatch_mt(const Args& a, int B, cudaStream_t s) {
  if constexpr (BN == 128 && CC >= 16)
    if (a.p.mt == 2) return launch<BN, CC, 2>(a, B, s);
  return launch<BN, CC, 1>(a, B, s);
}

template <int CC>
int dispatch_bn(const Args& a, int B, cudaStream_t s) {
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
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || dil < 1 ||
      dil > kMaxDilation || !make_plan(Cin, Cout, H, W, dil, B, p))
    return kNotTaken;
  const long long vals[9] = {p.bn, p.cc, p.mt, p.th, p.tw, p.v, p.smem,
                             (long long)p.tiles * dvd::ceil_div(Cout, p.bn) * B,
                             (long long)dvd::ceil_div(Cin, p.cc) * chunk_k(p.cc)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
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
  Args a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)wk, (const float*)scale,
         (const float*)bias, (__nv_bfloat16*)out, Cin, Cout, H, W, dil, relu, 0, {}};
  if (B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || dil < 1 ||
      dil > kMaxDilation || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wk) % 16 || !make_plan(Cin, Cout, H, W, dil, B, a.p) ||
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
