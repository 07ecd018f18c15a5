// Building blocks shared by the two K2 kernels (conv3x3_wgmma.cu, bf16;
// conv3x3_f32x6.cu, f32): the launch's tiling and staging plan, chosen on
// the host from a kernel's Geometry; the kernel arguments; each thread's
// output pixels; the staged positions' table; wgmma with A from registers
// and a K-major B; and the f32 epilogue.
#pragma once

#include "hopper.cuh"

namespace dvd {
namespace conv {

constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kMinBlocks = 2 * 132;     // two waves on the H100's SMs
constexpr int kMaxDilation = 32;
constexpr long long kMaxSmem = 232448;  // the 227 KB a block may use
constexpr int kNotTaken = -1;  // an entry's code for an input it refuses

// K columns per chunk: 9 taps x cc, padded to wgmma's k step of 16
__host__ __device__ constexpr int chunk_k(int cc) { return (9 * cc + 15) / 16 * 16; }

// What sets one kernel's plans apart from the other's.
struct Geometry {
  int esize;   // bytes per input element: 2 (bf16) or 4 (f32)
  int planes;  // bf16 weight planes: 1, or 3 (the split h, m, l)
  int cc_max;  // widest chunk of input channels with an instance
  int bn_max;  // widest block of output channels with an instance
  int bn_min;  // narrowest block a plan falls back to where two slots do not fit
  int vmax;    // widest copy in elements: 16 bytes, or less for x's alignment
};

// input channels per chunk, by Cin (ops/kernels/conv3x3.py:chunk_channels)
inline int chunk_channels(const Geometry& g, int cin) {
  const int cc = cin <= 8 ? 8 : cin <= 16 ? 16 : 32;
  return cc < g.cc_max ? cc : g.cc_max;
}

// output channels per block, by Cout
inline int block_n(const Geometry& g, int cout) {
  const int bn = cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 64 ? 64 : 128;
  return bn < g.bn_max ? bn : g.bn_max;
}

// The launch's tiling and staging geometry, chosen on the host.
struct Plan {
  int th, tw, tiles_x, tiles;  // output tile TH x TW, tiles per row, in all
  int v;                       // copy width in elements (1: the narrowest)
  int sr, sc, scp, ps;         // staged rows, columns, row and plane pitch
  int npos;                    // staged (row, v columns) positions: sr sc / v
  int row_band, col_band;      // d >= TH (TW): three bands are staged
  int pad;                     // columns staged left of the tile (>= d)
  int rstep, cstep, cbase;     // tap (ky, kx) -> staged row ty + ky rstep,
                               // column tx + cbase + kx cstep
  int bn, cc, mt;              // BN, CC; m64 tiles per warpgroup
  long long smem;
};

inline long long smem_bytes(const Geometry& g, int bn, int cc, int ps, int npos) {
  // two slots of (the B planes, the A planes), the staged positions'
  // table, and 128 bytes to align the base
  return 2LL * ((long long)g.planes * bn * chunk_k(cc) * 2 + (long long)cc * ps * g.esize) +
         8LL * npos + 128;
}

// The best tile for blocks of 128 * mt output pixels, or false where none
// fits in shared memory.
inline bool plan_tiles(const Geometry& g, int Cin, int Cout, int H, int W, int d, int mt,
                       Plan& out) {
  long long best = -1;
  const int cc = chunk_channels(g, Cin), bm = 128 * mt;
  // plane pitches are 4 mod 16 words, so the four channels (bf16) or
  // channel pairs (f32) of a warp's fragment load fall in different banks
  const int period = 64 / g.esize, off = 16 / g.esize;
  for (int tw = 1; tw <= (W < 64 ? W : 64); ++tw) {
    Plan q{};
    q.cc = cc;
    q.mt = mt;
    q.tw = tw;
    q.th = bm / tw < H ? bm / tw : H;
    int v = g.vmax;
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
    q.ps = (q.sr * q.scp + period - off - 1) / period * period + off;  // >= sr * scp
    q.tiles_x = ceil_div(W, tw);
    q.tiles = q.tiles_x * ceil_div(H, q.th);
    q.npos = q.sr * (q.sc / v);
    q.bn = block_n(g, Cout);
    q.smem = smem_bytes(g, q.bn, cc, q.ps, q.npos);
    while (q.smem > kMaxSmem && q.bn > g.bn_min) {  // 128 -> 64 -> 16 -> 8
      q.bn = q.bn == 128 ? 64 : q.bn == 64 ? 16 : 8;
      q.smem = smem_bytes(g, q.bn, cc, q.ps, q.npos);
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
// staged per output at the widest BN and CC >= 16 where the grid still
// fills two waves; else 128 (at narrower BN the taller tile's halo and
// narrower copies cost more than the weights they save).
inline bool make_plan(const Geometry& g, int Cin, int Cout, int H, int W, int d, int B,
                      Plan& out) {
  if (!plan_tiles(g, Cin, Cout, H, W, d, 1, out)) return false;
  Plan two;
  if (out.bn == g.bn_max && out.cc >= 16 && plan_tiles(g, Cin, Cout, H, W, d, 2, two) &&
      two.bn == out.bn &&
      (long long)two.tiles * ceil_div(Cout, two.bn) * B >= kMinBlocks)
    out = two;
  return true;
}

// sizes an entry takes, before its plan
inline bool sizes_taken(int B, int Cin, int Cout, int H, int W, int dil) {
  return B > 0 && Cin > 0 && Cout > 0 && H > 0 && W > 0 && dil >= 1 && dil <= kMaxDilation;
}

// A plan entry's report, into out[0..8]: BN, CC, MT, TH, TW, the copy
// width V in elements, dynamic shared memory per block, blocks in the
// grid, and the K-major weights' columns per output channel.
inline void plan_values(const Plan& p, int B, int Cin, int Cout, long long* out) {
  const long long vals[9] = {p.bn, p.cc, p.mt, p.th, p.tw, p.v, p.smem,
                             (long long)p.tiles * ceil_div(Cout, p.bn) * B,
                             (long long)ceil_div(Cin, p.cc) * chunk_k(p.cc)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
}

// x and out in T (bf16 or f32); wk the K-major bf16 weight planes
template <typename T>
struct Args {
  const T* x;
  const __nv_bfloat16* wk;
  const float* scale;
  const float* bias;
  T* out;
  int Cin, Cout, H, W, d, relu, nch;
  Plan p;
};

// kern over the plan's grid (pixel tiles, Cout / BN, batch) with its
// dynamic shared memory
template <int BN, typename A>
int launch(void (*kern)(A), const A& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.p.tiles, ceil_div(a.Cout, BN), B);
  kern<<<grid, kThreads, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

#define DVD_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DVD_ACC16(i) DVD_ACC4(i), DVD_ACC4(i + 4), DVD_ACC4(i + 8), DVD_ACC4(i + 12)
#define DVD_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// d (64 x N, f32) = A (64 x 16, bf16 registers) B (16 x N, smem, K-major)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t* a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : DVD_ACC4(0)
      : DVD_A4, "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : DVD_ACC4(0), DVD_ACC4(4)
      : DVD_A4, "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DVD_ACC16(0), DVD_ACC16(16)
      : DVD_A4, "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : DVD_ACC16(0), DVD_ACC16(16), DVD_ACC16(32), DVD_ACC16(48)
      : DVD_A4, "l"(b), "r"(scale_d));
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

// This thread's output pixels: rows lane/4 and lane/4 + 8 of its warp's
// 16 in each of its warpgroup's MT m64 tiles (pixel i: tile i / 2, row i %
// 2), as the offset in a staged plane, the output row and column, and
// whether it is stored.
template <int kPix>
__device__ __forceinline__ void thread_pixels(const Plan& p, int y0, int x0, int H, int W,
                                              int (&pix)[kPix], int (&oy)[kPix],
                                              int (&ox)[kPix], bool (&ok)[kPix]) {
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int m = 128 * (i / 2) + 64 * wg + 16 * warp + lane / 4 + 8 * (i % 2);
    int ty = m / p.tw, tx = m % p.tw;
    ok[i] = ty < p.th && y0 + ty < H && x0 + tx < W;
    if (ty >= p.th) ty = tx = 0;  // rows past the tile: computed, not stored
    oy[i] = y0 + ty;
    ox[i] = x0 + tx;
    pix[i] = ty * p.scp + tx;
  }
}

// The staged positions (row r, v columns from sc), once per block, into
// tab: (offset in the plane or -1 outside it, offset in a staged plane).
__device__ __forceinline__ void table_positions(int2* tab, const Plan& p, int y0, int x0,
                                                int d, int H, int W) {
  const int per_row = p.sc / p.v;
  for (int i = threadIdx.x; i < p.npos; i += kThreads) {
    const int r = i / per_row, sc = i % per_row * p.v;
    const int gy = staged_row(p, y0, d, r), gx = staged_col(p, x0, d, sc);
    // W, gx and the tile are multiples of v: a copy is all in or all out
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    tab[i] = make_int2(in ? gy * W + gx : -1, r * p.scp + sc);
  }
}

// Epilogue: y = acc * scale + bias (and ReLU) in f32, stored straight to
// the NCHW output planes.  acc[t][e] (wgmma's layout): pixel 2t + (e / 2)
// % 2, channel co0 + 8 (e / 4) + 2q + e % 2.
template <int BN, int MT, typename T>
__device__ __forceinline__ void store_tile(const Args<T>& a, const float (&acc)[MT][BN / 2],
                                           int co0, const int (&oy)[2 * MT],
                                           const int (&ox)[2 * MT], const bool (&ok)[2 * MT]) {
  const int q = threadIdx.x % 4;
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
      a.out[((out_b + co) * a.H + oy[i]) * a.W + ox[i]] = from_f32<T>(y);
    }
}

}  // namespace conv
}  // namespace dvd
