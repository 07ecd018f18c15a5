// Dense-descriptor coarse-to-fine registration flow (C++, OpenMP).
//
// Role in the framework: native replacement for the external SIFTflow
// MATLAB/mex toolbox the reference's offline metrics require
// (reference matlab_code/run_benchmark.m:20-44 — evalUnwarp/
// evalAlignedUnwarp register the rectified image against the GT scan and
// reduce the dense flow to the LD / AD numbers).  This is the only
// native-code dependency in the reference's metric stack; here it is a
// self-contained engine:
//
//   1. dense HOG-like descriptor per pixel (8 orientation bins, 2x2 cell
//      grid, soft-binned, L1-block-normalized — a light dense SIFT),
//   2. Gaussian pyramid, coarse-to-fine,
//   3. per-level discrete window search minimizing
//        E(f) = ||d1(p) - d2(p + f)||_1 + alpha * |f - f_prop|_1
//      (data term + proximal regularization to the propagated flow),
//   4. 3x3 component-wise median filtering per level (smoothness).
//
// Exported C ABI (ctypes): see sift_flow() at the bottom.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kBins = 8;        // orientation bins
constexpr int kCell = 2;        // cell grid (kCell x kCell)
constexpr int kDesc = kBins * kCell * kCell;  // 32 floats / pixel

struct Image {
  int h = 0, w = 0, c = 1;
  std::vector<float> data;
  Image() = default;
  Image(int h_, int w_, int c_) : h(h_), w(w_), c(c_), data((size_t)h_ * w_ * c_, 0.f) {}
  float* row(int y) { return data.data() + (size_t)y * w * c; }
  const float* row(int y) const { return data.data() + (size_t)y * w * c; }
  float* at(int y, int x) { return data.data() + ((size_t)y * w + x) * c; }
  const float* at(int y, int x) const { return data.data() + ((size_t)y * w + x) * c; }
};

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// 5-tap [1 4 6 4 1]/16 separable blur + 2x decimation.
Image downsample2(const Image& src) {
  const int h = src.h, w = src.w, c = src.c;
  Image tmp(h, w, c);
  static const float k[5] = {1.f / 16, 4.f / 16, 6.f / 16, 4.f / 16, 1.f / 16};
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int i = -2; i <= 2; ++i)
          acc += k[i + 2] * src.at(y, clampi(x + i, 0, w - 1))[ch];
        tmp.at(y, x)[ch] = acc;
      }
  Image blur(h, w, c);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int i = -2; i <= 2; ++i)
          acc += k[i + 2] * tmp.at(clampi(y + i, 0, h - 1), x)[ch];
        blur.at(y, x)[ch] = acc;
      }
  Image dst((h + 1) / 2, (w + 1) / 2, c);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dst.h; ++y)
    for (int x = 0; x < dst.w; ++x)
      for (int ch = 0; ch < c; ++ch)
        dst.at(y, x)[ch] = blur.at(std::min(2 * y, h - 1), std::min(2 * x, w - 1))[ch];
  return dst;
}

// Dense 32-d descriptor: soft-binned gradient orientation histograms over
// a (2*kRad+1)^2 neighborhood split into kCell x kCell cells.
Image dense_descriptor(const Image& gray) {
  const int h = gray.h, w = gray.w;
  const int rad = 3;  // neighborhood radius per cell axis
  Image grad(h, w, kBins);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float gx = gray.at(y, clampi(x + 1, 0, w - 1))[0] -
                 gray.at(y, clampi(x - 1, 0, w - 1))[0];
      float gy = gray.at(clampi(y + 1, 0, h - 1), x)[0] -
                 gray.at(clampi(y - 1, 0, h - 1), x)[0];
      float mag = std::sqrt(gx * gx + gy * gy);
      float ang = std::atan2(gy, gx);                 // [-pi, pi]
      float bin = (ang + (float)M_PI) / (2.f * (float)M_PI) * kBins;
      int b0 = (int)bin % kBins;
      int b1 = (b0 + 1) % kBins;
      float f = bin - std::floor(bin);
      float* g = grad.at(y, x);
      g[b0] += mag * (1.f - f);
      g[b1] += mag * f;
    }

  Image desc(h, w, kDesc);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float* d = desc.at(y, x);
      int idx = 0;
      for (int cy = 0; cy < kCell; ++cy)
        for (int cx = 0; cx < kCell; ++cx) {
          // cell centers at offsets {-rad, +rad} around the pixel
          int oy = (cy == 0 ? -rad : rad), ox = (cx == 0 ? -rad : rad);
          for (int b = 0; b < kBins; ++b) {
            float acc = 0.f;
            for (int dy = -rad / 2; dy <= rad / 2; ++dy)
              for (int dx = -rad / 2; dx <= rad / 2; ++dx)
                acc += grad.at(clampi(y + oy + dy, 0, h - 1),
                               clampi(x + ox + dx, 0, w - 1))[b];
            d[idx++] = acc;
          }
        }
      // L1 block normalization (+eps), like SIFT's clipped renorm
      float s = 1e-6f;
      for (int i = 0; i < kDesc; ++i) s += d[i];
      float inv = 1.f / s;
      for (int i = 0; i < kDesc; ++i) d[i] *= inv;
    }
  return desc;
}

inline float desc_dist(const float* a, const float* b) {
  float s = 0.f;
  for (int i = 0; i < kDesc; ++i) s += std::fabs(a[i] - b[i]);
  return s;
}

// 1-D parabolic (equiangular-fit) sub-pixel offset from three costs at
// t = -1, 0, +1; c0 is the (local-minimum) center cost.
inline float subpixel_offset(float cm, float c0, float cp) {
  float denom = cm - 2.f * c0 + cp;
  if (denom <= 1e-12f) return 0.f;           // flat / not a minimum
  // An (essentially) exact match: the L1 descriptor cost is V-shaped with
  // its true minimum exactly at the integer winner, so neighbor asymmetry
  // carries no sub-pixel information — a parabola fit through c0 ~ 0 would
  // fabricate an offset of up to +-0.5 px (the identity-image bias fixed in
  // engine version 3).  Descriptors are L1-normalized, so costs are
  // comparable across pixels and a relative guard is safe.
  if (c0 <= 1e-3f * 0.5f * (cm + cp)) return 0.f;
  float off = 0.5f * (cm - cp) / denom;
  return off < -0.5f ? -0.5f : (off > 0.5f ? 0.5f : off);
}

// Discrete window search around the propagated flow, with parabolic
// sub-pixel refinement of the winner.  Without refinement the flow is
// integer-quantized at every level, which inflates LD on small warps
// (mean |flow| of a smooth field plus +-0.5 px noise is biased up) and
// flattens extremes on large ones — measured as the 3-4% rel-err tail in
// docs/registration_calibration.json before this pass existed.
void search_level(const Image& d1, const Image& d2, Image& flow,
                  int radius, float alpha) {
  const int h = d1.h, w = d1.w;
  Image out(h, w, 2);
#pragma omp parallel for schedule(dynamic, 8)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const float* ref = d1.at(y, x);
      float fx = flow.at(y, x)[0], fy = flow.at(y, x)[1];
      int cx = (int)std::lround(fx), cy = (int)std::lround(fy);
      float best = 1e30f;
      int bu = cx, bv = cy;
      for (int v = cy - radius; v <= cy + radius; ++v) {
        int yy = y + v;
        if (yy < 0 || yy >= h) continue;
        for (int u = cx - radius; u <= cx + radius; ++u) {
          int xx = x + u;
          if (xx < 0 || xx >= w) continue;
          float cost = desc_dist(ref, d2.at(yy, xx)) +
                       alpha * (std::fabs((float)u - fx) + std::fabs((float)v - fy));
          if (cost < best) { best = cost; bu = u; bv = v; }
        }
      }
      // sub-pixel: data-term-only parabola through the winner's in-bounds
      // axis neighbors (the prox term's |.| kink would skew the fit)
      float sub_u = 0.f, sub_v = 0.f;
      int yy = y + bv, xx = x + bu;
      if (yy >= 0 && yy < h && xx - 1 >= 0 && xx + 1 < w) {
        float c0 = desc_dist(ref, d2.at(yy, xx));
        sub_u = subpixel_offset(desc_dist(ref, d2.at(yy, xx - 1)), c0,
                                desc_dist(ref, d2.at(yy, xx + 1)));
      }
      if (xx >= 0 && xx < w && yy - 1 >= 0 && yy + 1 < h) {
        float c0 = desc_dist(ref, d2.at(yy, xx));
        sub_v = subpixel_offset(desc_dist(ref, d2.at(yy - 1, xx)), c0,
                                desc_dist(ref, d2.at(yy + 1, xx)));
      }
      out.at(y, x)[0] = (float)bu + sub_u;
      out.at(y, x)[1] = (float)bv + sub_v;
    }
  flow = std::move(out);
}

// 3x3 component-wise median (smoothness surrogate).
void median3(Image& flow) {
  const int h = flow.h, w = flow.w;
  Image out(h, w, 2);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < 2; ++ch) {
        float v[9];
        int n = 0;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx)
            v[n++] = flow.at(clampi(y + dy, 0, h - 1), clampi(x + dx, 0, w - 1))[ch];
        std::nth_element(v, v + 4, v + 9);
        out.at(y, x)[ch] = v[4];
      }
  flow = std::move(out);
}

// Texture-weighted normalized-convolution smoothing: propagates flow from
// textured pixels (where the data term is informative) into blank regions
// (where it is flat and the search returns stale values).  This plays the
// role of SIFTflow's pairwise smoothness term.  w = local gradient energy.
void propagate_textured(Image& flow, const Image& gray, int radius, int iters) {
  const int h = flow.h, w = flow.w;
  Image wgt(h, w, 1);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float gx = gray.at(y, clampi(x + 1, 0, w - 1))[0] -
                 gray.at(y, clampi(x - 1, 0, w - 1))[0];
      float gy = gray.at(clampi(y + 1, 0, h - 1), x)[0] -
                 gray.at(clampi(y - 1, 0, h - 1), x)[0];
      wgt.at(y, x)[0] = std::sqrt(gx * gx + gy * gy) + 1e-3f;
    }
  for (int it = 0; it < iters; ++it) {
    // separable box filter of (w*fx, w*fy, w)
    Image acc(h, w, 3), tmp(h, w, 3);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        float s0 = 0, s1 = 0, s2 = 0;
        for (int d = -radius; d <= radius; ++d) {
          int xx = clampi(x + d, 0, w - 1);
          float ww = wgt.at(y, xx)[0];
          s0 += ww * flow.at(y, xx)[0];
          s1 += ww * flow.at(y, xx)[1];
          s2 += ww;
        }
        tmp.at(y, x)[0] = s0; tmp.at(y, x)[1] = s1; tmp.at(y, x)[2] = s2;
      }
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        float s0 = 0, s1 = 0, s2 = 0;
        for (int d = -radius; d <= radius; ++d) {
          int yy = clampi(y + d, 0, h - 1);
          s0 += tmp.at(yy, x)[0];
          s1 += tmp.at(yy, x)[1];
          s2 += tmp.at(yy, x)[2];
        }
        acc.at(y, x)[0] = s0 / s2;
        acc.at(y, x)[1] = s1 / s2;
      }
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        // blend toward the propagated estimate; textured pixels (high
        // weight relative to the neighborhood mean) keep their own value
        float own = wgt.at(y, x)[0];
        float lam = own / (own + 2.0f);      // textured -> keep own value
        flow.at(y, x)[0] = lam * flow.at(y, x)[0] + (1 - lam) * acc.at(y, x)[0];
        flow.at(y, x)[1] = lam * flow.at(y, x)[1] + (1 - lam) * acc.at(y, x)[1];
      }
  }
}

Image upsample_flow2(const Image& flow, int nh, int nw) {
  Image out(nh, nw, 2);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < nh; ++y)
    for (int x = 0; x < nw; ++x) {
      float sy = (float)y * flow.h / nh, sx = (float)x * flow.w / nw;
      int y0 = clampi((int)sy, 0, flow.h - 1), x0 = clampi((int)sx, 0, flow.w - 1);
      int y1 = clampi(y0 + 1, 0, flow.h - 1), x1 = clampi(x0 + 1, 0, flow.w - 1);
      float fy = sy - y0, fx = sx - x0;
      for (int ch = 0; ch < 2; ++ch) {
        float v = (1 - fy) * ((1 - fx) * flow.at(y0, x0)[ch] + fx * flow.at(y0, x1)[ch]) +
                  fy * ((1 - fx) * flow.at(y1, x0)[ch] + fx * flow.at(y1, x1)[ch]);
        out.at(y, x)[ch] = v * 2.f;  // coordinates double per level
      }
    }
  return out;
}

}  // namespace

extern "C" {

// im1, im2: (h, w) float32 grayscale in [0, 255].
// flow_out: (h, w, 2) float32, x-first — maps im1 pixel -> im2 position.
// coarse_radius: search window at the coarsest level (e.g. 8).
// alpha: small-displacement regularization weight (e.g. 0.02).
// n_threads: OpenMP thread cap (<=0 -> library default).
void sift_flow(const float* im1, const float* im2, int h, int w,
               float* flow_out, int coarse_radius, float alpha,
               int n_threads) {
#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#endif
  Image a(h, w, 1), b(h, w, 1);
  std::memcpy(a.data.data(), im1, sizeof(float) * (size_t)h * w);
  std::memcpy(b.data.data(), im2, sizeof(float) * (size_t)h * w);

  // pyramid down to ~24px on the short side
  std::vector<Image> pa{a}, pb{b};
  while (std::min(pa.back().h, pa.back().w) > 48) {
    pa.push_back(downsample2(pa.back()));
    pb.push_back(downsample2(pb.back()));
  }

  Image flow(pa.back().h, pa.back().w, 2);  // zeros
  for (int lvl = (int)pa.size() - 1; lvl >= 0; --lvl) {
    Image d1 = dense_descriptor(pa[lvl]);
    Image d2 = dense_descriptor(pb[lvl]);
    int radius = (lvl == (int)pa.size() - 1) ? coarse_radius : 2;
    search_level(d1, d2, flow, radius, alpha);
    median3(flow);
    propagate_textured(flow, pa[lvl], /*radius=*/6, /*iters=*/2);
    if (lvl > 0) flow = upsample_flow2(flow, pa[lvl - 1].h, pa[lvl - 1].w);
  }
  std::memcpy(flow_out, flow.data.data(), sizeof(float) * (size_t)h * w * 2);
}

// 2: sub-pixel parabolic refinement; 3: exact-match guard (zero offset when
// the center cost is ~0 — kills the identity-image flow bias).
int siftflow_version() { return 3; }

}  // extern "C"
