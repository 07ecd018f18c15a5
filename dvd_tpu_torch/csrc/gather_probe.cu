// K5: exact integer 2-D gather, out[i, j] = img[y[i, j], x[i, j]].
//
// Replaces the TPU kernel tools/pallas_gather_probe.py:72 (the inline
// `kernel`, :32-64), a probe of the primitives the Pallas unwarp needed.
// Contract: an image (H, W) float32 and index planes y, x (M, N) int32 ->
// (M, N) float32.  An index outside [0, H) x [0, W) yields 0.0 (the TPU
// probe never gives one; the plain twin ops/kernels/gather2d.py:
// gather2d_ref states the same convention).  The result equals the twin
// bit for bit: a gather does no arithmetic.
//
// What bounds it on the H100: bytes.  Per output element it reads 8 bytes
// of indices and one 4-byte pixel and writes 4 bytes; there is no
// floating-point work.  At the unwarp-scale case, a (2048, 2048) image and
// (2048, 2048) near-identity indices, that is ~67 MB, ~20 us at 3.35 TB/s;
// the probe's own case (64 x 256 image, 8 x 128 indices, ~78 KB) is pure
// launch latency.
//
// Design: the TPU kernel strip-mines (8, 128) blocks of the image between
// bounds from min/max reductions of the indices and gathers lanes with
// take_along_axis through selects, because a TPU vector unit has no
// gather.  A GPU thread loads from any address, so none of that carries
// over; what is left is to move the index and output bytes at the memory's
// rate and to keep the image in L2:
// - four outputs a thread: one 16-byte load of y, one of x and one 16-byte
//   store, so a warp moves 512 bytes per instruction; a scalar path takes
//   the last MN % 4 elements, and all of them where y, x or out is not
//   16-byte aligned (an offset view);
// - cache hints: the indices are read and the output written once, as
//   streaming accesses (ld.global.cs / st.global.cs), so they do not evict
//   the image from the 50 MB L2 (a 2048^2 f32 image is 16 MB); the image
//   is read through the read-only path (ld.global.nc);
// - a grid-stride loop over a grid of a whole number of waves: 8 blocks of
//   256 threads per SM (the SM's 2048 threads), times the SM count, or
//   fewer blocks where the work is smaller.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads: a full SM

__device__ __forceinline__ float pick(const float* __restrict__ img, int yi, int xi,
                                      int H, int W) {
  // one unsigned compare per axis also rejects negative indices
  return ((unsigned)yi < (unsigned)H && (unsigned)xi < (unsigned)W)
             ? __ldg(img + (long long)yi * W + xi)
             : 0.f;
}

__global__ void __launch_bounds__(kThreads) gather2d_kernel(
    const float* __restrict__ img, const int* __restrict__ y,
    const int* __restrict__ x, float* __restrict__ out, int H, int W,
    long long MN, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;  // elements the vector loop covers
  if (vec) {
    const long long n4 = MN / 4;
    const int4* y4 = reinterpret_cast<const int4*>(y);
    const int4* x4 = reinterpret_cast<const int4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = t; i < n4; i += stride) {
      const int4 yi = __ldcs(y4 + i);
      const int4 xi = __ldcs(x4 + i);
      __stcs(o4 + i, make_float4(pick(img, yi.x, xi.x, H, W), pick(img, yi.y, xi.y, H, W),
                                 pick(img, yi.z, xi.z, H, W), pick(img, yi.w, xi.w, H, W)));
    }
    done = 4 * n4;
  }
  for (long long i = done + t; i < MN; i += stride)
    __stcs(out + i, pick(img, __ldcs(y + i), __ldcs(x + i), H, W));
}

// The current device's SM count, queried once.  A failed query is
// returned, and cleared from the runtime's last error so that no later
// launch is blamed for it.
cudaError_t sm_count(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    cached = count;
  }
  *n = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" int dvd_gather2d(const void* img, const void* y, const void* x,
                            void* out, int H, int W, long long MN,
                            void* stream) {
  if (H <= 0 || W <= 0 || MN <= 0) return (int)cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long items = vec ? MN / 4 + MN % 4 : MN;  // a thread's loop steps, summed
  const long long want = (items + kThreads - 1) / kThreads;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)kBlocksPerSm * sms;
  const int blocks = (int)(want < cap ? want : cap);
  gather2d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)y, (const int*)x, (float*)out, H, W, MN, vec);
  return (int)cudaGetLastError();
}
