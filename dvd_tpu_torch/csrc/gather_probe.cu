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
// over: one thread per index, 64-bit addressing, any (H, W) and (M, N).
// Neighbouring threads read neighbouring indices and write neighbouring
// outputs, so those accesses coalesce; for near-identity indices the pixel
// loads coalesce too.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) gather2d_kernel(
    const float* __restrict__ img, const int* __restrict__ y,
    const int* __restrict__ x, float* __restrict__ out, int H, int W,
    long long MN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  const int yi = y[i];
  const int xi = x[i];
  out[i] = (yi >= 0 && yi < H && xi >= 0 && xi < W)
               ? img[(long long)yi * W + xi]
               : 0.f;
}

}  // namespace

extern "C" int dvd_gather2d(const void* img, const void* y, const void* x,
                            void* out, int H, int W, long long MN,
                            void* stream) {
  if (H <= 0 || W <= 0 || MN <= 0 || (MN + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  gather2d_kernel<<<dvd::ceil_div(MN, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)y, (const int*)x, (float*)out, H, W, MN);
  return (int)cudaGetLastError();
}
