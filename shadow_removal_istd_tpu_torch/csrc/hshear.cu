// Per-row fractional horizontal shear for Hopper (sm_90a), CUDA C++.
//
// Replaces shadow_removal_istd_tpu/ops/pallas_shear.py::_shear_kernel
// (entry point hshear). For image b, channel c and row r, with the row's
// integer start k = kint[b, r] and fraction f = frac[b, r] (formed by the
// wrapper, ops/shear.py, exactly as the JAX entry point forms them):
//
//   out[b, c, r, j] = P(k + j) * (1 - f) + P(k + j + 1) * f
//
// where P(p) = img[b, c, r, p - pad] for 0 <= p - pad < W0, else 0: the
// row seen through a zero border of `pad` columns. Three passes of it
// (with transposes between) rotate a training batch in ops/augment.py.
//
// Design: one block per (b, r) row; threads walk the output columns and
// loop over the C channels, which share k and f. The zero border is a
// masked load, so no padded copy of the image is formed (the Pallas
// version pads once per pass and reads 128-lane aligned windows rotated
// into place; both are TPU artifacts and are not carried over, nor is
// its H % 8 == 0 rule: any H works). Neighbouring threads read
// neighbouring columns, so loads and stores are coalesced; the second
// tap re-reads the first tap's neighbour from L1.
//
// Bound on the H100: ~0.5 FLOP per byte, so it is bound by memory: the
// input columns each row needs, read once, plus the output, written
// once, over 3.35 TB/s. The lerp is written with __fmul_rn/__fadd_rn so
// that no FMA contraction changes its rounding: the kernel is
// bit-identical to its plain version (ops/shear.py::hshear_plain).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hshear_kernel(const float* __restrict__ img, const int* __restrict__ kint,
              const float* __restrict__ frac, float* __restrict__ out,
              int C, int H, int W0, int out_w, int pad) {
  const int row = blockIdx.x;  // b * H + r
  const int b = row / H;
  const int r = row - b * H;
  const int k = kint[row];
  const float f = frac[row];
  const float g = __fsub_rn(1.0f, f);
  const size_t plane_in = static_cast<size_t>(H) * W0;
  const size_t plane_out = static_cast<size_t>(H) * out_w;
  const float* src = img + static_cast<size_t>(b) * C * plane_in
                     + static_cast<size_t>(r) * W0;
  float* dst = out + static_cast<size_t>(b) * C * plane_out
               + static_cast<size_t>(r) * out_w;
  for (int j = threadIdx.x; j < out_w; j += kThreads) {
    const int p0 = k + j - pad;  // image column of the first tap
    const bool in0 = p0 >= 0 && p0 < W0;
    const bool in1 = p0 + 1 >= 0 && p0 + 1 < W0;
    for (int c = 0; c < C; ++c) {
      const float* s = src + c * plane_in;
      const float a = in0 ? __ldg(s + p0) : 0.0f;
      const float n = in1 ? __ldg(s + p0 + 1) : 0.0f;
      dst[c * plane_out + j] = __fadd_rn(__fmul_rn(a, g), __fmul_rn(n, f));
    }
  }
}

}  // namespace

// img (B, C, H, W0) f32, kint/frac (B, H) int32/f32, out (B, C, H, out_w)
// f32, all contiguous on the current device; launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int srit_hshear(const float* img, const int* kint,
                           const float* frac, float* out, int B, int C,
                           int H, int W0, int out_w, int pad, void* stream) {
  if (B < 0 || C < 1 || H < 0 || W0 < 1 || out_w < 1 || pad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(B) * H;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  hshear_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      img, kint, frac, out, C, H, W0, out_w, pad);
  return static_cast<int>(cudaGetLastError());
}
