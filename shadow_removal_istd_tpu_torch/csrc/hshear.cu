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
// row seen through a zero border of `pad` columns. With transpose_out the
// same values are written as (B, C, out_w, H): the layout the next pass
// of the 3-shear rotation (ops/shear.py::shear_rotate_crop) reads, so no
// transpose copy runs between passes.
//
// Bound on the H100: ~0.4 FLOP per byte, so memory: the input columns
// each row's taps reach, read once, plus the output, written once, over
// 3.35 TB/s. The design keeps many bytes in flight and every access
// coalesced:
//
// - A block owns a tile of TR = 32 rows x TW = 64 output columns of one
//   image, for every channel (the rows share k and f across channels;
//   the tile's k and f are read once into shared memory).
// - Each row's input span, image columns [k - pad + j0, k - pad + j0 +
//   TW], is staged into shared memory from the 16-byte aligned column at
//   or below its start (so a stage row holds up to 3 words of slack
//   before the span): with 16-byte cp.async where the row pitch W0 is a
//   multiple of 4 and img is 16-byte aligned (then each 16-byte piece
//   lies wholly inside or wholly outside [0, W0)), else with 4-byte
//   cp.async. Columns outside [0, W0) are zero-filled (src-size 0): the
//   zero border costs no read and no padded copy of the image.
// - A ring of kStages = 2 channels: channel c + 1's copies are in flight
//   while channel c's outputs are formed and stored. C = 7 (the path's
//   channel count) has an instance with the channel loop unrolled.
// - Outputs read the staged row as aligned float4s (a stage row is 68
//   words, 17 float4s: odd, so 8 lanes on 8 rows hit 8 distinct bank
//   quads) and shift the row's 0..3 words of slack away in registers.
//   Normal layout: a thread forms 4 consecutive columns of one row and
//   stores them as one float4 where out_w is a multiple of 4 and out is
//   16-byte aligned, else as scalars. Transposed layout: lane i of a
//   warp owns row r0 + i and the warp 8 columns, so each store is 32
//   consecutive H values of one output row: a 128-byte coalesced store,
//   with no shared-memory transpose tile.
//
// The lerp is written with __fmul_rn/__fadd_rn so that no FMA
// contraction changes its rounding: the kernel is bit-identical to its
// plain version (ops/shear.py::hshear_plain) in both layouts. The
// Pallas kernel's padded copy, 128-lane windows and H % 8 rule are TPU
// artifacts and are not carried over: any B, C, H, W0, out_w and pad
// work.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TR = 32;               // rows per tile: one per lane
constexpr int TW = 64;               // output columns per tile
constexpr int kWarps = 8;
constexpr int kStages = 2;           // channels in the staging ring
constexpr int kThreads = 32 * kWarps;
constexpr int PITCH = TW + 4;        // staged words per row
constexpr int NQ = PITCH / 4;        // 16-byte pieces per staged row
constexpr int JW = TW / kWarps;      // columns per warp, transposed
constexpr int JQ = JW / 4 + 1;       // float4s a lane reads for them
constexpr int QPR = TW / 4;          // column quads per row, normal
static_assert(NQ % 2 == 1, "stage rows must be an odd number of float4s");

enum Layout { kNormal = 0, kNormalVec = 1, kTransposed = 2 };

struct Args {
  const float* img;
  const int* kint;
  const float* frac;
  float* out;
  int C, H, W0, out_w, pad;
  int row_tiles, col_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; with ok false it reads nothing and
// writes zeros (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x[e] = w[s + e] for s in [0, 3], by selects on static indices
template <int N, int M>
__device__ __forceinline__ void shift_words(const float (&w)[M], int s,
                                            float (&x)[N]) {
  static_assert(N + 3 <= M, "shift reads past the loaded words");
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float lo = (s & 2) ? w[e + 2] : w[e];
    const float hi = (s & 2) ? w[e + 3] : w[e + 1];
    x[e] = (s & 1) ? hi : lo;
  }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f,
                                         float g) {
  return __fadd_rn(__fmul_rn(a, g), __fmul_rn(b, f));
}

template <bool VEC_IN, int LAYOUT, int KC>
__global__ void __launch_bounds__(kThreads) hshear_kernel(Args p) {
  __shared__ __align__(16) float stage[kStages][TR * PITCH];
  __shared__ int s_start[TR];   // image column of stage word 0 (mult. of 4)
  __shared__ int s_off[TR];     // stage word of the row's first tap, 0..3
  __shared__ float s_frac[TR];

  const int C = KC > 0 ? KC : p.C;
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int jt = t % p.col_tiles;
  t /= p.col_tiles;
  const int rt = t % p.row_tiles;
  const int b = t / p.row_tiles;
  const int r0 = rt * TR, j0 = jt * TW;
  const int rows = min(TR, p.H - r0);
  const int cols = min(TW, p.out_w - j0);

  if (tid < TR) {
    int g = 0;
    float f = 0.0f;
    if (tid < rows) {
      const size_t row = static_cast<size_t>(b) * p.H + r0 + tid;
      g = p.kint[row] - p.pad + j0;   // image column of the first tap
      f = p.frac[row];
    }
    s_start[tid] = g & ~3;            // floor to a multiple of 4
    s_off[tid] = g & 3;
    s_frac[tid] = f;
  }
  __syncthreads();

  const size_t plane_in = static_cast<size_t>(p.H) * p.W0;
  const float* src_tile = p.img + static_cast<size_t>(b) * C * plane_in
                          + static_cast<size_t>(r0) * p.W0;

  // stage channel c's span of every row of the tile: words s .. s + cols
  // of each stage row (the taps of its `cols` outputs)
  auto stage_channel = [&](int c, int buf) {
    const float* src = src_tile + static_cast<size_t>(c) * plane_in;
    float* dst = stage[buf];
    if constexpr (VEC_IN) {
      for (int i = tid; i < rows * NQ; i += kThreads) {
        const int rr = i / NQ, q = i - rr * NQ;
        if (4 * q > s_off[rr] + cols) continue;
        const int col = s_start[rr] + 4 * q;
        const bool ok = col >= 0 && col < p.W0;
        cp_async16(smem_addr(dst + rr * PITCH + 4 * q),
                   ok ? src + static_cast<size_t>(rr) * p.W0 + col : src,
                   ok);
      }
    } else {
      for (int i = tid; i < rows * PITCH; i += kThreads) {
        const int rr = i / PITCH, q = i - rr * PITCH;
        if (q < s_off[rr] || q > s_off[rr] + cols) continue;
        const int col = s_start[rr] + q;
        const bool ok = col >= 0 && col < p.W0;
        cp_async4(smem_addr(dst + rr * PITCH + q),
                  ok ? src + static_cast<size_t>(rr) * p.W0 + col : src,
                  ok);
      }
    }
  };

  // form and store channel c's outputs from stage buffer buf
  auto emit_channel = [&](int c, int buf) {
    const size_t oc = static_cast<size_t>(b) * C + c;
    if constexpr (LAYOUT == kTransposed) {
      const int rr = tid & 31, w = tid >> 5;
      if (rr >= rows) return;
      const float4* row4 =
          reinterpret_cast<const float4*>(stage[buf] + rr * PITCH);
      float wd[4 * JQ];
#pragma unroll
      for (int q = 0; q < JQ; ++q) {
        const float4 v = row4[w * (JW / 4) + q];
        wd[4 * q] = v.x;
        wd[4 * q + 1] = v.y;
        wd[4 * q + 2] = v.z;
        wd[4 * q + 3] = v.w;
      }
      float x[JW + 1];
      shift_words(wd, s_off[rr], x);
      const float f = s_frac[rr], g = __fsub_rn(1.0f, f);
      const int j = w * JW;
      float* dst = p.out + (oc * p.out_w + j0 + j) * p.H + r0 + rr;
#pragma unroll
      for (int e = 0; e < JW; ++e)
        if (j + e < cols)
          dst[static_cast<size_t>(e) * p.H] = lerp_rn(x[e], x[e + 1], f, g);
    } else {
      for (int i = tid; i < rows * QPR; i += kThreads) {
        const int rr = i / QPR, tq = i - rr * QPR;
        if (4 * tq >= cols) continue;
        const float4* row4 =
            reinterpret_cast<const float4*>(stage[buf] + rr * PITCH);
        const float4 v0 = row4[tq], v1 = row4[tq + 1];
        const float wd[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        float x[5];
        shift_words(wd, s_off[rr], x);
        const float f = s_frac[rr], g = __fsub_rn(1.0f, f);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = lerp_rn(x[e], x[e + 1], f, g);
        float* dst = p.out + (oc * p.H + r0 + rr) * p.out_w + j0 + 4 * tq;
        if constexpr (LAYOUT == kNormalVec) {
          // out_w % 4 == 0, so a quad is wholly inside or past `cols`
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * tq + e < cols) dst[e] = o[e];
        }
      }
    }
  };

  // ring over channels: channel c's group is the c-th committed (one a
  // step, empty past the last channel), so with kStages - 1 groups in
  // flight channel c has landed
  auto step = [&](int c) {
    const int n = c + kStages - 1;
    if (n < C) stage_channel(n, n % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    emit_channel(c, c % kStages);
    __syncthreads();  // buffer c % kStages is restaged next step
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < C) stage_channel(c, c);
    cp_async_commit();
  }
  if constexpr (KC > 0) {
#pragma unroll
    for (int c = 0; c < KC; ++c) step(c);
  } else {
    for (int c = 0; c < C; ++c) step(c);
  }
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <bool VEC_IN, int LAYOUT>
void run(const Args& a, unsigned blocks, cudaStream_t stream) {
  if (a.C == 7)
    hshear_kernel<VEC_IN, LAYOUT, 7><<<blocks, kThreads, 0, stream>>>(a);
  else
    hshear_kernel<VEC_IN, LAYOUT, 0><<<blocks, kThreads, 0, stream>>>(a);
}

template <bool VEC_IN>
void run_layout(const Args& a, int layout, unsigned blocks,
                cudaStream_t stream) {
  if (layout == kTransposed)
    run<VEC_IN, kTransposed>(a, blocks, stream);
  else if (layout == kNormalVec)
    run<VEC_IN, kNormalVec>(a, blocks, stream);
  else
    run<VEC_IN, kNormal>(a, blocks, stream);
}

}  // namespace

// img (B, C, H, W0) f32, kint/frac (B, H) int32/f32, all contiguous on
// the current device; out (B, C, H, out_w) f32, or (B, C, out_w, H) with
// transpose_out = 1. The instance is picked by shape and alignment:
// 16-byte input copies where W0 % 4 == 0 and img is 16-byte aligned,
// else 4-byte ones; float4 stores in the normal layout where out_w % 4
// == 0 and out is 16-byte aligned, else scalar ones. Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t
// (0 on success; cudaErrorInvalidValue for what it does not take).
extern "C" int srit_hshear(const float* img, const int* kint,
                           const float* frac, float* out, int B, int C,
                           int H, int W0, int out_w, int pad,
                           int transpose_out, void* stream) {
  if (B < 0 || C < 1 || H < 0 || W0 < 1 || out_w < 1 || pad < 0 ||
      (transpose_out != 0 && transpose_out != 1) ||
      static_cast<long long>(W0) + out_w + 2LL * pad + TW >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_tiles = (H + TR - 1) / TR;
  const long long col_tiles = (out_w + TW - 1) / TW;
  const long long blocks = static_cast<long long>(B) * row_tiles * col_tiles;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{img, kint, frac, out, C, H, W0, out_w, pad,
               static_cast<int>(row_tiles), static_cast<int>(col_tiles)};
  const int layout = transpose_out ? kTransposed
                     : (out_w % 4 == 0 && aligned16(out)) ? kNormalVec
                                                          : kNormal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W0 % 4 == 0 && aligned16(img))
    run_layout<true>(a, layout, static_cast<unsigned>(blocks), s);
  else
    run_layout<false>(a, layout, static_cast<unsigned>(blocks), s);
  return static_cast<int>(cudaGetLastError());
}
