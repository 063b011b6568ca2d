// Fused MNet decoder step for Hopper (sm_90a), CUDA C++.
//
// Replaces shadow_removal_istd_tpu/ops/pallas_decoder.py::_kernel (entry
// point fused_decoder_upsample). One launch computes, for up to two input
// parts (y, link) that stand for their channel concatenation:
//
//   out[n, 2i+pr, 2j+pc, c] = eps( sum_parts sum_{di,dj in {0,1}} sum_ci
//       act(x_p[n, r(i+pr+di-1), q(j+pc+dj-1), ci])
//       * w4[di, dj, off_p + ci, (2pr+pc)*Co + c] )
//
// act = LeakyReLU(0.2) rounded to the input type, or the identity;
// eps = acc*scale4 + bias4 on the f32 accumulator (the phase-tiled eval
// BatchNorm affine), or the identity. r/q clamp to the edge (nearest-2x
// upsample + 3x3 reflect conv as a subpixel phase conv) or read zero out of
// range (ConvTranspose(4,2,1) as a phase conv). Tensors are channels-last
// (NHWC memory); the output is written straight into (N, 2H, 2W, Co), so
// the depth-to-space costs nothing and no padded or concatenated copy of
// the input is ever formed.
//
// Design: each phase is an implicit GEMM, M = N*H*W pixels, N = Co,
// K = 4 taps * (Ci0 + Ci1). A block owns a BM x BN output tile of one
// phase; per K step it gathers a BM x BK activation tile through the
// clamped indices (LeakyReLU applied on load, converted to f32) and a
// BK x BN weight tile into shared memory, and each thread accumulates a
// TM x TN tile in f32 registers with FMAs on the CUDA cores.
//
// Bound on the H100: at the MNet shapes (Ci 128..1024, Co 64..512) the
// work is ~30..250 FLOP per byte moved, so the tensor cores' bf16 rate
// would make it memory-bound; this first version runs on the CUDA cores
// (67 TFLOP/s f32 peak) and is bound by operations. Tensor cores (wgmma),
// TMA and a pipelined K loop are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16(v);
  }
};

// LeakyReLU(0.2) in the input type: the product is rounded to T, as
// torch.nn.functional.leaky_relu does for that type.
template <typename T>
__device__ __forceinline__ float act(T v, int leaky) {
  float f = Cvt<T>::to(v);
  if (leaky && f < 0.f) f = Cvt<T>::to(Cvt<T>::from(0.2f * f));
  return f;
}

struct Params {
  const void* x0;
  const void* x1;
  int ci0, ci1;
  const void* w4;
  const float* scale4;
  const float* bias4;
  void* out;
  int n, h, w, co;
  int leaky, zero_pad;
};

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    decoder_upsample_kernel(Params p) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;            // threads along output channels
  constexpr int A_STRIDE = NT / BK;      // row step between a thread's A rows
  constexpr int A_ROWS = BM * BK / NT;   // A rows each thread gathers
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0, "A tile split");
  static_assert(TN % 4 == 0, "B reads are float4");
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const T* w4 = static_cast<const T*>(p.w4);
  T* out = static_cast<T*>(p.out);

  const int phase = blockIdx.z, pr = phase >> 1, pc = phase & 1;
  const int h = p.h, w = p.w, co = p.co;
  const int64_t M = static_cast<int64_t>(p.n) * h * w;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int c0 = blockIdx.y * BN;
  const int ci = p.ci0 + p.ci1;
  const int64_t co4 = 4 * co;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int a_k = tid % BK, a_m = tid / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 4; ++tap) {
    const int di = tap >> 1, dj = tap & 1;
    // source pixel of each of this thread's A rows under this tap, or -1
    int64_t pix[A_ROWS];
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) {
      const int64_t m = m0 + a_m + r * A_STRIDE;
      pix[r] = -1;
      if (m < M) {
        const int j = static_cast<int>(m % w);
        const int64_t t = m / w;
        const int i = static_cast<int>(t % h);
        const int64_t b = t / h;
        int rr = i + pr + di - 1, qq = j + pc + dj - 1;
        const bool inside = rr >= 0 && rr < h && qq >= 0 && qq < w;
        if (inside || !p.zero_pad) {
          rr = min(max(rr, 0), h - 1);
          qq = min(max(qq, 0), w - 1);
          pix[r] = (b * h + rr) * w + qq;
        }
      }
    }
    for (int part = 0; part < 2; ++part) {
      const T* x = part ? x1 : x0;
      const int cp = part ? p.ci1 : p.ci0;
      const int off = part ? p.ci0 : 0;
      for (int k0 = 0; k0 < cp; k0 += BK) {
        const int c = k0 + a_k;
#pragma unroll
        for (int r = 0; r < A_ROWS; ++r) {
          float v = 0.f;
          if (pix[r] >= 0 && c < cp) v = act<T>(x[pix[r] * cp + c], p.leaky);
          As[a_k][a_m + r * A_STRIDE] = v;
        }
        for (int e = tid; e < BK * BN; e += NT) {
          const int nn = e % BN, kk = e / BN;
          const int cc = k0 + kk, oc = c0 + nn;
          float v = 0.f;
          if (cc < cp && oc < co)
            v = Cvt<T>::to(
                w4[(static_cast<int64_t>(tap) * ci + off + cc) * co4 +
                   phase * co + oc]);
          Bs[kk][nn] = v;
        }
        __syncthreads();
        // sum each BK slice on its own before adding it to acc: the f32
        // rounding chain is K/BK + BK long instead of K (K reaches 4096)
        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], bv[TN];
          if constexpr (TM % 4 == 0) {
#pragma unroll
            for (int i = 0; i < TM; i += 4) {
              const float4 v =
                  *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
              a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
          }
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + j]);
            bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              part[i][j] = fmaf(a[i], bv[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
        __syncthreads();
      }
    }
  }

  // epilogue: affine on the f32 accumulator, cast, depth-to-space store
  const int64_t h2 = 2 * h, w2 = 2 * w;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int jj = static_cast<int>(m % w);
    const int64_t t = m / w;
    const int ii = static_cast<int>(t % h);
    const int64_t b = t / h;
    const int64_t o = ((b * h2 + 2 * ii + pr) * w2 + 2 * jj + pc) * co;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int oc = c0 + tx * TN + j;
      if (oc >= co) continue;
      float v = acc[i][j];
      if (p.scale4 != nullptr)
        v = v * p.scale4[phase * co + oc] + p.bias4[phase * co + oc];
      out[o + oc] = Cvt<T>::from(v);
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(p.n) * p.h * p.w;
  if (p.co >= 32) {
    constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
    const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                    (p.co + BN - 1) / BN, 4);
    decoder_upsample_kernel<T, BM, BN, BK, TM, TN>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
  } else {
    // Co below 32 (on the MNet path only at small ngf; Co <= 4, the final
    // layer, runs on decoder_upsample_narrow.cu): one pixel per thread
    constexpr int BM = 128, BN = 4, BK = 16, TM = 1, TN = 4;
    const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                    (p.co + BN - 1) / BN, 4);
    decoder_upsample_kernel<T, BM, BN, BK, TM, TN>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x1 may be null (ci1 = 0); scale4 and
// bias4 are null for the final layer (no BatchNorm). Returns the launch's
// cudaError_t (0 on success). Launches on `stream`, does not synchronise.
extern "C" int srit_decoder_upsample(int dtype, const void* x0,
                                     const void* x1, int ci0, int ci1,
                                     const void* w4, const void* scale4,
                                     const void* bias4, void* out, int n,
                                     int h, int w, int co, int leaky,
                                     int zero_pad, void* stream) {
  Params p{x0, x1, ci0, ci1, w4,
           static_cast<const float*>(scale4),
           static_cast<const float*>(bias4), out, n, h, w, co, leaky,
           zero_pad};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
