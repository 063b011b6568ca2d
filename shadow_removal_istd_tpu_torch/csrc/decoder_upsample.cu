// Fused MNet decoder step for Hopper (sm_90a) on the CUDA cores, CUDA C++.
//
// Replaces shadow_removal_istd_tpu/ops/pallas_decoder.py::_kernel (:61,
// entry point fused_decoder_upsample) for what the tensor-core and narrow
// kernels do not take: f32 steps, and ragged or misaligned ones with
// Co >= 5. One launch computes, for up to two input parts (y, link) that
// stand for their channel concatenation:
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
// Bound on the H100: operations. Each phase is an implicit GEMM, M = N*H*W
// pixels, N = Co, K = 4 taps * (Ci0 + Ci1); at the MNet shapes (K 512 ..
// 4096, Co 64 .. 512) a step does 100-250 FLOP per byte it must move, and
// the f32 FMA rate (67 TFLOP/s) is the ceiling: 0.6-2.4 ms a step at
// 480x640 batch 16, against ~0.2 ms for its bytes.
//
// Design: a register-blocked SGEMM fed by a gather.
// - A block owns a BM x BN output tile of one phase (128 x 128 for wide Co,
//   128 x 64 for Co 64 and other mid widths, 128 x 16 below Co 32). Each
//   thread holds an 8 x 8 accumulator tile (4 x 4 below Co 32) as 4 x 4
//   sub-tiles spaced half a block tile apart, so a warp's float4 reads of
//   the operands in shared memory are contiguous: per K step a thread
//   reads 4 float4s and runs 64 FMAs.
// - K runs over (tap, part, 16-channel chunk; 4-8 on scalar loads). The
//   next chunk's global loads are issued into registers before the
//   current chunk's FMAs, then stored into the other of two shared-memory
//   buffers: one barrier per chunk. On that store A gets its LeakyReLU in
//   the input type, is widened to f32 and is transposed to k-major (a
//   staging pass cp.async would need on top).
// - Loads are 16 bytes along channels (4 f32 / 8 bf16) when every channel
//   count is a multiple of that and every tensor is 16-byte aligned, else
//   masked scalars: launch() picks the instance from the shape. Zero
//   padding, ragged M, Ci and Co are masked.
// - A thread decodes its A rows' (b, i, j) once; a tap only shifts them.
// - Accuracy: each 64-deep run of K (a 64-channel slice of one tap and
//   part) is summed in its own registers and then added to the
//   accumulator, so the f32 rounding chain at K = 4096 is 64 + 64 long,
//   not 4096. All FMAs round to nearest.

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

// LeakyReLU(0.2) in the input type on a value widened to f32: the product
// is rounded to T, as torch.nn.functional.leaky_relu does for that type.
template <typename T>
__device__ __forceinline__ float act(float f, int leaky) {
  if (leaky && f < 0.f) f = Cvt<T>::to(Cvt<T>::from(0.2f * f));
  return f;
}

// Element e of a 16-byte vector of T, widened to f32.
__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e);

template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  return __uint_as_float(word(u, e));
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  const unsigned w = word(u, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Four consecutive outputs in one store (16 bytes in f32, 8 in bf16).
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  uint2 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(dst) = u;
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

constexpr int SLICE = 64;  // K run summed apart before it joins acc

// BM x BN output tile of one phase; each thread owns NHM x NHN sub-tiles
// of 4 x 4, spaced BM/NHM rows and BN/NHN channels apart. VEC elements per
// global load: 16 bytes, or 1 (masked scalars).
template <typename T, int BM, int BN, int NHM, int NHN, int VEC>
__global__ void __launch_bounds__((BM / (4 * NHM)) * (BN / (4 * NHN)))
    decoder_upsample_kernel(Params p) {
  constexpr int TY = BM / (4 * NHM), TX = BN / (4 * NHN), NT = TY * TX;
  constexpr int TM = 4 * NHM, TN = 4 * NHN;
  constexpr bool VECTOR = VEC > 1;
  // K chunk (channels of one tap and part): 16 on 16-byte loads; on
  // scalar ones as deep as the registers allow without spilling: 4 A
  // loads a thread beside an 8x8 tile's 128 sums, 8 beside a 4x4 one's
  constexpr int BK = VECTOR ? 16 : TM * TN > 16 ? 4 * NT / BM : 8;
  constexpr int KV = BK / VEC;                     // loads per A row
  constexpr int A_N = BM * KV, A_PER = (A_N + NT - 1) / NT;
  constexpr int BNV = BN / VEC;                    // loads per B row
  constexpr int B_N = BK * BNV, B_PER = (B_N + NT - 1) / NT;
  constexpr int WX = TX < 8 ? TX : 8, WY = 32 / WX;  // a warp's threads
  constexpr int AS = BM + 4;  // As row stride: spreads the transposed
                              // stores over the banks
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte loads");
  static_assert(NT % KV == 0 && NT % 32 == 0 && TY % WY == 0, "layout");
  static_assert(SLICE % BK == 0, "slices are whole chunks");
  __shared__ __align__(16) float As[2][BK][AS];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const T* w4 = static_cast<const T*>(p.w4);
  T* out = static_cast<T*>(p.out);

  const int phase = blockIdx.z, pr = phase >> 1, pc = phase & 1;
  const int h = p.h, w = p.w, co = p.co, ci = p.ci0 + p.ci1;
  const int M = p.n * h * w;  // launch() refuses M >= 2^31
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int64_t co4 = 4 * static_cast<int64_t>(co);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp / (TX / WX)) * WY + lane / WX;
  const int tx = (warp % (TX / WX)) * WX + lane % WX;

  // this thread's A loads: rows a_m + r * (NT / KV), channels a_k..+VEC;
  // each row's pixel decoded once: -1 past M, else (b*h*w, i, j)
  const int a_k = (tid % KV) * VEC, a_m = tid / KV;
  int rb[A_PER], ri[A_PER], rj[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const int m = m0 + a_m + r * (NT / KV);
    rb[r] = -1;
    ri[r] = rj[r] = 0;
    if (tid + r * NT < A_N && m < M) {
      rj[r] = m % w;
      ri[r] = (m / w) % h;
      rb[r] = m - ri[r] * w - rj[r];
    }
  }
  // this thread's B loads: row b_k[r] of the chunk, channels b_n[r]..+VEC
  int b_k[B_PER], b_n[B_PER];
  int64_t b_off[B_PER];
#pragma unroll
  for (int r = 0; r < B_PER; ++r) {
    const int e = tid + r * NT;
    b_k[r] = e < B_N ? e / BNV : BK;  // BK: no load
    b_n[r] = c0 + (e % BNV) * VEC;
    b_off[r] = b_k[r] * co4 + b_n[r];
  }

  // the chunk being loaded: tap, part, its channels, first channel
  int tap = 0, part = 0, cp = p.ci0, k0 = 0;
  const T* src[A_PER];  // each A row's pixel under this tap and part
  const T* wk;          // the chunk's first weight row, this phase
  auto set_rows = [&]() {
    const int di = tap >> 1, dj = tap & 1;
    const T* x = part ? x1 : x0;
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      int rr = ri[r] + pr + di - 1, qq = rj[r] + pc + dj - 1;
      const bool inside = rr >= 0 && rr < h && qq >= 0 && qq < w;
      src[r] = nullptr;
      if (rb[r] >= 0 && (inside || !p.zero_pad)) {
        rr = min(max(rr, 0), h - 1);
        qq = min(max(qq, 0), w - 1);
        src[r] = x + static_cast<int64_t>(rb[r] + rr * w + qq) * cp + a_k;
      }
    }
    wk = w4 + (static_cast<int64_t>(tap) * ci + (part ? p.ci0 : 0)) * co4 +
         phase * co;
  };

  // registers that carry one chunk from global to shared memory
  uint4 va[VECTOR ? A_PER : 1], vb[VECTOR ? B_PER : 1];
  float sa[VECTOR ? 1 : A_PER], sb[VECTOR ? 1 : B_PER];
  auto load = [&]() {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const bool ok = src[r] != nullptr && k0 + a_k < cp;
      if constexpr (VECTOR) {
        va[r] = ok ? __ldg(reinterpret_cast<const uint4*>(src[r] + k0))
                   : make_uint4(0, 0, 0, 0);
      } else {
        sa[r] = ok ? Cvt<T>::to(src[r][k0]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const bool ok = b_k[r] < BK && k0 + b_k[r] < cp && b_n[r] < co;
      const T* q = wk + b_off[r];
      if constexpr (VECTOR) {
        vb[r] = ok ? __ldg(reinterpret_cast<const uint4*>(q))
                   : make_uint4(0, 0, 0, 0);
      } else {
        sb[r] = ok ? Cvt<T>::to(*q) : 0.f;
      }
    }
  };
  // LeakyReLU and the transpose to k-major on the way into shared memory
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      if (A_N % NT != 0 && tid + r * NT >= A_N) continue;
      const int m = a_m + r * (NT / KV);
      if constexpr (VECTOR) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          As[buf][a_k + e][m] = act<T>(elem<T>(va[r], e), p.leaky);
      } else {
        As[buf][a_k][m] = act<T>(sa[r], p.leaky);
      }
    }
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      if (B_N % NT != 0 && b_k[r] >= BK) continue;
      float* d = &Bs[buf][b_k[r]][b_n[r] - c0];
      if constexpr (VECTOR) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(d + e) =
              make_float4(elem<T>(vb[r], e), elem<T>(vb[r], e + 1),
                          elem<T>(vb[r], e + 2), elem<T>(vb[r], e + 3));
      } else {
        *d = sb[r];
      }
    }
  };
  // whether the chunk being loaded ends its K slice
  auto ends_slice = [&]() {
    return (k0 + BK) % SLICE == 0 || k0 + BK >= cp;
  };
  auto advance = [&]() {
    k0 += BK;
    wk += BK * co4;
    if (k0 >= cp) {
      k0 = 0;
      if (part == 0 && p.ci1 > 0) {
        part = 1;
      } else {
        part = 0;
        ++tap;
      }
      cp = part ? p.ci1 : p.ci0;
      set_rows();
    }
  };

  float acc[TM][TN], sum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = sum[i][j] = 0.f;

  const int chunks =
      4 * ((p.ci0 + BK - 1) / BK + (p.ci1 + BK - 1) / BK);
  set_rows();
  load();
  bool flush = ends_slice();
  store(0);
  __syncthreads();
  int buf = 0;
  for (int t = 0; t < chunks; ++t) {
    const bool last_of_slice = flush, more = t + 1 < chunks;
    if (more) {  // next chunk's loads in flight during this chunk's FMAs
      advance();
      load();
      flush = ends_slice();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int hm = 0; hm < NHM; ++hm) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[buf][kk][hm * (BM / NHM) + ty * 4]);
        a[4 * hm] = v.x; a[4 * hm + 1] = v.y;
        a[4 * hm + 2] = v.z; a[4 * hm + 3] = v.w;
      }
#pragma unroll
      for (int hn = 0; hn < NHN; ++hn) {
        const float4 v = *reinterpret_cast<const float4*>(
            &Bs[buf][kk][hn * (BN / NHN) + tx * 4]);
        b[4 * hn] = v.x; b[4 * hn + 1] = v.y;
        b[4 * hn + 2] = v.z; b[4 * hn + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sum[i][j] = fmaf(a[i], b[j], sum[i][j]);
    }
    if (last_of_slice) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += sum[i][j];
          sum[i][j] = 0.f;
        }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // epilogue: affine on the f32 accumulator, cast, depth-to-space store
  const int h2 = 2 * h, w2 = 2 * w;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / NHM) + ty * 4 + i % 4;
    if (m >= M) continue;
    const int jj = m % w, t = m / w, ii = t % h, b = t / h;
    T* orow = out + (static_cast<int64_t>(b * h2 + 2 * ii + pr) * w2 +
                     2 * jj + pc) * co;
#pragma unroll
    for (int hn = 0; hn < NHN; ++hn) {
      const int oc0 = c0 + hn * (BN / NHN) + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * hn + j];
        if (p.scale4 != nullptr && oc0 + j < co)
          v[j] = v[j] * p.scale4[phase * co + oc0 + j] +
                 p.bias4[phase * co + oc0 + j];
      }
      if constexpr (VECTOR) {
        if (oc0 < co) store4(orow + oc0, v);  // co is a multiple of 4
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (oc0 + j < co) orow[oc0 + j] = Cvt<T>::from(v[j]);
      }
    }
  }
}

template <typename T, int BM, int BN, int NHM, int NHN>
int run(const Params& p, bool vector, int64_t M, cudaStream_t stream) {
  constexpr int NT = (BM / (4 * NHM)) * (BN / (4 * NHN));
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  (p.co + BN - 1) / BN, 4);
  if (vector)
    decoder_upsample_kernel<T, BM, BN, NHM, NHN, 16 / sizeof(T)>
        <<<grid, NT, 0, stream>>>(p);
  else
    decoder_upsample_kernel<T, BM, BN, NHM, NHN, 1>
        <<<grid, NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(p.n) * p.h * p.w;
  if (M >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores need every channel count a multiple of a
  // vector and every tensor aligned; otherwise masked scalars
  constexpr int V = 16 / sizeof(T);
  const bool vector = p.ci0 % V == 0 && p.ci1 % V == 0 && p.co % V == 0 &&
                      aligned16(p.x0) && (p.ci1 == 0 || aligned16(p.x1)) &&
                      aligned16(p.w4) && aligned16(p.out);
  // the widest channel tile that wastes no more of Co than a 64-wide one
  const int co64 = (p.co + 63) / 64 * 64, co128 = (p.co + 127) / 128 * 128;
  if (p.co >= 128 && co128 == co64)
    return run<T, 128, 128, 2, 2>(p, vector, M, stream);
  if (p.co >= 32) return run<T, 128, 64, 2, 2>(p, vector, M, stream);
  // below Co 32 (at small ngf, or Co <= 4 forced off the narrow kernel)
  return run<T, 128, 16, 1, 1>(p, vector, M, stream);
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
