// Fused MNet decoder step for narrow outputs (Co 1..4) on Hopper (sm_90a),
// CUDA C++: the final MNet layer (Co 1 in G1, Co 3 in G2), in bf16 and
// f32. ops/decoder.py sends every step with Co <= 4 here
// (decoder_variant); wider steps run on decoder_upsample_tc.cu or
// decoder_upsample.cu.
//
// Replaces shadow_removal_istd_tpu/ops/pallas_decoder.py::_kernel (entry
// point fused_decoder_upsample) for those shapes, and computes what the
// other two decoder kernels compute, for one or two channels-last parts
// (y, link) standing for their concat:
//
//   out[n, 2i+pr, 2j+pc, c] = eps( sum_parts sum_{di,dj in {0,1}} sum_ci
//       act(x_p[n, r(i+pr+di-1), q(j+pc+dj-1), ci])
//       * w4[di, dj, off_p + ci, (2pr+pc)*Co + c] )
//
// act = LeakyReLU(0.2) rounded to the input type, or the identity; eps =
// acc*scale4 + bias4 on the f32 accumulator, or the identity; r/q clamp
// to the edge (nearest-2x upsample + 3x3 reflect conv) or read zero out
// of range (ConvTranspose(4,2,1)). The output goes straight into
// (N, 2H, 2W, Co): the depth-to-space is the epilogue's addressing.
//
// Bound on the H100: per input value and output channel the step does 16
// FMAs (4 phases x 4 taps), i.e. 32*Co FLOP per input element of 2 or 4
// bytes. At 256^2 b32 bf16 (Ci 128) Co 1 must move 138 MB (0.041 ms at
// 3.35 TB/s) for 2.15 GFLOP (0.032 ms at the 67 TFLOP/s f32 FMA rate);
// Co 3 needs 6.44 GFLOP (0.096 ms) for 143 MB. So on the CUDA cores the
// ceiling is the bytes at Co 1 and the FMA pipe at Co 3. f32 FMAs round
// to nearest, so the f32 form holds 2e-5 against the plain version (TF32
// would not) and the bf16 form rounds from an accurate f32 sum.
//
// Design: each input element is read from device memory once for all
// four phases and taps. A block of 128 threads (8 along W x 16 along H)
// owns a 16 x 32 tile of input positions of one image, every phase and
// every output channel; a thread owns 4 adjacent positions of a row and
// keeps 4*Co f32 accumulators for each. The channels of one part go in
// chunks of two 16-byte pieces per pixel (16 bf16 or 8 f32 channels: one
// 32-byte sector):
//
//   - loads: the chunk's 18 x 34 halo goes global -> shared in its
//     channels-last form with 16-byte cp.async.cg, consecutive threads on
//     consecutive pieces of a pixel, into a 2-stage ring, so the next
//     chunk is in flight while this one is computed. Edge padding clamps
//     the source pixel; zero padding and channels past the part use the
//     zero-fill form. Where the part's pointer or channel count rules out
//     16-byte copies (the kernel checks both), each thread loads its
//     piece channel by channel and stores it itself. A pixel's record is
//     swizzled (piece j at slot j ^ (pixel / (8/PIECES)) % PIECES) so that
//     8 consecutive pixels' same piece hit 32 distinct banks. (Loading one
//     16-byte piece per pixel straight into registers, each warp load
//     touching 32 lines, was slower on the H100: the loads set the pace.);
//   - transpose: per piece, the block turns the ring's records into f32
//     planes [channel][row][col] (rows of 36 floats), applying the
//     LeakyReLU once here;
//   - weights: each chunk's w4 slice is loaded into registers one chunk
//     ahead and stored to shared memory as [channel][tap][phase][Co], so
//     one channel's 16*Co weights are 4*Co float4 broadcast loads;
//   - FMAs: per channel, a thread reads each of its 3 halo rows as two
//     float4 (6 of the 8 values used) and runs the 16*Co FMAs of each of
//     its 4 positions over the 3x3 neighbourhood: a neighbour value feeds
//     every position and phase that reads it, a weight every position.
//
// Shared-memory wavefronts per FMA instruction, per channel and warp: 3
// rows x 2 float4 (4 wavefronts each) + 4*Co weight broadcasts against
// 64*Co FMAs: Co 1 0.44, Co 2 0.25, Co 3 0.19, Co 4 0.16. An SM issues 4
// warp FMAs and serves one wavefront per clock, so from Co 2 up the FMA
// pipe sets the pace; at Co 1 shared memory does (0.44 / 0.25 x 0.032 =
// 0.056 ms at 256^2 b32, above the 0.041 ms of its bytes). The epilogue
// applies the affine (two roundings, as the plain version), casts, and
// writes each thread's 2x2xCo quads: per output row 8*Co contiguous
// elements, the neighbouring thread's next to them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TX = 8, TY = 16, NT = TX * TY;  // threads along W, along H
constexpr int PX = 4;                         // positions a thread along W
constexpr int TW = TX * PX, TH = TY;          // tile: 16 x 32 positions
constexpr int HC = TW + 2, HR = TH + 2;       // halo columns, rows
constexpr int HALO = HR * HC;                 // halo pixels
constexpr int RS = 36;                        // plane row stride (floats)
constexpr int PLANE = HR * RS;                // floats per channel plane
static_assert(RS >= HC + 2 && RS % 4 == 0, "two float4 per row, aligned");
constexpr int PIECES = 2;                     // 16-byte pieces a pixel
constexpr int STAGES = 2;                     // chunks in the ring
constexpr int RAW = HALO * 4 * PIECES;        // words per ring stage
constexpr int PF = (HALO * PIECES + NT - 1) / NT;  // pieces a thread copies
constexpr int TPF = (HALO + NT - 1) / NT;          // pixels it transposes
static_assert(NT % PIECES == 0, "a thread copies one piece of pixels");

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int VEC = 4;  // channels a 16-byte piece
  static __device__ __forceinline__ float get(const uint4& v, int k) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    return __uint_as_float(w[k]);
  }
  // element i of x as the low bits of a 32-bit word
  static __device__ __forceinline__ uint32_t bits(const float* x, int64_t i) {
    return __float_as_uint(x[i]);
  }
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float get(const uint4& v, int k) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t word = w[k >> 1];
    return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
  }
  static __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* x,
                                                 int64_t i) {
    return __bfloat16_as_ushort(x[i]);
  }
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

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

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false it reads nothing and writes
// zeros (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// word offset of pixel P's piece j in a ring stage (see the header)
__device__ __forceinline__ int raw_at(int P, int j) {
  return P * 4 * PIECES + 4 * (j ^ ((P / (8 / PIECES)) % PIECES));
}

// channels ch .. ch+VEC-1 of the pixel whose channels start at x + base,
// zero past cp, one load a channel
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* x, int64_t base, int ch,
                                            int cp) {
  constexpr int VEC = Elt<T>::VEC, PER = VEC / 4;  // elements a word
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (ch + k < cp)
      w[k / PER] |= Elt<T>::bits(x, base + ch + k) << (32 / PER * (k % PER));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int CO>
__global__ void __launch_bounds__(NT) decoder_upsample_narrow_kernel(Params p) {
  constexpr int VEC = Elt<T>::VEC;      // channels a piece
  constexpr int CKC = VEC * PIECES;     // channels a chunk
  constexpr int NW = 16 * CO;           // weights a channel
  constexpr int WPT = (CKC * NW + NT - 1) / NT;  // weights a thread stages
  // channels unrolled in the FMA loop: all of a piece's from Co 3 up, 2
  // below (each the faster on the H100)
  constexpr int UNROLL = CO >= 3 ? VEC : 2;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                                // [STAGES][RAW]
  float* xs = reinterpret_cast<float*>(smem + STAGES * RAW);  // [VEC][PLANE]
  float* ws = xs + VEC * PLANE;                           // [CKC][NW]

  const T* w4 = static_cast<const T*>(p.w4);
  T* out = static_cast<T*>(p.out);
  const int h = p.h, w = p.w, ci = p.ci0 + p.ci1;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int64_t img = static_cast<int64_t>(blockIdx.z) * h * w;

  // this thread copies piece jp of halo pixels tid/PIECES + k*NT/PIECES:
  // their pixel index in the image, -1 for a zero, -2 past the halo
  const int jp = tid % PIECES;
  int pix[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) {
    const int P = tid / PIECES + k * (NT / PIECES);
    const int s = P / HC, t = P - s * HC;
    int rr = i0 - 1 + s, qq = j0 - 1 + t;
    const bool inside = rr >= 0 && rr < h && qq >= 0 && qq < w;
    pix[k] = P < HALO ? -1 : -2;
    if (P < HALO && (inside || !p.zero_pad)) {
      rr = min(max(rr, 0), h - 1);
      qq = min(max(qq, 0), w - 1);
      pix[k] = rr * w + qq;
    }
  }

  // chunk q: CKC channels from c0 of part 0 (q < n0) or part 1
  struct Chunk {
    const T* x;
    int cp, c0, off;
    bool vec;
  };
  const int n0 = (p.ci0 + CKC - 1) / CKC;
  const int nq = n0 + (p.ci1 + CKC - 1) / CKC;
  const bool vec0 = aligned16(p.x0) && p.ci0 % VEC == 0;
  const bool vec1 = aligned16(p.x1) && p.ci1 % VEC == 0;
  auto chunk = [&](int q) {
    return q < n0 ? Chunk{static_cast<const T*>(p.x0), p.ci0, q * CKC, 0,
                          vec0}
                  : Chunk{static_cast<const T*>(p.x1), p.ci1,
                          (q - n0) * CKC, p.ci0, vec1};
  };

  auto issue = [&](int q) {  // chunk q's halo -> ring stage q % STAGES
    const Chunk c = chunk(q);
    uint32_t* stage = ring + (q % STAGES) * RAW;
    const int ch = c.c0 + jp * VEC;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      if (pix[k] == -2) continue;
      const int P = tid / PIECES + k * (NT / PIECES);
      uint32_t* dst = stage + raw_at(P, jp);
      const bool ok = pix[k] >= 0 && ch < c.cp;
      const int64_t base = (img + max(pix[k], 0)) * c.cp;
      if (c.vec)
        cp_async16(smem_addr(dst), ok ? c.x + base + ch : c.x, ok);
      else
        *reinterpret_cast<uint4*>(dst) =
            ok ? load_piece<T>(c.x, base, ch, c.cp) : make_uint4(0, 0, 0, 0);
    }
  };

  float wr[WPT];
  auto load_w = [&](int q) {  // chunk q's weights -> registers
    const Chunk c = chunk(q);
#pragma unroll
    for (int u = 0; u < WPT; ++u) {
      const int e = tid + u * NT;
      const int k = e / NW, r = e - k * NW;  // r = tap*4Co + phase*Co + co
      const int tap = r / (4 * CO);
      wr[u] = e < CKC * NW && c.c0 + k < c.cp
                  ? Elt<T>::to(w4[(static_cast<int64_t>(tap) * ci + c.off +
                                   c.c0 + k) * (4 * CO) + (r - tap * 4 * CO)])
                  : 0.f;
    }
  };

  float acc[PX][4][CO];
#pragma unroll
  for (int px = 0; px < PX; ++px)
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[px][ph][c] = 0.f;

#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < nq) issue(q);
    cp_async_commit();
  }
  load_w(0);
  for (int q = 0; q < nq; ++q) {
    if (q + STAGES - 1 < nq) issue(q + STAGES - 1);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < WPT; ++u)
      if (tid + u * NT < CKC * NW) ws[tid + u * NT] = wr[u];
    if (q + 1 < nq) load_w(q + 1);
    cp_async_wait<STAGES - 1>();  // chunk q has landed
    __syncthreads();

    const Chunk c = chunk(q);
    const uint32_t* stage = ring + (q % STAGES) * RAW;
    const int pieces = min(PIECES, (c.cp - c.c0 + VEC - 1) / VEC);
    for (int j = 0; j < pieces; ++j) {
      // piece j of every halo pixel -> f32 planes, LeakyReLU applied once
#pragma unroll
      for (int k = 0; k < TPF; ++k) {
        const int P = tid + k * NT;
        if (P >= HALO) continue;
        const int s = P / HC, t = P - s * HC;
        const uint4 v =
            *reinterpret_cast<const uint4*>(stage + raw_at(P, j));
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float f = Elt<T>::get(v, e);
          if (p.leaky && f < 0.f) f = Elt<T>::round(0.2f * f);
          xs[e * PLANE + s * RS + t] = f;
        }
      }
      __syncthreads();

      const float* wj = ws + j * VEC * NW;
#pragma unroll UNROLL
      for (int e = 0; e < VEC; ++e) {
        const float* xc = xs + e * PLANE + ty * RS + tx * PX;
        float wv[NW];
#pragma unroll
        for (int k = 0; k < NW; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wj + e * NW + k);
          wv[k] = v.x; wv[k + 1] = v.y; wv[k + 2] = v.z; wv[k + 3] = v.w;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {  // halo row a: neighbour row a - 1
          const float4 lo = *reinterpret_cast<const float4*>(xc + a * RS);
          const float4 hi =
              *reinterpret_cast<const float4*>(xc + a * RS + 4);
          const float v[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
          const int dr = a - 1;
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int di = dr + 1 - pr;  // pr + di - 1 == dr
            if (di < 0 || di > 1) continue;
#pragma unroll
            for (int px = 0; px < PX; ++px)
#pragma unroll
              for (int dc = -1; dc <= 1; ++dc)
#pragma unroll
                for (int pc = 0; pc < 2; ++pc) {
                  const int dj = dc + 1 - pc;  // pc + dj - 1 == dc
                  if (dj < 0 || dj > 1) continue;
                  const int ph = 2 * pr + pc;
                  const float* wt = wv + (2 * di + dj) * 4 * CO + ph * CO;
#pragma unroll
                  for (int o = 0; o < CO; ++o)
                    acc[px][ph][o] =
                        fmaf(v[px + dc + 1], wt[o], acc[px][ph][o]);
                }
          }
        }
      }
      __syncthreads();
    }
  }

  // epilogue: affine on the f32 accumulator, cast, depth-to-space store
  const int i = i0 + ty;
  if (i >= h) return;
  const bool affine = p.scale4 != nullptr;
  float s4[4 * CO], b4[4 * CO];
#pragma unroll
  for (int k = 0; k < 4 * CO; ++k) {
    s4[k] = affine ? p.scale4[k] : 1.f;
    b4[k] = affine ? p.bias4[k] : 0.f;
  }
  const int64_t h2 = 2 * static_cast<int64_t>(h), w2 = 2 * w;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    T* orow = out + (blockIdx.z * h2 + 2 * i + pr) * w2 * CO;
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      const int j = j0 + tx * PX + px;
      if (j >= w) continue;
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        const int ph = 2 * pr + pc;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          float v = acc[px][ph][o];
          if (affine)  // two roundings, as the plain version
            v = __fadd_rn(__fmul_rn(v, s4[ph * CO + o]), b4[ph * CO + o]);
          orow[(2 * j + pc) * CO + o] = Elt<T>::from(v);
        }
      }
    }
  }
}

template <typename T, int CO>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int VEC = Elt<T>::VEC;
  constexpr int bytes =
      4 * (STAGES * RAW + VEC * PLANE + VEC * PIECES * 16 * CO);
  const cudaError_t set = cudaFuncSetAttribute(
      decoder_upsample_narrow_kernel<T, CO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((p.w + TW - 1) / TW, (p.h + TH - 1) / TH, p.n);
  decoder_upsample_narrow_kernel<T, CO><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_co(const Params& p, cudaStream_t stream) {
  switch (p.co) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    default: return launch<T, 4>(p, stream);
  }
}

}  // namespace

// The same C interface as srit_decoder_upsample (decoder_upsample.cu);
// dtype 0 = float32, 1 = bfloat16, and Co must be 1..4, else it launches
// nothing and returns cudaErrorInvalidValue. Any N, H, W, channel counts
// and pointer alignment. Returns the launch's cudaError_t (0 on
// success). Launches on `stream`, does not synchronise.
extern "C" int srit_decoder_upsample_narrow(int dtype, const void* x0,
                                            const void* x1, int ci0, int ci1,
                                            const void* w4, const void* scale4,
                                            const void* bias4, void* out,
                                            int n, int h, int w, int co,
                                            int leaky, int zero_pad,
                                            void* stream) {
  if (co < 1 || co > 4 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x0, x1, ci0, ci1, w4,
           static_cast<const float*>(scale4),
           static_cast<const float*>(bias4), out, n, h, w, co, leaky,
           zero_pad};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_co<float>(p, s)
                    : launch_co<__nv_bfloat16>(p, s);
}
