// Int8 post-training-quantized convolutions of the MNet forward on Hopper
// (sm_90a), CUDA C++: two kernels, called from ops/int8_conv.py.
//
// No Pallas kernel stands behind them. They replace the XLA convolutions
// of shadow_removal_istd_tpu/models/quant.py: the activation quantize and
// pad of _conv_s2_reflect and _subpixel_phase_conv (quant.py:125-167, with
// _quantize at :93-94) and their s8 x s8 -> s32 lax.conv_general_dilated
// with the dequantize that follows (quant.py:139-143, :162-166), inside
// mnet_apply_folded's int8 graph (quant.py:178-273).
//
// A. quantize_pad: one or two NHWC parts (f32 or bf16), standing for their
//    channel concat, -> one int8 NHWC tensor padded by 1 (reflect for the
//    4x4 stride-2 encoder convs, edge for the 2x2 phase convs) and by zero
//    channels up to a multiple of 16:
//      q = clip(rint(act(x) / sx), -127, 127)
//    act = LeakyReLU in the compute dtype, as JAX's leaky_relu computes
//    it there: x > 0 ? x : x * slope rounded to the dtype, the slope 0.2
//    itself rounded to the dtype (f32 0.2f; bf16 0.2001953125, the bf16
//    constant a weakly typed 0.2 becomes), or the identity; the division
//    in f32, round half to even (rintf, as jnp.round and torch.round).
//    Padding commutes with an elementwise quantize, so the result is
//    JAX's pad(_quantize(x)). The concat is never formed.
//    Bound: bytes (each input read once, the padded int8 tensor written
//    once) at 3.35 TB/s. Design: a thread per 16-channel chunk of one
//    padded pixel, one 16-byte store; 16- or 32-byte loads where the part's
//    channels are a multiple of 16, else scalar ones (the 3/4-channel stem).
//
// B. int8_conv: an implicit-GEMM convolution of the padded int8 tensor with
//    s32 accumulation and a fused dequantize epilogue, in two forms:
//    - encoder, 4x4 stride 2: out[b,oh,ow,n] = sum_{kh,kw,c}
//        x[b, 2oh+kh, 2ow+kw, c] * w[n, kh, kw, c];
//    - phase, 2x2 stride 1 (Ci -> 4Co, the subpixel form of nearest-2x +
//      3x3 conv): phase p = (pr, pc) of output (b, 2i+pr, 2j+pc, n) sums
//        x[b, i+pr+di, j+pc+dj, c] * w[p*Co + n, di, dj, c];
//      only the outputs subpixel_depth_to_space keeps are computed, and
//      they are stored straight at their depth-to-space addresses.
//    Epilogue: v = (float)acc * s[row] (row = n, or p*Co + n), then
//    v + b[n] where a bias is given, each rounded to nearest (__fmul_rn,
//    __fadd_rn: no FMA contraction, the plain version's order), cast to
//    f32 or bf16; without scales the raw s32 sums are stored (the check
//    that they equal the plain version's bit for bit).
//    Bound: at MNet's wide sites (K = 1024..8192) the conv does some 250
//    to 2,000 int8 operations per byte it must move, on both sides of the
//    ~590 at which 1,979 TOPS outruns 3.35 TB/s, so some sites are bound
//    by bytes and the wider ones by operations; chip_smoke.py computes
//    max(ops / 1,979 TOPS, bytes / 3.35 TB/s) per site. Only the tensor
//    cores get near either bound. Design: as decoder_upsample_tc.cu
//    for bf16, a block of 4 warps owns a 128 x BN output tile (BN 64, or
//    16 for narrow outputs such as the final Co 1/3 step, whose N is
//    padded with zero weights, which is exact); mma.sync m16n8k32 s8 x s8
//    -> s32 over 64-byte K tiles (a tap's 64 channels) staged global ->
//    shared by 16-byte cp.async in a 3-stage ring; an A row is one output
//    position's input pixel under the tap (zero fill past M and past Cp),
//    a B row 64 contiguous K bytes of one output channel (the weight is
//    kept (rows, kh, kw, Cp), K contiguous), both read by ldmatrix (the
//    int8 fragments of m16n8k32 have the byte layout of bf16 m16n8k16's).
//    Shared rows are padded by 16 bytes so that ldmatrix reads no bank
//    twice. Integer sums are exact in any order. wgmma and TMA are later
//    work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// A. quantize_pad

struct QuantParams {
  const void* x0;
  const void* x1;
  int c0, c1;
  const float* sx;  // device scalar: the per-tensor activation scale
  int8_t* out;      // (N, H + 2, W + 2, Cp)
  int n, h, w, cp;
  int leaky, reflect;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// LeakyReLU in the compute dtype: x > 0 ? x : x * slope, rounded to the
// dtype, with slope = 0.2 rounded to the dtype (bf16(0.2) = 0.2001953125)
__device__ __forceinline__ float leaky(float v, float) {
  return v > 0.f ? v : __fmul_rn(v, 0.2f);
}
__device__ __forceinline__ float leaky(float v, __nv_bfloat16) {
  return v > 0.f ? v
                 : __bfloat162float(
                       __float2bfloat16_rn(__fmul_rn(v, 0.2001953125f)));
}

__device__ __forceinline__ uint32_t quantize(float v, float sx) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// padded coordinate p - 1 in [-1, n] -> source index
__device__ __forceinline__ int source(int p, int n, bool reflect) {
  if (p < 0) return reflect ? 1 : 0;
  if (p >= n) return reflect ? n - 2 : n - 1;
  return p;
}

// 16 consecutive channels of one part, starting at a multiple of 16
template <typename T>
__device__ __forceinline__ void load16(const T* src, float (&v)[16]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(src)[k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[k];
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * k + 2 * e] = __uint_as_float(words[e] << 16);
        v[8 * k + 2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256) quantize_pad_kernel(QuantParams p) {
  const int chunks = p.cp / 16;
  const int hp = p.h + 2, wp = p.w + 2;
  const int64_t total = static_cast<int64_t>(p.n) * hp * wp * chunks;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int chunk = static_cast<int>(t % chunks);
  const int64_t pix = t / chunks;  // padded pixel (b, yp, xp)
  const int xp = static_cast<int>(pix % wp);
  const int64_t r = pix / wp;
  const int yp = static_cast<int>(r % hp);
  const int64_t b = r / hp;
  const bool refl = p.reflect != 0;
  const int64_t src_pix =
      (b * p.h + source(yp - 1, p.h, refl)) * p.w + source(xp - 1, p.w, refl);
  const float sx = *p.sx;
  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const int c = chunk * 16;

  float v[16];
  int valid = 16;  // channels of the chunk inside the concat
  if (VEC && c < p.c0) {
    load16(x0 + src_pix * p.c0 + c, v);
  } else if (VEC && c < p.c0 + p.c1) {
    load16(x1 + src_pix * p.c1 + (c - p.c0), v);
  } else {
    valid = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int ck = c + k;
      v[k] = 0.f;
      if (ck < p.c0) {
        v[k] = to_float(x0[src_pix * p.c0 + ck]);
        valid = k + 1;
      } else if (ck < p.c0 + p.c1) {
        v[k] = to_float(x1[src_pix * p.c1 + (ck - p.c0)]);
        valid = k + 1;
      }
    }
  }
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < valid) {
      const float a = p.leaky ? leaky(v[k], T()) : v[k];
      words[k >> 2] |= quantize(a, sx) << (8 * (k & 3));
    }
  }
  *reinterpret_cast<uint4*>(p.out + pix * p.cp + c) =
      make_uint4(words[0], words[1], words[2], words[3]);
}

// ---------------------------------------------------------------------------
// B. int8_conv

struct ConvParams {
  const int8_t* x;     // (N, Hp, Wp, Cp), padded
  const int8_t* wk;    // (rows, kt, kt, Cp)
  const float* scale;  // (rows,), or null: store the s32 sums
  const float* bias;   // (Co,), or null
  void* out;           // encoder (N, Ho, Wo, Co); phase (N, 2Ho, 2Wo, Co)
  int n, hp, wp, cp;
  int ho, wo;          // output grid per phase
  int co;
  int phase_form;      // 0: 4x4 stride 2; 1: 2x2 stride 1, 4 phases
  int out_dtype;       // 0 f32, 1 bf16, 2 s32
};

constexpr int BM = 128, BK = 64, STAGES = 3, NT = 128;
constexpr int LD = BK + 16;            // padded shared row (bytes)
constexpr int CPR = BK / 16;           // 16-byte chunks per row
constexpr int A_RSTEP = NT / CPR;      // rows between one thread's A chunks
constexpr int A_CHUNKS = BM / A_RSTEP;
static_assert(BM % A_RSTEP == 0, "tile split");

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b: one 16x8x32 tile, s8 operands, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN, int WARPS_M>
__global__ void __launch_bounds__(NT) int8_conv_kernel(ConvParams p) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(NI % 2 == 0, "B fragments load two n-tiles at a time");
  __shared__ __align__(16) int8_t As[STAGES][BM][LD];
  __shared__ __align__(16) int8_t Bs[STAGES][BN][LD];

  const int phase = blockIdx.z, pr = phase >> 1, pc = phase & 1;
  const bool ph = p.phase_form != 0;
  const int kt = ph ? 2 : 4, stride = ph ? 1 : 2;
  const int64_t M = static_cast<int64_t>(p.n) * p.ho * p.wo;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int row0 = ph ? phase * p.co : 0;  // this phase's weight rows
  const int64_t krow = static_cast<int64_t>(kt) * kt * p.cp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // this thread's A chunks: column a_c of rows a_r + r * A_RSTEP; each
  // row's byte offset of its window's top-left input pixel (-1 past M)
  const int a_c = tid % CPR, a_r = tid / CPR;
  int64_t abase[A_CHUNKS];
#pragma unroll
  for (int r = 0; r < A_CHUNKS; ++r) {
    const int64_t m = m0 + a_r + r * A_RSTEP;
    abase[r] = -1;
    if (m < M) {
      const int64_t t = m / p.wo;
      const int ow = static_cast<int>(m - t * p.wo);
      const int oh = static_cast<int>(t % p.ho);
      const int64_t b = t / p.ho;
      const int iy = oh * stride + (ph ? pr : 0);
      const int ix = ow * stride + (ph ? pc : 0);
      abase[r] = ((b * p.hp + iy) * p.wp + ix) * p.cp;
    }
  }

  const int nk = (p.cp + BK - 1) / BK;  // K tiles per tap
  const int n_tiles = kt * kt * nk;

  // K tile t (tap, 64-channel slice) into ring stage s
  auto load_tile = [&](int t, int s) {
    const int tap = t / nk;
    const int c0 = (t - tap * nk) * BK;
    const int dy = tap / kt, dx = tap - dy * kt;
    const int64_t toff = (static_cast<int64_t>(dy) * p.wp + dx) * p.cp;
    const int c = c0 + a_c * 16;
#pragma unroll
    for (int r = 0; r < A_CHUNKS; ++r) {
      const bool ok = abase[r] >= 0 && c < p.cp;
      const int8_t* src = ok ? p.x + abase[r] + toff + c : p.x;
      cp_async16(smem_addr(&As[s][a_r + r * A_RSTEP][a_c * 16]), src, ok);
    }
#pragma unroll
    for (int idx = tid; idx < BN * CPR; idx += NT) {
      const int nn = idx / CPR, kc = idx % CPR;
      const int n = n0 + nn, cc = c0 + kc * 16;
      const bool ok = n < p.co && cc < p.cp;
      const int8_t* src =
          ok ? p.wk + static_cast<int64_t>(row0 + n) * krow +
                   static_cast<int64_t>(tap) * p.cp + cc
             : p.wk;
      cp_async16(smem_addr(&Bs[s][nn][kc * 16]), src, ok);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    // tile t is whole for every warp, and every warp is done with tile
    // t - 1, whose stage the next load refills
    __syncthreads();
    if (t + STAGES - 1 < n_tiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], smem_addr(&As[s][wm * WM + i * 16 + (lane & 15)]
                                        [kk + (lane >> 4) * 16]));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // matrices: (tile j, bytes 0-15), (j, 16-31), (j+1, 0-15), (j+1,
        // 16-31); lane l gives row l & 7 of matrix l >> 3
        uint32_t r[4];
        const int q = lane >> 3;
        ldmatrix_x4(r, smem_addr(&Bs[s][wn * WN + (j + (q >> 1)) * 8 +
                                        (lane & 7)][kk + (q & 1) * 16]));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue. Accumulator e of tile (i, j) sits at row lane/4 (+8 for
  // e >= 2) and column 2*(lane%4) + e%2 of that tile.
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * WM + i * 16 + (lane >> 2) + 8 * half;
      if (m >= M) continue;
      int64_t opix = m;  // encoder: outputs enumerate (b, oh, ow) as M does
      if (ph) {
        const int64_t t = m / p.wo;
        const int j2 = static_cast<int>(m - t * p.wo);
        const int i2 = static_cast<int>(t % p.ho);
        const int64_t b = t / p.ho;
        opix = (b * 2 * p.ho + 2 * i2 + pr) * (2 * static_cast<int64_t>(p.wo)) +
               2 * j2 + pc;
      }
      const int64_t off = opix * p.co;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * (lane & 3) + e;
          if (n >= p.co) continue;
          const int a = acc[i][j][2 * half + e];
          if (p.out_dtype == 2) {
            static_cast<int*>(p.out)[off + n] = a;
            continue;
          }
          float v = __fmul_rn(__int2float_rn(a), p.scale[row0 + n]);
          if (p.bias != nullptr) v = __fadd_rn(v, p.bias[n]);
          if (p.out_dtype == 0)
            static_cast<float*>(p.out)[off + n] = v;
          else
            static_cast<__nv_bfloat16*>(p.out)[off + n] =
                __float2bfloat16_rn(v);
        }
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// quantize_pad: dtype 0 (float32) or 1 (bfloat16) parts x0 (N, H, W, c0)
// and x1 (N, H, W, c1; c1 may be 0 and x1 null), channels-last; sx a
// device float; out (N, H + 2, W + 2, cp) int8 with cp a multiple of 16
// and >= c0 + c1, 16-byte aligned; reflect needs H, W >= 2. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for arguments outside these
// rules, launching nothing). Launches on `stream`, does not synchronise.
extern "C" int srit_quantize_pad(int dtype, const void* x0, const void* x1,
                                 int c0, int c1, const void* sx, void* out,
                                 int n, int h, int w, int cp, int leaky,
                                 int reflect, void* stream) {
  if ((dtype != 0 && dtype != 1) || cp % 16 || cp < c0 + c1 || c0 < 1 ||
      c1 < 0 || (c1 > 0 && x1 == nullptr) || !aligned16(out) ||
      (reflect && (h < 2 || w < 2)) || n < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantParams p{x0, x1, c0, c1, static_cast<const float*>(sx),
                static_cast<int8_t*>(out), n, h, w, cp, leaky, reflect};
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = c0 % 16 == 0 && c1 % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x0) % (16 * esize)) == 0 &&
                   (c1 == 0 ||
                    (reinterpret_cast<uintptr_t>(x1) % (16 * esize)) == 0);
  const int64_t total =
      static_cast<int64_t>(n) * (h + 2) * (w + 2) * (cp / 16);
  const dim3 grid(static_cast<unsigned>((total + 255) / 256));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      quantize_pad_kernel<float, true><<<grid, 256, 0, s>>>(p);
    else
      quantize_pad_kernel<float, false><<<grid, 256, 0, s>>>(p);
  } else {
    if (vec)
      quantize_pad_kernel<__nv_bfloat16, true><<<grid, 256, 0, s>>>(p);
    else
      quantize_pad_kernel<__nv_bfloat16, false><<<grid, 256, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// int8_conv: x (N, hp, wp, cp) int8 padded, wk (rows, kt, kt, cp) int8 with
// kt 4 (phase_form 0: rows = co, stride 2, output (N, ho, wo, co)) or 2
// (phase_form 1: rows = 4 * co, output (N, 2 ho, 2 wo, co) in
// depth-to-space order); cp a multiple of 16, x and wk 16-byte aligned.
// scale (rows,) f32 and bias (co,) f32 or null; out_dtype 0 f32, 1 bf16,
// 2 s32 (then scale and bias must be null). Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments outside these rules,
// launching nothing). Launches on `stream`, does not synchronise.
extern "C" int srit_int8_conv(const void* x, const void* wk,
                              const void* scale, const void* bias, void* out,
                              int out_dtype, int n, int hp, int wp, int cp,
                              int ho, int wo, int co, int phase_form,
                              void* stream) {
  const bool raw = out_dtype == 2;
  if (cp % 16 || cp < 16 || !aligned16(x) || !aligned16(wk) || n < 1 ||
      ho < 1 || wo < 1 || co < 1 || out_dtype < 0 || out_dtype > 2 ||
      raw != (scale == nullptr) || (raw && bias != nullptr) ||
      (phase_form != 0 && phase_form != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (phase_form ? (hp != ho + 2 || wp != wo + 2)
                 : (hp != 2 * ho + 2 || wp != 2 * wo + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p{static_cast<const int8_t*>(x),
               static_cast<const int8_t*>(wk),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias),
               out,
               n,
               hp,
               wp,
               cp,
               ho,
               wo,
               co,
               phase_form,
               out_dtype};
  const int64_t M = static_cast<int64_t>(n) * ho * wo;
  const unsigned mt = static_cast<unsigned>((M + BM - 1) / BM);
  const unsigned phases = phase_form ? 4 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co <= 16) {
    int8_conv_kernel<16, 4><<<dim3(mt, (co + 15) / 16, phases), NT, 0, s>>>(p);
  } else {
    int8_conv_kernel<64, 2><<<dim3(mt, (co + 63) / 64, phases), NT, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
