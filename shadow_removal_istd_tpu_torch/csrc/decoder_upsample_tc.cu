// Fused MNet decoder step on Hopper's tensor cores (sm_90a), CUDA C++:
// the bf16 form for wide outputs (Co >= 32, every channel count a multiple
// of 8, 16-byte aligned tensors). Co <= 4 (the final layer) runs on
// decoder_upsample_narrow.cu, the rest (f32, ragged channel counts) on
// decoder_upsample.cu; ops/decoder.py picks one of the three by shape
// (decoder_variant).
//
// Replaces shadow_removal_istd_tpu/ops/pallas_decoder.py::_kernel (entry
// point fused_decoder_upsample) for those shapes, and computes what
// decoder_upsample.cu computes, for one or two channels-last parts
// (y, link) standing for their concat:
//
//   out[n, 2i+pr, 2j+pc, c] = eps( sum_parts sum_{di,dj in {0,1}} sum_ci
//       act(x_p[n, r(i+pr+di-1), q(j+pc+dj-1), ci])
//       * w4[di, dj, off_p + ci, (2pr+pc)*Co + c] )
//
// act = LeakyReLU(0.2) as bf16(0.2f * float(x)), or the identity; eps =
// acc*scale4 + bias4 on the f32 accumulator, or the identity; r/q clamp
// to the edge (nearest-2x upsample + 3x3 reflect conv) or read zero out
// of range (ConvTranspose(4,2,1)). The output goes straight into
// (N, 2H, 2W, Co): the depth-to-space is the epilogue's addressing.
//
// Bound on the H100: at the wide MNet steps (Ci 256..1024, Co 64..512)
// the step does ~500..1650 FLOP per byte it must move, above the ~295 at
// which 989 TFLOP/s of bf16 outruns 3.35 TB/s, so it is bound by
// operations, and only the tensor cores get near that bound.
//
// Design: each phase is an implicit GEMM, M = N*H*W pixels, N = Co,
// K = 4 taps * (Ci0 + Ci1), as in decoder_upsample.cu: a grid of (M
// tiles, Co tiles, 4 phases). A block (4 warps) owns a 128 x 64 output
// tile; each warp a 64 x 32 part of it, as 4 x 4 mma.sync m16n8k16
// tiles with f32 accumulators. The K loop walks taps, then parts, then
// 32-channel slices, so a K tile never straddles the two parts. Tiles go
// global -> shared with 16-byte cp.async in a 3-stage ring; an A row is
// one source pixel under the tap (8-channel chunks contiguous in NHWC;
// the edge clamps the address, zero padding, a ragged M and channels
// past the part use the zero-fill form), a B row is 64 contiguous output
// channels of w4 (K x N row-major, fed to the MMA by ldmatrix.trans).
// Each thread applies the LeakyReLU to the A chunks it copied, once they
// land, before the barrier that hands the stage to the MMAs. Shared rows
// are padded by 16 bytes so that ldmatrix reads no bank twice. The
// epilogue applies the affine to the f32 accumulators and stores bf16
// pairs at their depth-to-space addresses.
//
// Accuracy: the tensor cores do not round their f32 accumulation to
// nearest. One accumulator carried through all K/16 MMAs (128 at K =
// 2048) drifted from the exact sum further than cuDNN's f32 convolution,
// far enough to flip the bf16 rounding of outputs in [4, 8), whose ulp
// (0.031) exceeds the 3e-2 tolerance. So each 32-deep K tile is summed
// in fresh registers (2 MMAs) and added to the accumulator in f32
// round-to-nearest, for 16 x 4 more registers a thread. chip_smoke.py
// counts the outputs off the rounded f64 value, beside the CUDA-core
// kernel's and the plain version's count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 2, NT = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 per warp
constexpr int MI = WM / 16, NI = WN / 8;              // mma tiles per warp
constexpr int A_LD = BK + 8, B_LD = BN + 8;           // padded rows (bf16)
// 16-byte chunks: per A row, rows between one thread's A chunks, A
// chunks per thread, per B row, B chunks per thread
constexpr int A_CPR = BK / 8, A_RSTEP = NT / A_CPR, A_CHUNKS = BM / A_RSTEP;
constexpr int B_CPR = BN / 8, B_CHUNKS = BK * B_CPR / NT;
static_assert(NI % 2 == 0, "B fragments load two n-tiles at a time");
static_assert(BM % A_RSTEP == 0 && (BK * B_CPR) % NT == 0, "tile split");

struct Params {
  const __nv_bfloat16* x0;
  const __nv_bfloat16* x1;
  int ci0, ci1;
  const __nv_bfloat16* w4;
  const float* scale4;
  const float* bias4;
  __nv_bfloat16* out;
  int n, h, w, co;
  int leaky, zero_pad;
};

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b: one 16x8x16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// LeakyReLU(0.2) on a bf16 pair, each as bf16(0.2f * float(x)) where x < 0
// (torch's leaky_relu for bf16). max(x, bf16(0.2f * x)) is that value for
// every x: rounding is monotone, so bf16(0.2f * x) <= x for x >= 0 and
// >= x for x < 0.
__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  const float lo = __uint_as_float(v << 16);
  const float hi = __uint_as_float(v & 0xffff0000u);
  const __nv_bfloat162 s = __floats2bfloat162_rn(0.2f * lo, 0.2f * hi);
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&v), s);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__global__ void __launch_bounds__(NT) decoder_upsample_tc_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK][B_LD];

  const int phase = blockIdx.z, pr = phase >> 1, pc = phase & 1;
  const int h = p.h, w = p.w, co = p.co, ci = p.ci0 + p.ci1;
  const int64_t M = static_cast<int64_t>(p.n) * h * w;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int c0 = blockIdx.y * BN;
  const int64_t co4 = 4 * static_cast<int64_t>(co);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // this thread's A chunks: column a_c of rows a_r + r * A_RSTEP; each
  // row's image-row base b*h (-1 past M) and position (i, j)
  const int a_c = tid % A_CPR, a_r = tid / A_CPR;
  int rbase[A_CHUNKS], ri[A_CHUNKS], rj[A_CHUNKS];
#pragma unroll
  for (int r = 0; r < A_CHUNKS; ++r) {
    const int64_t m = m0 + a_r + r * A_RSTEP;
    rbase[r] = -1;
    ri[r] = rj[r] = 0;
    if (m < M) {
      const int64_t t = m / w;
      rj[r] = static_cast<int>(m - t * w);
      ri[r] = static_cast<int>(t % h);
      rbase[r] = static_cast<int>(t - ri[r]);  // b * h
    }
  }

  const int nk0 = (p.ci0 + BK - 1) / BK, nk1 = (p.ci1 + BK - 1) / BK;
  const int per_tap = nk0 + nk1, n_tiles = 4 * per_tap;

  // K tile t (tap, part, channel slice) into ring stage s
  auto load_tile = [&](int t, int s) {
    const int tap = t / per_tap, k = t - tap * per_tap;
    const bool part = k >= nk0;
    const int k0 = (part ? k - nk0 : k) * BK;
    const __nv_bfloat16* x = part ? p.x1 : p.x0;
    const int cp = part ? p.ci1 : p.ci0;
    const int off = part ? p.ci0 : 0;
    const int di = tap >> 1, dj = tap & 1;
    const int c = k0 + a_c * 8;
#pragma unroll
    for (int r = 0; r < A_CHUNKS; ++r) {
      int rr = ri[r] + pr + di - 1, qq = rj[r] + pc + dj - 1;
      const bool inside = rr >= 0 && rr < h && qq >= 0 && qq < w;
      const bool ok = rbase[r] >= 0 && c < cp && (inside || !p.zero_pad);
      rr = min(max(rr, 0), h - 1);
      qq = min(max(qq, 0), w - 1);
      const __nv_bfloat16* src =
          ok ? x + (static_cast<int64_t>(rbase[r] + rr) * w + qq) * cp + c
             : p.x0;
      cp_async16(smem_addr(&As[s][a_r + r * A_RSTEP][a_c * 8]), src, ok);
    }
#pragma unroll
    for (int e = 0; e < B_CHUNKS; ++e) {
      const int idx = tid + e * NT;
      const int kk = idx / B_CPR, nc = idx % B_CPR;
      const int cc = k0 + kk, oc = c0 + nc * 8;
      const bool ok = cc < cp && oc < co;
      const __nv_bfloat16* src =
          ok ? p.w4 + (static_cast<int64_t>(tap) * ci + off + cc) * co4 +
                   phase * co + oc
             : p.w4;
      cp_async16(smem_addr(&Bs[s][kk][nc * 8]), src, ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    if (p.leaky) {
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r) {
        uint4* q =
            reinterpret_cast<uint4*>(&As[s][a_r + r * A_RSTEP][a_c * 8]);
        uint4 v = *q;
        v.x = leaky2(v.x);
        v.y = leaky2(v.y);
        v.z = leaky2(v.z);
        v.w = leaky2(v.w);
        *q = v;
      }
    }
    // tile t is whole for every warp, and every warp is done with tile
    // t - 1, whose stage the next load refills
    __syncthreads();
    if (t + STAGES - 1 < n_tiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    // the tile's sum in fresh registers, added to acc once (see the note)
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], smem_addr(&As[s][wm * WM + i * 16 + (lane & 15)]
                                        [kk + (lane >> 4) * 8]));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        const int col = wn * WN + j * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(r, smem_addr(&Bs[s][kk + (lane & 15)][col]));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // epilogue: affine on the f32 accumulator, cast, depth-to-space store.
  // Accumulator e of tile (i, j) sits at row lane/4 (+8 for e >= 2) and
  // column 2*(lane%4) + e%2 of that tile.
  const int64_t h2 = 2 * static_cast<int64_t>(h), w2 = 2 * w;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * WM + i * 16 + (lane >> 2) + 8 * half;
      if (m >= M) continue;
      const int64_t t = m / w;
      const int jj = static_cast<int>(m - t * w);
      const int ii = static_cast<int>(t % h);
      const int64_t b = t / h;
      __nv_bfloat16* o =
          p.out + ((b * h2 + 2 * ii + pr) * w2 + 2 * jj + pc) * co;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int oc = c0 + wn * WN + j * 8 + 2 * (lane & 3);
        if (oc >= co) continue;  // co % 8 == 0: oc + 1 < co as well
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (p.scale4 != nullptr) {  // two roundings, as the plain version
          const float* s4 = p.scale4 + phase * co + oc;
          const float* b4 = p.bias4 + phase * co + oc;
          v0 = __fadd_rn(__fmul_rn(v0, s4[0]), b4[0]);
          v1 = __fadd_rn(__fmul_rn(v1, s4[1]), b4[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(o + oc) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// The same C interface as srit_decoder_upsample; dtype must be 1
// (bfloat16), Co >= 32, Ci0, Ci1 and Co multiples of 8, and x0, x1, w4
// and out 16-byte aligned, else it launches nothing and returns
// cudaErrorInvalidValue. Returns the launch's cudaError_t (0 on
// success). Launches on `stream`, does not synchronise.
extern "C" int srit_decoder_upsample_tc(int dtype, const void* x0,
                                        const void* x1, int ci0, int ci1,
                                        const void* w4, const void* scale4,
                                        const void* bias4, void* out, int n,
                                        int h, int w, int co, int leaky,
                                        int zero_pad, void* stream) {
  if (dtype != 1 || co < 32 || ci0 % 8 || ci1 % 8 || co % 8 ||
      !aligned16(x0) || !aligned16(x1) || !aligned16(w4) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(x0),
           static_cast<const __nv_bfloat16*>(x1),
           ci0,
           ci1,
           static_cast<const __nv_bfloat16*>(w4),
           static_cast<const float*>(scale4),
           static_cast<const float*>(bias4),
           static_cast<__nv_bfloat16*>(out),
           n,
           h,
           w,
           co,
           leaky,
           zero_pad};
  const int64_t M = static_cast<int64_t>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  (co + BN - 1) / BN, 4);
  decoder_upsample_tc_kernel<<<grid, NT, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
