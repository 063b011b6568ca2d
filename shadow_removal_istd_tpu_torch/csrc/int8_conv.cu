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
//    GEMM view: M = output positions (per phase), N = Co, K = taps x Cp,
//    walked as the weight stores it: the flattened (tap, channel) axis in
//    16-byte chunks. Integer sums are exact in any order.
//
//    Bounds on an H100 (1,979 int8 TOPS, 3.35 TB/s; chip_smoke.py computes
//    max(ops / 1,979 TOPS, bytes / 3.35 TB/s) per site):
//    - the wide sites (Cp 64..1024, K 1024..8192, Co 64..512) do 250 to
//      2,000 operations per byte they must move, mostly past the ~590 at
//      which the tensor cores, not the memory, are the limit: operations
//      bound them (down0 by a little, bytes);
//    - the stems (Cp 16 holding the image's 3 or 4 channels, Co 64) and
//      the finals (phase form, Co 1 or 3) do some 30 operations per byte:
//      bytes bound them, the int8 input read and the output written.
//
//    Design (Hopper):
//    - the main loop runs wgmma.mma_async m64nBNk32 s32.s8.s8, both
//      operands K-major in shared memory with the 128-byte swizzle (one
//      128-byte K tile a stage, four k32 steps, each a descriptor advanced
//      by 32 bytes inside the swizzle atom). A block owns a 128 x BN output
//      tile, two consumer warpgroups on its m64 halves. BN is 8 .. 128:
//      up to 64 columns one tile that covers them all (so A is gathered
//      once; wgmma's N is 8 at the least), past that 128: at 256 a
//      thread's 128 accumulators spilled beside the epilogue (and faulted
//      at 256x256's down2), and 128 with split K measured as fast;
//    - a producer warpgroup keeps a ring of 4 to 6 stages full. The weight
//      tile arrives by TMA: a 2-D tiled tensor map over (rows, taps * Cp)
//      with the 128-byte swizzle, whose zero fill past the K end and past
//      the last row keeps ragged K and N exact. The A tile (128 output
//      positions x 128 bytes of K) arrives by TMA too where a K tile is
//      one box row: a box of tw x th output positions (x nb images where
//      an image has fewer than 128) of a 4-D map (Cp, Wp, Hp, N) for the
//      stride-1 forms (Cp a multiple of 128: 128 channels of one tap), or
//      of a 5-D map over pixel pairs and row pairs (2 Cp, Wp / 2, 2,
//      Hp / 2, N) for the stride-2 encoder, whose taps are then whole
//      coordinates (Cp a multiple of 128, or 64: then taps dx, dx + 1 of
//      down0 are one pair's 128 bytes); one thread issues both boxes,
//      and their bytes complete the stage's mbarrier. Rows of a box past
//      the image are masked in the epilogue. Elsewhere (the stems' Cp 16,
//      ragged Cp 48 or 80) a K tile mixes taps that no box row holds, and
//      A is gathered by 16-byte cp.async, each chunk written at its
//      swizzled address; each producer thread waits for its copies two
//      stages behind the newest and fences them into the async proxy,
//      then its warp arrives once on the stage's mbarrier (a wider lag
//      measured slower). TMA's im2col mode was not tried;
//    - the stems: K walks (tap, channel) in 16-byte chunks, so a 32-byte
//      k-step is 2 taps x 16 channels and a stem's K is 256 bytes (2 K
//      tiles), not 16 taps x 64;
//    - the finals (phase form, Co <= 4; phase_form 2, the weight given
//      expanded to the 3x3 window by the layer that owns it): the 4 phases
//      in one tile, K over the 3x3 window (9 taps; each phase's weight
//      zero at the 5 taps it skips), N = 4 Co (8 or 16 columns), so each
//      input pixel is gathered 9 times and not 16, for one tile and not
//      four;
//    - the deep sites (down3: M 2048, K 8192; the 16x16 and 8x8 levels at
//      480x640) have fewer tiles than the card has SMs: K is split over
//      taps until about 132 units are in flight. Each split adds its s32
//      partials into a zeroed workspace the wrapper allocates (atomic adds,
//      exact in any order); the split that finishes a tile last, by a
//      per-tile counter, reads the full sums back and runs the epilogue
//      once. One kernel, one launch per call;
//    - the kernel is persistent: min(units, SMs x blocks an SM) blocks
//      walk the units and the ring runs on across them, so the next
//      tile's loads overlap an epilogue (the thin sites have 2 to 9 K
//      tiles per tile). Where BN <= 64 an SM holds two blocks (half the
//      shared memory each), so one block's epilogue and barrier waits
//      overlap the other's products;
//    - the epilogue stages each warpgroup's sums in shared memory (64
//      columns a pass, 16 with two blocks an SM) and stores 4 columns of a
//      row at once (16 bytes of f32, 8 of bf16, where Co is a multiple of
//      4), with each row's output offset found once a unit and each
//      column's scale and bias once a pass; index math is 32-bit (M <
//      2^31): 64-bit divisions per row measured as costly as the finals'
//      loads.
//    No Pallas kernel stands behind this: it replaces the s8 x s8 -> s32
//    lax.conv_general_dilated calls of the JAX int8 graph
//    (shadow_removal_istd_tpu/models/quant.py:139, :162) and the
//    dequantize after them.
//
// C. The fused quantize (srit_int8_conv_quantized): B's conv whose
//    epilogue writes, in place of a bf16 or f32 output, the padded int8
//    inputs of the sites that read it: A's quantize_pad folded into the
//    producer. At every site but the stems the only consumers of a conv's
//    output are the next sites' quantizes (mnet_apply_folded's int8 graph,
//    quant.py:236-273): the encoder's LeakyReLU, its link to the decoder
//    (LeakyReLU again at the decoder site), the decoder's next input part.
//    So the epilogue takes B's value v, rounds it to the compute dtype,
//    and for each of 1 or 2 destinations applies LeakyReLU 0, 1 or 2
//    times and A's quantize with that destination's scale, and stores the
//    byte at (b, y + 1, x + 1, c_off + n) of its (N, H + 2, W + 2, Cp)
//    tensor (the phase form at its depth-to-space pixel). A pixel that a
//    pad reads stores there too: edge, row 0 to row -1 and row H - 1 to
//    row H; reflect, row 1 to row -1 and row H - 2 to row H; columns and
//    corners alike. That is A's output, one part of it, bit for bit.
//    Bound: B's, with 1 byte an output (a destination) in place of 2 or
//    4; what it saves is the bf16 activation written, read by an
//    elementwise LeakyReLU and written again, and read by A (and the
//    encoder links read once more at their decoder site), and A's
//    launches: 18 of 20 a stacked forward (the stems' inputs, the image
//    and G2's concat, come from no conv and keep A). Its main loop, tiles
//    and plan are B's (a second instantiation of B's kernel per BN).
//    Design, each point measured on an H100 (chip_smoke.py
//    --compare-int8):
//    - B's staged epilogue, 4 channels of a row a thread, one 4-byte
//      store where Co and the channel offset are multiples of 4, else
//      byte stores; the passes over the staged columns kept rolled (one
//      copy of the code): unrolled, the epilogue's instruction stream
//      stalled on the instruction cache and ran at 2-3x B's time;
//    - a thread dequantizes its rows' values once, then per destination
//      (in order of LeakyReLU count) LeakyReLUs, quantizes and stores
//      them, all rows' bytes before their stores, on full-rate units
//      (packed bf16 LeakyReLU, the quotient from RN(1 / sx) by two FMA
//      steps, rint by adding 1.5 * 2^23): A's quarter-rate conversions
//      and division made the epilogue throughput-bound; the values are
//      A's bit for bit;
//    - the destinations live in shared memory, each read by a runtime
//      index, and nothing calls a function: local memory is refused
//      (phase_build), and at BN 64 (two blocks an SM, 80 registers) the
//      registers are all taken;
//    - a pixel on the border stores its copies (one pad row and/or
//      column: up to 3) after all rows' stores.

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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
// B. int8_conv (and C, its fused quantize)

// one padded int8 tensor the fused epilogue writes
struct Dest {
  int8_t* out;      // (N, dh + 2, dw + 2, cp)
  const float* sx;  // device scalar: its activation scale
  int cp, c_off;    // its channels; the first one this conv writes
  int leaky;        // LeakyReLUs before the quantize: 0, 1 or 2
  int reflect;      // the pad: reflect, else edge
};

struct ConvParams {
  const int8_t* x;     // (N, Hp, Wp, Cp), padded
  const float* scale;  // (rows,), or null: store the s32 sums
  const float* bias;   // (Co,), or null
  void* out;           // encoder (N, Ho, Wo, Co); phase (N, 2Ho, 2Wo, Co)
  int* ws;             // split K: (tiles, BM, BN) s32 sums, then a counter
                       // per tile, zeroed; null when K is not split
  int m;               // output positions per phase: N * Ho * Wo < 2^31
  int n, hp, wp, cp;
  int ho, wo;          // output grid per phase
  int co;
  int phase_form;      // 0: 4x4 stride 2; 1: 2x2 stride 1, 4 phases;
                       // 2: the 4 phases at once over 3x3 taps
  int out_dtype;       // 0 f32, 1 bf16, 2 s32
  int kt;              // taps per side: 4, 2 or 3
  int stride;          // 2 (encoder) or 1
  int kq;              // 16-byte K chunks: kt * kt * Cp / 16
  int k_tiles;         // 128-byte K tiles: ceil(kq / 8)
  int mt, nt, phases;  // tiles along M, N and the phases
  int splits, k_per_split;
  int stages;          // ring depth
  // A by TMA (Cp a multiple of 128): a tile is a box of tw x th output
  // positions of nb images, tiles_w x tiles_h x tiles_n of them
  int tma_a, tw, th, nb, tiles_w, tiles_h;
  // the fused quantize (C): destinations, compute dtype (0 f32, 1 bf16)
  // and the output grid dh x dw (< 2^15 each) they pad
  Dest dst[2];
  int ndst, cd, dh, dw;
};

constexpr int BM = 128;   // output rows a tile: two m64 halves
constexpr int BK = 128;   // bytes of K a stage: one 128-byte swizzle row
constexpr int A_BYTES = BM * BK;
constexpr int NT = 384;   // 2 consumer warpgroups, then 1 producer
constexpr int FULL_ARRIVALS = 4 + 1;    // producer warps + expect_tx
constexpr int EMPTY_ARRIVALS = 8;       // consumer warps
constexpr int SMEM_SM = 233472;         // shared memory an SM has
constexpr int SMEM_BLOCK = 1024;        // of it reserved for each block
constexpr int LAG = 2;  // stages a producer thread keeps in flight before
                        // it announces the oldest (more measured slower)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false it reads nothing and writes
// zeros (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async) made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase with this parity has completed; a wait of
// more than ~2^34 cycles (seconds) traps, so a fault ends the launch with
// an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a (BK x rows) box of the weight's tensor map into shared memory; its
// bytes complete the barrier's transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// a (128 bytes x tw x th x nb) box of x's 4-D map (Cp, Wp, Hp, N)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c, int x, int y,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y),
      "r"(b)
      : "memory");
}

// a (128 bytes x tw x 1 x th x nb) box of x's 5-D map (2 Cp, Wp / 2, 2,
// Hp / 2, N): pixel pairs and row pairs, for the stride-2 encoder
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c, int x,
                                            int py, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x),
      "r"(py), "r"(y), "r"(b)
      : "memory");
}

// the wgmma descriptor of a K-major tile with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators' registers at this point of the program, so the
// compiler moves no read or write of them across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the 256 consumer threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (barriers 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// d (+)= A (64 x 32 bytes) * B (N x 32 bytes)^T, s8 x s8 -> s32; acc 0
// ignores d. Thread t of the warpgroup holds d[4j + e] at row 16 (t / 32)
// + (t % 32) / 4 + 8 (e / 2), column 8j + 2 (t % 4) + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// one unit of work: an output tile of one phase and one K range
struct Unit {
  int m0;            // gathered A: the tile's first output position
  int b0, oh0, ow0;  // A by TMA: the box's first image, row and column
  int n0, phase, row0, k0, k1, tile;
};

template <int BN>
__device__ __forceinline__ Unit decode(const ConvParams& p, int u) {
  Unit w;
  const int ntile = u % p.nt;
  int r = u / p.nt;
  const int mtile = r % p.mt;
  r /= p.mt;
  w.phase = r % p.phases;
  const int split = r / p.phases;
  w.m0 = mtile * BM;
  const int wt = mtile % p.tiles_w, ht = (mtile / p.tiles_w) % p.tiles_h;
  w.ow0 = wt * p.tw;
  w.oh0 = ht * p.th;
  w.b0 = mtile / (p.tiles_w * p.tiles_h) * p.nb;
  w.n0 = ntile * BN;
  w.row0 = p.phases == 4 ? w.phase * p.co : 0;
  w.k0 = split * p.k_per_split;
  w.k1 = min(w.k0 + p.k_per_split, p.k_tiles);
  w.tile = (w.phase * p.mt + mtile) * p.nt + ntile;
  return w;
}

// byte offset of output position m's window corner in x (its phase's);
// M < 2^31 (the host checks), so the divisions are 32-bit
__device__ __forceinline__ int64_t row_base(const ConvParams& p, int m,
                                            int phase) {
  const int t = m / p.wo;
  const int ow = m - t * p.wo;
  const int oh = t % p.ho;
  const int b = t / p.ho;
  const bool per_phase = p.phases == 4;
  const int iy = oh * p.stride + (per_phase ? phase >> 1 : 0);
  const int ix = ow * p.stride + (per_phase ? phase & 1 : 0);
  return ((static_cast<int64_t>(b) * p.hp + iy) * p.wp + ix) * p.cp;
}

// the output position of the tile's row r, or -1 where the row holds none
__device__ __forceinline__ int row_m(const ConvParams& p, const Unit& w,
                                     int r) {
  if (!p.tma_a) {
    const int m = w.m0 + r;
    return m < p.m ? m : -1;
  }
  if (r >= p.tw * p.th * p.nb) return -1;
  const int ow = w.ow0 + r % p.tw;
  const int oh = w.oh0 + (r / p.tw) % p.th;
  const int b = w.b0 + r / (p.tw * p.th);
  if (ow >= p.wo || oh >= p.ho || b >= p.n) return -1;
  return (b * p.ho + oh) * p.wo + ow;
}

// the output element offset of row m's channel 0: its pixel, or for the
// all-phase form its base position's phase-0 pixel; -1 for no row
__device__ __forceinline__ int64_t out_row(const ConvParams& p, const Unit& w,
                                           int m) {
  if (m < 0) return -1;
  if (p.phase_form == 0) return static_cast<int64_t>(m) * p.co;
  const int t = m / p.wo;
  const int j2 = m - t * p.wo, i2 = t % p.ho, b = t / p.ho;
  const int64_t wide = 2 * static_cast<int64_t>(p.wo);
  int64_t pix = (static_cast<int64_t>(b) * 2 * p.ho + 2 * i2) * wide + 2 * j2;
  if (p.phases == 4) pix += (w.phase >> 1) * wide + (w.phase & 1);
  return pix * p.co;
}

// the fused epilogue's row: output position m's pixel (y, x) in the
// dh x dw grid (the phase form's depth-to-space pixel) and its padded
// pixel's index, packed as (y << 48) | (x << 32) | index; -1 for no row
__device__ __forceinline__ int64_t dest_row(const ConvParams& p,
                                            const Unit& w, int m) {
  if (m < 0) return -1;
  const int t = m / p.wo;
  int x = m - t * p.wo, y = t % p.ho;
  const int b = t / p.ho;
  if (p.phase_form) {
    y = 2 * y + (w.phase >> 1);
    x = 2 * x + (w.phase & 1);
  }
  const uint32_t pix = (b * (p.dh + 2) + y + 1) * (p.dw + 2) + x + 1;
  return (static_cast<int64_t>((y << 16) | x) << 32) | pix;
}

// a column of the tile: its element offset from its row's, its scale and
// bias (ofs -1 past the columns). All-phase columns are phase * Co + n.
struct Col {
  int ofs;
  float scale, bias;
};

__device__ __forceinline__ Col out_col(const ConvParams& p, const Unit& w,
                                       int col) {
  Col k{-1, 0.f, 0.f};
  int n = col, row = w.row0 + col;
  if (p.phase_form == 2) {
    if (col >= 4 * p.co) return k;
    const int ph = col / p.co;
    n = col - ph * p.co;
    row = col;
    k.ofs = ((ph >> 1) * 2 * p.wo + (ph & 1)) * p.co + n;
  } else {
    if (col >= p.co) return k;
    k.ofs = col;
  }
  if (p.scale != nullptr) k.scale = p.scale[row];
  if (p.bias != nullptr) k.bias = p.bias[n];
  return k;
}

// (float)a * scale (+ bias), each rounded: the plain version's order
__device__ __forceinline__ float dequant(const ConvParams& p, int a,
                                         const Col& k) {
  const float v = __fmul_rn(__int2float_rn(a), k.scale);
  return p.bias != nullptr ? __fadd_rn(v, k.bias) : v;
}

__device__ __forceinline__ void store_one(const ConvParams& p, int64_t idx,
                                          int a, const Col& k) {
  if (p.out_dtype == 2)
    static_cast<int*>(p.out)[idx] = a;
  else if (p.out_dtype == 0)
    static_cast<float*>(p.out)[idx] = dequant(p, a, k);
  else
    static_cast<__nv_bfloat16*>(p.out)[idx] =
        __float2bfloat16_rn(dequant(p, a, k));
}

// 4 staged sums of a row at element offset base: one 16- or 8-byte store
// where the 4 columns are consecutive channels (vec), else one by one
__device__ __forceinline__ void store4(const ConvParams& p, int64_t base,
                                       const Col (&k)[4], const int4& a,
                                       bool vec) {
  const int v[4] = {a.x, a.y, a.z, a.w};
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k[i].ofs >= 0) store_one(p, base + k[i].ofs, v[i], k[i]);
    return;
  }
  const int64_t idx = base + k[0].ofs;
  if (p.out_dtype == 2) {
    *reinterpret_cast<int4*>(static_cast<int*>(p.out) + idx) = a;
  } else if (p.out_dtype == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + idx) =
        make_float4(dequant(p, v[0], k[0]), dequant(p, v[1], k[1]),
                    dequant(p, v[2], k[2]), dequant(p, v[3], k[3]));
  } else {
    const __nv_bfloat162 lo =
        __halves2bfloat162(__float2bfloat16_rn(dequant(p, v[0], k[0])),
                           __float2bfloat16_rn(dequant(p, v[1], k[1])));
    const __nv_bfloat162 hi =
        __halves2bfloat162(__float2bfloat16_rn(dequant(p, v[2], k[2])),
                           __float2bfloat16_rn(dequant(p, v[3], k[3])));
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + idx) = u;
  }
}

// C's arithmetic. Each step is bit for bit A's (quantize_pad's) on the
// same value, on full-rate units where A's are quarter-rate (bf16
// rounding of every LeakyReLU, rintf, the float -> int cast, the
// division's reciprocal), and with no call: __fdiv_rn's and
// __frcp_rn's slow paths are calls, which give the kernel a stack frame.

// LeakyReLU as max(v, v * slope): for v < 0 the rounded product lies in
// [v, 0], for v >= 0 in [0, v], so max picks leaky()'s branch (signed
// zeros included); bf16 pairs by one packed multiply (the product of
// two bf16 values rounded once) and one packed max
__device__ __forceinline__ __nv_bfloat162 leaky2(__nv_bfloat162 h) {
  return __hmax2(h, __hmul2(h, __float2bfloat162_rn(0.2001953125f)));
}

__device__ __forceinline__ float leaky_f32(float v) {
  return fmaxf(v, __fmul_rn(v, 0.2f));
}

// RN(a / b), __fdiv_rn's value, with no call: the quotient in double
// from the hardware's approximate reciprocal, two Newton steps and one
// remainder step (relative error near double's 2^-53); a quotient of two
// floats is never a float rounding midpoint and lies at least 2^-49
// (relative) from one, so its rounding to float is RN(a / b). A zero or
// infinite b, or a non-finite a, takes the product with 1 / b's exact
// value (inf, 0, or +-1), as the division gives.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (b == 0.f || isinf(b) || !isfinite(a))
    return __fmul_rn(a, copysignf(b == 0.f    ? __int_as_float(0x7f800000)
                                  : isinf(b) ? 0.f
                                             : 1.f,
                                  b));
  const double bd = b, ad = a;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
  y = __fma_rn(y, __fma_rn(-bd, y, 1.0), y);
  y = __fma_rn(y, __fma_rn(-bd, y, 1.0), y);
  double q = __dmul_rn(ad, y);
  q = __fma_rn(__fma_rn(-bd, q, ad), y, q);
  return __double2float_rn(q);
}

// quantize() with div_rn, in the low byte
__device__ __forceinline__ uint32_t quantize_exact(float v, float sx) {
  const float q = fminf(fmaxf(rintf(div_rn(v, sx)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q));
}

// clip(rint(v / sx), -127, 127) in the low byte, for sx in [2^-96,
// 2^96] (no remainder falls below float's normal range where a quotient
// nears a rounding boundary) and y = RN(1 / sx): the quotient by two FMA
// corrections of v * y (the first makes it faithful, the second, by
// Markstein's theorem, correctly rounded: __fdiv_rn's value), or v * y
// itself where that is past +-256 (the result saturates either way);
// rint by adding 1.5 * 2^23 (the sum's last bit is the integer, rounded
// half to even)
__device__ __forceinline__ uint32_t quantize_fast(float v, float sx,
                                                  float y) {
  const float q0 = __fmul_rn(v, y);
  float r = __fmaf_rn(-sx, q0, v);
  const float q1 = __fmaf_rn(r, y, q0);
  r = __fmaf_rn(-sx, q1, v);
  float q = fabsf(q0) < 256.f ? __fmaf_rn(r, y, q1) : q0;
  q = fminf(fmaxf(q, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

__device__ __forceinline__ bool quantize_fast_ok(float sx) {
  return sx >= 0x1p-96f && sx <= 0x1p96f;
}

// the low bytes of b[0..3] as one word, b[0] lowest
__device__ __forceinline__ uint32_t pack_bytes(const uint32_t (&b)[4]) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// BM x BN output tiles: consumer warpgroup wg multiplies rows 64 wg ..
// 64 wg + 63 (one m64 half, BN / 2 accumulators a thread)
// blocks an SM holds: 2 where the accumulators are few (BN <= 64), so one
// block's epilogue and barrier waits overlap the other's products
template <int BN>
__host__ __device__ constexpr int blocks_per_sm() {
  return BN <= 64 ? 2 : 1;
}

// columns an epilogue pass stages (64 rows a warpgroup)
template <int BN>
__host__ __device__ constexpr int staged_cols() {
  return BN < 16 ? BN : blocks_per_sm<BN>() == 2 ? 16 : 64;
}

// a destination as C's epilogue reads it: from shared memory, filled
// once a block (a runtime index into the kernel's parameters would copy
// them to local memory)
struct DestInfo {
  int8_t* out;
  float sx, y;  // the scale and RN(1 / sx)
  int cp, c_off, leaky, reflect;
};

// 4 quantized channels (word's bytes) from channel n0 on at padded pixel
// pix of a destination: one 4-byte store where they are consecutive and
// 4-byte aligned there (vec), else a byte each for the nv (< 4) that
// exist
__device__ __forceinline__ void put4(const DestInfo& D, int pix, int n0,
                                     int nv, uint32_t word, bool vec) {
  int8_t* dst = D.out + static_cast<int64_t>(pix) * D.cp + D.c_off + n0;
  if (vec) {
    *reinterpret_cast<uint32_t*>(dst) = word;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < nv) dst[i] = static_cast<int8_t>(word >> (8 * i));
}

// the NR rows' values (4 f32 each) quantized into words, one a row
template <int NR>
__device__ __forceinline__ void quantize_rows(const float (&t)[NR][4],
                                              float sx, float y,
                                              uint32_t (&words)[NR]) {
  uint32_t b[4];
  if (quantize_fast_ok(sx)) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = quantize_fast(t[i][e], sx, y);
      words[i] = pack_bytes(b);
    }
  } else {
    // one value at a time: its double temporaries, not all the rows',
    // take registers (this path is not taken with the scales
    // quantize_mnet makes)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      uint32_t word = 0;
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const float v = e == 0   ? t[i][0]
                        : e == 1 ? t[i][1]
                        : e == 2 ? t[i][2]
                                 : t[i][3];
        word |= (quantize_exact(v, sx) & 0xffu) << (8 * e);
      }
      words[i] = word;
    }
  }
}

// the rows' values in the compute dtype (BF16: bf16 pairs h, else f32
// t) LeakyReLU'd n more times, then (BF16) unpacked into t
template <bool BF16, int NR>
__device__ __forceinline__ void leaky_rows(__nv_bfloat162 (&h)[NR][2],
                                           float (&t)[NR][4], int n) {
  for (int l = 0; l < n; ++l) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if constexpr (BF16) {
        h[i][0] = leaky2(h[i][0]);
        h[i][1] = leaky2(h[i][1]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][e] = leaky_f32(t[i][e]);
      }
    }
  }
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      t[i][0] = __low2float(h[i][0]);
      t[i][1] = __high2float(h[i][0]);
      t[i][2] = __low2float(h[i][1]);
      t[i][3] = __high2float(h[i][1]);
    }
  }
}

// one destination's stores of the thread's NR rows, then, for the rows
// on the border, the pad ring's copies
template <int NR>
__device__ __forceinline__ void store_rows(const ConvParams& p,
                                           const DestInfo& D,
                                           const int64_t (&orow)[NR], int n0,
                                           const uint32_t (&words)[NR]) {
  const bool vec = (p.co & 3) == 0 && (D.c_off & 3) == 0;
  const int nv = p.co - n0;
#pragma unroll
  for (int i = 0; i < NR; ++i)
    if (orow[i] >= 0)
      put4(D, static_cast<int>(orow[i] & 0xffffffff), n0, nv, words[i],
           vec);
  const int lo = D.reflect ? 1 : 0, wp = p.dw + 2;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (orow[i] < 0) continue;
    const int pix = static_cast<int>(orow[i] & 0xffffffff);
    const int y = static_cast<int>(orow[i] >> 48);
    const int x = static_cast<int>((orow[i] >> 32) & 0xffff);
    // the pad rows and columns that read this pixel: row -1 (edge: from
    // row 0; reflect: from row 1) and row dh (from dh - 1; dh - 2), as
    // offsets from it; 0 where none does
    const int ylo = y == lo ? -(y + 1) : 0;
    const int yhi = y == p.dh - 1 - lo ? p.dh - y : 0;
    const int xlo = x == lo ? -(x + 1) : 0;
    const int xhi = x == p.dw - 1 - lo ? p.dw - x : 0;
    if ((ylo | yhi | xlo | xhi) == 0) continue;
    if ((ylo == 0 || yhi == 0) && (xlo == 0 || xhi == 0)) {
      // one pad row and/or one pad column: at most 3 copies
      const int oy = ylo + yhi, ox = xlo + xhi;
      if (oy != 0) put4(D, pix + oy * wp, n0, nv, words[i], vec);
      if (ox != 0) put4(D, pix + ox, n0, nv, words[i], vec);
      if (oy != 0 && ox != 0)
        put4(D, pix + oy * wp + ox, n0, nv, words[i], vec);
      continue;
    }
    // both pad rows or both pad columns read it (a grid of 1 to 3)
#pragma unroll 1
    for (int j = 1; j < 9; ++j) {  // (row, column) copies but (0, 0)
      const int r = j / 3, c = j - 3 * (j / 3);
      const int oy = r == 0 ? 0 : r == 1 ? ylo : yhi;
      const int ox = c == 0 ? 0 : c == 1 ? xlo : xhi;
      if ((r == 0 || oy != 0) && (c == 0 || ox != 0))
        put4(D, pix + oy * wp + ox, n0, nv, words[i], vec);
    }
  }
}

// one pass of C's epilogue for the thread's NR rows (dest_row's packed
// rows) of 4 staged sums, columns k: each value dequantized and rounded
// to the compute dtype once, then, destination by destination (the host
// orders them by LeakyReLU count), LeakyReLU'd up to its count,
// quantized and stored. All rows' bytes are computed before their first
// store, so the rows' chains overlap (a branch would part them).
template <bool BF16, int NR>
__device__ __forceinline__ void quantize_pass(const ConvParams& p,
                                              const DestInfo* info,
                                              const int64_t (&orow)[NR],
                                              const Col (&k)[4],
                                              const int4 (&sums)[NR]) {
  __nv_bfloat162 h[NR][2];
  float t[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int acc[4] = {sums[i].x, sums[i].y, sums[i].z, sums[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = dequant(p, acc[e], k[e]);
    if constexpr (BF16) {
      h[i][0] = __floats2bfloat162_rn(t[i][0], t[i][1]);
      h[i][1] = __floats2bfloat162_rn(t[i][2], t[i][3]);
    }
  }
  uint32_t words[NR];
  const int n0 = k[0].ofs;
  int done = 0;
#pragma unroll 1
  for (int d = 0; d < p.ndst; ++d) {
    const DestInfo& D = info[d];
    leaky_rows<BF16>(h, t, D.leaky - done);
    done = D.leaky;
    quantize_rows(t, D.sx, D.y, words);
    store_rows(p, D, orow, n0, words);
  }
}

// one pass (c) of C's epilogue: B's staging of the pass's accumulators
// (picked by a constant index: c is one where the passes are unrolled,
// else each candidate is tested), then quantize_pass
template <int BN, int R, int NR>
__device__ __forceinline__ void fused_pass(const ConvParams& p, const Unit& w,
                                           int c, const int (&acc)[R],
                                           int* st, const DestInfo* info,
                                           const int64_t (&orow)[NR], int wg,
                                           int lr0, int cg, int lrow,
                                           int wcol) {
  constexpr int CC = staged_cols<BN>();
  constexpr int SWZ = (CC / 4 < 8 ? CC / 4 : 8) - 1;
  constexpr int RSTEP = 64 / NR;
#pragma unroll
  for (int cc = 0; cc < BN / CC; ++cc) {
    if (cc != c) continue;
#pragma unroll
    for (int jj = 0; jj < CC / 8; ++jj) {
      const int jb = cc * (CC / 8) + jj, col = 8 * jj + wcol;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lrow + 8 * hr;
        *reinterpret_cast<int2*>(st + r * CC +
                                 (((col >> 2) ^ (r & SWZ)) << 2) +
                                 (col & 3)) =
            make_int2(acc[4 * jb + 2 * hr], acc[4 * jb + 2 * hr + 1]);
      }
    }
  }
  Col k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) k[i] = out_col(p, w, w.n0 + c * CC + cg + i);
  warpgroup_sync(wg);
  if (k[0].ofs >= 0) {
    int4 sums[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int lr = lr0 + RSTEP * i;
      sums[i] = *reinterpret_cast<const int4*>(
          st + lr * CC + (((cg >> 2) ^ (lr & SWZ)) << 2));
    }
    if (p.cd)
      quantize_pass<true>(p, info, orow, k, sums);
    else
      quantize_pass<false>(p, info, orow, k, sums);
  }
  warpgroup_sync(wg);
}

// C's epilogue of a unit: B's staging, CC columns a pass, the passes
// kept rolled (one copy of the code: unrolled, the passes' rows made an
// instruction stream that stalled on the instruction cache)
template <int BN, int R>
__device__ __forceinline__ void fused_epilogue(const ConvParams& p,
                                               const Unit& w,
                                               const int (&acc)[R], int* st,
                                               const DestInfo* info, int wg,
                                               int wtid, int lrow,
                                               int wcol) {
  constexpr int CC = staged_cols<BN>();
  constexpr int GPR = CC / 4, RSTEP = 128 / GPR, NR = 64 / RSTEP;
  const int cg = 4 * (wtid % GPR), lr0 = wtid / GPR;
  int64_t orow[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i)
    orow[i] = dest_row(p, w, row_m(p, w, wg * 64 + lr0 + RSTEP * i));
#pragma unroll 1
  for (int c = 0; c < BN / CC; ++c)
    fused_pass<BN>(p, w, c, acc, st, info, orow, wg, lr0, cg, lrow, wcol);
}

// FUSED: C's epilogue (fused_epilogue) in place of B's
template <int BN, bool FUSED>
__global__ void __launch_bounds__(NT, blocks_per_sm<BN>())
    int8_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const ConvParams p) {
  constexpr int B_BYTES = BN * BK;
  constexpr int R = BN / 2;     // accumulators a thread
  constexpr int ROWS = BM / 16; // A rows a producer thread copies
  // an epilogue pass stages CC columns of 64 rows a warpgroup, 16-byte
  // groups of a row XOR-swizzled by the row (no bank conflicts)
  constexpr int CC = staged_cols<BN>();
  constexpr int SWZ = (CC / 4 < 8 ? CC / 4 : 8) - 1;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle's address pattern needs 1024-byte aligned tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int S = p.stages;
  const uint32_t a_st = base;
  const uint32_t b_st = base + S * A_BYTES;
  const uint32_t bars = b_st + S * B_BYTES;  // S full, then S empty
  uint8_t* const bars_ptr = smem_raw + (bars - raw);
  volatile int* last_flag = reinterpret_cast<volatile int*>(bars_ptr + 16 * S);
  // the epilogue's staging: 64 rows x CC words per consumer warpgroup
  int* const staged = reinterpret_cast<int*>(bars_ptr + 16 * S + 16);
  // C: its destinations, after the staging
  DestInfo* const info = reinterpret_cast<DestInfo*>(staged + 2 * 64 * CC);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, p.tma_a ? 1 : FULL_ARRIVALS);
      mbar_init(bars + 8 * (S + s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (FUSED) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const Dest& D = p.dst[d];
        if (d < p.ndst)
          info[d] = DestInfo{D.out,   *D.sx,   div_rn(1.f, *D.sx),
                             D.cp,    D.c_off, D.leaky,
                             D.reflect};
      }
    }
  }
  __syncthreads();
  const int units = p.mt * p.nt * p.phases * p.splits;

  if (tid >= 256 && p.tma_a) {
    // producer, A by TMA: one thread issues each stage's A box and weight
    // tile; their bytes complete the stage's barrier
    if (tid != 256) return;
    int s = 0;
    uint32_t round = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = decode<BN>(p, u);
      const int pr = p.phases == 4 ? w.phase >> 1 : 0;
      const int pc = p.phases == 4 ? w.phase & 1 : 0;
      for (int kt = w.k0; kt < w.k1; ++kt) {
        mbar_wait(bars + 8 * (S + s), (round & 1) ^ 1);
        const uint32_t bar = bars + 8 * s;
        mbar_arrive_expect_tx(bar, p.tw * p.th * p.nb * BK + B_BYTES);
        // K bytes kt * BK on: 128 channels of one tap, or (Cp 64, the
        // encoder) taps dx and dx + 1 of one pixel pair
        const int tap = kt * BK / p.cp, c = kt * BK - tap * p.cp;
        const int dy = tap / p.kt, dx = tap - dy * p.kt;
        if (p.phase_form)
          tma_load_4d(a_st + s * A_BYTES, &xmap, bar, c, w.ow0 + pc + dx,
                      w.oh0 + pr + dy, w.b0);
        else
          tma_load_5d(a_st + s * A_BYTES, &xmap, bar, c + (dx & 1) * p.cp,
                      w.ow0 + (dx >> 1), dy & 1, w.oh0 + (dy >> 1), w.b0);
        tma_load_2d(b_st + s * B_BYTES, &wmap, bar, kt * BK, w.row0 + w.n0);
        if (++s == S) {
          s = 0;
          ++round;
        }
      }
    }
    return;
  }

  if (tid >= 256) {
    // producer: thread pt copies 16-byte chunk j of rows r0 + 16 i of
    // each A tile (a warp reads 4 rows x 128 contiguous bytes where a K
    // tile lies in one tap); thread 0 also issues the weight tile's TMA.
    // It announces a stage once its copies of it have landed, LAG
    // stages behind the newest.
    const int pt = tid - 256, j = pt & 7, r0 = pt >> 3, lane = tid & 31;
    const uint32_t a_row = r0 * BK + ((j ^ (r0 & 7)) << 4);  // swizzled
    const int cpc = p.cp >> 4;
    int s = 0, issued = 0;
    uint32_t round = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = decode<BN>(p, u);
      int64_t rb[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int m = w.m0 + r0 + 16 * i;
        rb[i] = m < p.m ? row_base(p, m, w.phase) : -1;
      }
      for (int kt = w.k0; kt < w.k1; ++kt) {
        mbar_wait(bars + 8 * (S + s), (round & 1) ^ 1);
        if (pt == 0) {
          mbar_arrive_expect_tx(bars + 8 * s, B_BYTES);
          tma_load_2d(b_st + s * B_BYTES, &wmap, bars + 8 * s, kt * BK,
                      w.row0 + w.n0);
        }
        // chunk q of the flattened (tap, channel) K axis
        const int q = kt * (BK / 16) + j;
        const bool kok = q < p.kq;
        int64_t koff = 0;
        if (kok) {
          const int tap = q / cpc;
          const int dy = tap / p.kt, dx = tap - dy * p.kt;
          koff = (static_cast<int64_t>(dy) * p.wp + dx) * p.cp +
                 (q - tap * cpc) * 16;
        }
        const uint32_t dst = a_st + s * A_BYTES + a_row;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const bool ok = kok && rb[i] >= 0;
          cp_async16(dst + i * 16 * BK, ok ? p.x + rb[i] + koff : p.x, ok);
        }
        cp_async_commit();
        if (issued >= LAG) {  // the stage LAG back has landed
          cp_async_wait<LAG>();
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * ((s + S - LAG) % S));
        }
        ++issued;
        if (++s == S) {
          s = 0;
          ++round;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncwarp();
    if (lane == 0)
      for (int i = min(issued, LAG); i > 0; --i)
        mbar_arrive(bars + 8 * ((s + S - i) % S));
    return;
  }

  // consumers: thread holds acc[4 jb + e] = row lrow + 8 (e / 2) of its
  // warpgroup's 64, column 8 jb + wcol + e % 2
  const int wg = tid >> 7, lane = tid & 31, wtid = tid & 127;
  const int lrow = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int wcol = 2 * (lane & 3);
  int* const st = staged + wg * 64 * CC;
  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  int s = 0;
  uint32_t round = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = decode<BN>(p, u);
    int prev = -1;
    for (int kt = w.k0; kt < w.k1; ++kt) {
      mbar_wait(bars + 8 * s, round & 1);
      const uint32_t a = a_st + s * A_BYTES + wg * 64 * BK;
      const uint32_t b = b_st + s * B_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma<BN>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                       (kt > w.k0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (S + prev));
      }
      prev = s;
      if (++s == S) {
        s = 0;
        ++round;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + prev));

    if (p.splits > 1) {
      // add this split's sums; the tile's last split stores them all
      int* part = p.ws + static_cast<int64_t>(w.tile) * BM * BN +
                  (wg * 64 + lrow) * BN + wcol;
#pragma unroll
      for (int i = 0; i < R; ++i)
        atomicAdd(part + 8 * ((i >> 1) & 1) * BN + 8 * (i >> 2) + (i & 1),
                  acc[i]);
      __threadfence();
      consumer_sync();
      if (tid == 0) {
        int* counts = p.ws + static_cast<int64_t>(p.mt) * p.nt * p.phases *
                                 BM * BN;
        *last_flag = atomicAdd(counts + w.tile, 1) == p.splits - 1;
      }
      consumer_sync();
      if (!*last_flag) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < R; ++i)
        acc[i] = __ldcg(part + 8 * ((i >> 1) & 1) * BN + 8 * (i >> 2) +
                        (i & 1));
    }

    if constexpr (FUSED) {
      fused_epilogue<BN>(p, w, acc, st, info, wg, wtid, lrow, wcol);
      continue;
    }

    // epilogue, CC columns a pass: the warpgroup stages its 64 rows in
    // shared memory, then each thread stores columns cg .. cg + 3 of its
    // rows lr0 + RSTEP i at once; row offsets, scales and biases are
    // found once (a unit, a pass), not at every store
    constexpr int GPR = CC / 4, RSTEP = 128 / GPR, NR = 64 / RSTEP;
    const int cg = 4 * (wtid % GPR), lr0 = wtid / GPR;
    int64_t orow[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      orow[i] = out_row(p, w, row_m(p, w, wg * 64 + lr0 + RSTEP * i));
    const bool vec = p.phase_form != 2 && (p.co & 3) == 0;
#pragma unroll
    for (int c = 0; c < BN / CC; ++c) {
#pragma unroll
      for (int jj = 0; jj < CC / 8; ++jj) {
        const int jb = c * (CC / 8) + jj, col = 8 * jj + wcol;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = lrow + 8 * hr;
          *reinterpret_cast<int2*>(st + r * CC +
                                   (((col >> 2) ^ (r & SWZ)) << 2) +
                                   (col & 3)) =
              make_int2(acc[4 * jb + 2 * hr], acc[4 * jb + 2 * hr + 1]);
        }
      }
      Col k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = out_col(p, w, w.n0 + c * CC + cg + i);
      warpgroup_sync(wg);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int lr = lr0 + RSTEP * i;
        if (orow[i] >= 0 && k[0].ofs >= 0)
          store4(p, orow[i], k,
                 *reinterpret_cast<const int4*>(
                     st + lr * CC + (((cg >> 2) ^ (lr & SWZ)) << 2)),
                 vec);
      }
      warpgroup_sync(wg);
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// the launch's shape: tile, splits of K, ring depth, workspace
struct Plan {
  int bm, bn, cc, taps, mt, nt, phases, k_tiles, splits, k_per_split,
      stages, grid;
  int tma_a, tw, th, nb, tiles_w, tiles_h;
  int64_t ws_words;
};

Plan make_plan(int n, int cp, int ho, int wo, int co, int phase_form,
               int sms, bool split_ok) {
  Plan q{};
  // N: up to 64 columns one tile as narrow as covers them (so A is
  // gathered once; wgmma's N is 8 at the least), past that the widest
  // tile the columns fill; the all-phase form's columns are the 4 phases'
  // 4 Co.
  const int cols = phase_form == 2 ? 4 * co : co;
  q.bn = cols >= 128                   ? 128
         : cols > 32                   ? 64
         : cols > 16                   ? 32
         : cols > 8                    ? 16
                                       : 8;
  q.bm = BM;
  const int64_t m = static_cast<int64_t>(n) * ho * wo;
  const int kt = phase_form == 0 ? 4 : phase_form == 1 ? 2 : 3;
  q.taps = kt * kt;
  // A by TMA where a K tile is 128 channels of one tap, or in the
  // encoder's pixel pairs 64 channels of two taps: a box of tw x th
  // output positions (x nb images where one image is smaller), the shape
  // that fills the most of the 128 rows
  q.tma_a = cp % BK == 0 || (phase_form == 0 && cp == BK / 2);
  if (q.tma_a) {
    int best = 0;
    const int first = (wo + BM - 1) / BM;
    for (int tiles = first; tiles <= first + 4; ++tiles) {
      const int tw = (wo + tiles - 1) / tiles, th = std::min(ho, BM / tw);
      if (tw * th > best) {
        best = tw * th;
        q.tw = tw;
        q.th = th;
      }
    }
    q.nb = q.tw == wo && q.th == ho ? std::max(1, std::min(n, BM / (wo * ho)))
                                    : 1;
    q.tiles_w = (wo + q.tw - 1) / q.tw;
    q.tiles_h = (ho + q.th - 1) / q.th;
    q.mt = q.tiles_w * q.tiles_h * ((n + q.nb - 1) / q.nb);
  } else {
    q.tw = q.th = q.nb = q.tiles_w = q.tiles_h = 1;
    q.mt = static_cast<int>((m + q.bm - 1) / q.bm);
  }
  q.nt = (cols + q.bn - 1) / q.bn;
  q.phases = phase_form == 1 ? 4 : 1;
  q.k_tiles = (kt * kt * cp + BK - 1) / BK;
  const int64_t tiles = static_cast<int64_t>(q.mt) * q.nt * q.phases;
  q.splits = 1;
  if (split_ok && tiles < sms)  // about one unit per SM, 2+ K tiles each
    q.splits = static_cast<int>(
        std::max<int64_t>(1, std::min<int64_t>(sms / tiles, q.k_tiles / 2)));
  q.k_per_split = (q.k_tiles + q.splits - 1) / q.splits;
  q.splits = (q.k_tiles + q.k_per_split - 1) / q.k_per_split;
  const int per_sm = q.bn <= 64 ? 2 : 1;  // blocks_per_sm<BN>()
  q.cc = q.bn < 16 ? q.bn : per_sm == 2 ? 16 : 64;  // staged_cols<BN>()
  const int room = SMEM_SM / per_sm - SMEM_BLOCK - 1024 - 16 * 8 - 16 -
                   2 * 64 * q.cc * 4;
  q.stages = std::min(8, room / ((BM + q.bn) * BK));
  q.grid = static_cast<int>(
      std::min<int64_t>(tiles * q.splits, static_cast<int64_t>(sms) * per_sm));
  q.ws_words = q.splits > 1 ? tiles * q.bm * q.bn + tiles : 0;
  return q;
}

// ring, barriers, flag, then the epilogue's staging (2 x 64 rows)
size_t smem_bytes(const Plan& q) {
  return 1024 + static_cast<size_t>(q.stages) * (BM + q.bn) * BK +
         16 * q.stages + 16 + 2 * 64 * q.cc * 4;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

int status(cudaError_t e) { return static_cast<int>(e); }

// the argument rules of srit_int8_conv
bool conv_args_ok(int n, int hp, int wp, int cp, int ho, int wo, int co,
                  int phase_form) {
  if (cp % 16 || cp < 16 || n < 1 || ho < 1 || wo < 1 || co < 1 ||
      phase_form < 0 || phase_form > 2 ||
      static_cast<int64_t>(n) * ho * wo > INT32_MAX)
    return false;
  return phase_form ? hp == ho + 2 && wp == wo + 2
                    : hp == 2 * ho + 2 && wp == 2 * wo + 2;
}

template <int BN, bool FUSED>
cudaError_t launch_tile(const CUtensorMap& map, const CUtensorMap& xmap,
                        const ConvParams& p, const Plan& q,
                        cudaStream_t s) {
  // C keeps its destinations after the staging
  const size_t smem = smem_bytes(q) + (FUSED ? 2 * sizeof(DestInfo) : 0);
  cudaError_t e = cudaFuncSetAttribute(
      int8_conv_kernel<BN, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int8_conv_kernel<BN, FUSED><<<q.grid, NT, smem, s>>>(map, xmap, p);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t launch_bn(const CUtensorMap& map, const CUtensorMap& xmap,
                      const ConvParams& p, const Plan& q, cudaStream_t s) {
  switch (q.bn) {
    case 128: return launch_tile<128, FUSED>(map, xmap, p, q, s);
    case 64: return launch_tile<64, FUSED>(map, xmap, p, q, s);
    case 32: return launch_tile<32, FUSED>(map, xmap, p, q, s);
    case 16: return launch_tile<16, FUSED>(map, xmap, p, q, s);
    default: return launch_tile<8, FUSED>(map, xmap, p, q, s);
  }
}

// the fused quantize's destinations (C), or none (B)
struct Fused {
  int ndst, cd;
  Dest dst[2];
};

// the argument rules of srit_int8_conv_quantized's destinations for an
// output grid dh x dw of co channels
bool fused_args_ok(const Fused& f, int n, int dh, int dw, int co) {
  if (f.ndst < 1 || f.ndst > 2 || (f.cd != 0 && f.cd != 1) || dh >= 32768 ||
      dw >= 32768 ||
      static_cast<int64_t>(n) * (dh + 2) * (dw + 2) > INT32_MAX)
    return false;
  for (int d = 0; d < f.ndst; ++d) {
    const Dest& D = f.dst[d];
    if (D.out == nullptr || D.sx == nullptr || D.cp % 16 || D.c_off < 0 ||
        D.c_off + co > D.cp || D.leaky < 0 || D.leaky > 2 ||
        !aligned16(D.out) || (D.reflect && (dh < 2 || dw < 2)))
      return false;
  }
  return true;
}

int conv_launch(const void* x, const void* wk, const void* scale,
                const void* bias, void* out, int out_dtype, int n, int hp,
                int wp, int cp, int ho, int wo, int co, int phase_form,
                void* ws, int64_t ws_words, void* stream,
                const Fused* fused = nullptr) {
  const bool raw = out_dtype == 2;
  if (!conv_args_ok(n, hp, wp, cp, ho, wo, co, phase_form) ||
      !aligned16(x) || !aligned16(wk))
    return status(cudaErrorInvalidValue);
  if (fused != nullptr
          ? phase_form == 2 || scale == nullptr ||
                !fused_args_ok(*fused, n, phase_form ? 2 * ho : ho,
                               phase_form ? 2 * wo : wo, co)
          : out_dtype < 0 || out_dtype > 2 || raw != (scale == nullptr) ||
                (raw && bias != nullptr))
    return status(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return status(e);
  const Plan q = make_plan(n, cp, ho, wo, co, phase_form, sms, ws != nullptr);
  if (q.splits > 1 && ws_words < q.ws_words)
    return status(cudaErrorInvalidValue);
  const int kt = phase_form == 0 ? 4 : phase_form == 1 ? 2 : 3;
  const int rows = phase_form ? 4 * co : co;
  const int ktot = kt * kt * cp;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return status(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ktot),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ktot)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(q.bn)};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wk),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return status(cudaErrorInvalidValue);
  CUtensorMap xmap = map;  // unread where A is gathered
  if (q.tma_a) {
    const cuuint64_t c = cp;
    bool ok;
    if (phase_form) {  // (Cp, Wp, Hp, N)
      const cuuint64_t xdims[4] = {c, static_cast<cuuint64_t>(wp),
                                   static_cast<cuuint64_t>(hp),
                                   static_cast<cuuint64_t>(n)};
      const cuuint64_t xstrides[3] = {c, c * wp, c * wp * hp};
      const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(BK),
                                  static_cast<cuuint32_t>(q.tw),
                                  static_cast<cuuint32_t>(q.th),
                                  static_cast<cuuint32_t>(q.nb)};
      const cuuint32_t ones[4] = {1, 1, 1, 1};
      ok = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                  const_cast<void*>(x), xdims, xstrides, xbox, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    } else {  // (2 Cp, Wp / 2, 2, Hp / 2, N): pixel pairs, row pairs
      const cuuint64_t xdims[5] = {2 * c, static_cast<cuuint64_t>(wp / 2), 2,
                                   static_cast<cuuint64_t>(hp / 2),
                                   static_cast<cuuint64_t>(n)};
      const cuuint64_t xstrides[4] = {2 * c, c * wp, 2 * c * wp, c * wp * hp};
      const cuuint32_t xbox[5] = {static_cast<cuuint32_t>(BK),
                                  static_cast<cuuint32_t>(q.tw), 1,
                                  static_cast<cuuint32_t>(q.th),
                                  static_cast<cuuint32_t>(q.nb)};
      const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
      ok = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5,
                  const_cast<void*>(x), xdims, xstrides, xbox, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    }
    if (!ok) return status(cudaErrorInvalidValue);
  }
  ConvParams p{};
  p.x = static_cast<const int8_t*>(x);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = q.splits > 1 ? static_cast<int*>(ws) : nullptr;
  p.m = static_cast<int>(static_cast<int64_t>(n) * ho * wo);
  p.n = n;
  p.hp = hp;
  p.wp = wp;
  p.cp = cp;
  p.ho = ho;
  p.wo = wo;
  p.co = co;
  p.phase_form = phase_form;
  p.out_dtype = out_dtype;
  p.kt = kt;
  p.stride = phase_form ? 1 : 2;
  p.kq = ktot / 16;
  p.k_tiles = q.k_tiles;
  p.mt = q.mt;
  p.nt = q.nt;
  p.phases = q.phases;
  p.splits = q.splits;
  p.k_per_split = q.k_per_split;
  p.stages = q.stages;
  p.tma_a = q.tma_a;
  p.tw = q.tw;
  p.th = q.th;
  p.nb = q.nb;
  p.tiles_w = q.tiles_w;
  p.tiles_h = q.tiles_h;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused == nullptr) return status(launch_bn<false>(map, xmap, p, q, s));
  p.dst[0] = fused->dst[0];
  p.dst[1] = fused->dst[1];
  p.ndst = fused->ndst;
  p.cd = fused->cd;
  p.dh = phase_form ? 2 * ho : ho;
  p.dw = phase_form ? 2 * wo : wo;
  return status(launch_bn<true>(map, xmap, p, q, s));
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
// depth-to-space order), or kt 3 (phase_form 2: phase_form 1's conv with
// the 4 phases' 2x2 kernels placed in one 3x3 window, row p * co + n
// holding phase p = (pr, pc)'s taps at (pr + di, pc + dj), zero elsewhere);
// cp a multiple of 16, x and wk 16-byte aligned.
// scale (rows,) f32 and bias (co,) f32 or null; out_dtype 0 f32, 1 bf16,
// 2 s32 (then scale and bias must be null). K is not split. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for arguments outside these
// rules, launching nothing). Launches on `stream`, does not synchronise.
extern "C" int srit_int8_conv(const void* x, const void* wk,
                              const void* scale, const void* bias, void* out,
                              int out_dtype, int n, int hp, int wp, int cp,
                              int ho, int wo, int co, int phase_form,
                              void* stream) {
  return conv_launch(x, wk, scale, bias, out, out_dtype, n, hp, wp, cp, ho,
                     wo, co, phase_form, nullptr, 0, stream);
}

// srit_int8_conv with K split as srit_int8_conv_plan says, over ws: at
// least the plan's ws_words int32 words on the device, zeroed (the kernel
// leaves them dirty). One launch.
extern "C" int srit_int8_conv_split(const void* x, const void* wk,
                                    const void* scale, const void* bias,
                                    void* out, int out_dtype, int n, int hp,
                                    int wp, int cp, int ho, int wo, int co,
                                    int phase_form, void* ws,
                                    long long ws_words, void* stream) {
  if (ws == nullptr) return status(cudaErrorInvalidValue);
  return conv_launch(x, wk, scale, bias, out, out_dtype, n, hp, wp, cp, ho,
                     wo, co, phase_form, ws, ws_words, stream);
}

// int8_conv_quantized (C): srit_int8_conv_split's conv, phase_form 0 or 1
// and a scale (bias optional), whose epilogue writes in place of an
// output ndst (1 or 2) padded int8 tensors. Destination d is outs[d], an
// int8 (N, dh + 2, dw + 2, meta[4 d]) tensor, 16-byte aligned, with
// (dh, dw) the output grid ((ho, wo), or (2 ho, 2 wo) for the phase form;
// each < 2^15, N (dh + 2) (dw + 2) < 2^31) and meta[4 d] a multiple of 16;
// its channels meta[4 d + 1] .. meta[4 d + 1] + co - 1 (within meta[4 d])
// are written at every pixel and the pad ring (reflect where
// meta[4 d + 3], else edge; reflect needs dh, dw >= 2) with
// clip(rint(leaky^k(v) / *sxs[d]), -127, 127): v the dequantized value
// rounded to the compute dtype cd (0 f32, 1 bf16), k = meta[4 d + 2] in
// 0..2 LeakyReLUs in that dtype, sxs[d] a device float. Its other
// channels are not written. ws as srit_int8_conv_split's, or null where
// the plan does not split K. One launch; returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments outside these rules,
// launching nothing). Launches on `stream`, does not synchronise.
extern "C" int srit_int8_conv_quantized(
    const void* x, const void* wk, const void* scale, const void* bias, int cd,
    int n, int hp, int wp, int cp, int ho, int wo, int co, int phase_form,
    int ndst, void* const* outs, const void* const* sxs, const int* meta,
    void* ws, long long ws_words, void* stream) {
  if (outs == nullptr || sxs == nullptr || meta == nullptr || ndst < 1 ||
      ndst > 2)
    return status(cudaErrorInvalidValue);
  Fused f{};
  f.ndst = ndst;
  f.cd = cd;
  for (int d = 0; d < ndst; ++d)
    f.dst[d] = Dest{static_cast<int8_t*>(outs[d]),
                    static_cast<const float*>(sxs[d]), meta[4 * d],
                    meta[4 * d + 1], meta[4 * d + 2], meta[4 * d + 3]};
  // the epilogue takes them by LeakyReLU count (the second's from the
  // first's values)
  if (ndst == 2 && f.dst[1].leaky < f.dst[0].leaky)
    std::swap(f.dst[0], f.dst[1]);
  return conv_launch(x, wk, scale, bias, nullptr, -1, n, hp, wp, cp, ho, wo,
                     co, phase_form, ws, ws_words, stream, &f);
}

// the launch srit_int8_conv_split makes for these shapes on the current
// device: plan[0..9] = BM, BN, splits of K, ring stages, workspace int32
// words (0 unsplit), blocks, taps, 1 where A arrives by TMA (0: gathered
// by cp.async), the images one TMA box spans (1 for the gather), and the
// tiles along M. cudaErrorInvalidValue for shapes outside
// srit_int8_conv's rules.
extern "C" int srit_int8_conv_plan(int n, int hp, int wp, int cp, int ho,
                                   int wo, int co, int phase_form,
                                   long long* plan) {
  if (!conv_args_ok(n, hp, wp, cp, ho, wo, co, phase_form))
    return status(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return status(e);
  const Plan q = make_plan(n, cp, ho, wo, co, phase_form, sms, true);
  const long long v[10] = {q.bm,     q.bn,   q.splits, q.stages, q.ws_words,
                           q.grid,   q.taps, q.tma_a,  q.nb,     q.mt};
  for (int i = 0; i < 10; ++i) plan[i] = v[i];
  return 0;
}
