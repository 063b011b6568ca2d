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
// Bound on the H100: a step reads each input element once and writes
// 4*Co outputs a position. At 256^2 b32 (input 128^2, Ci 64 + 64) bf16
// that is 134 MB in and 8 (Co 1) or 25 MB (Co 3) out: 0.085 ms for the
// pair at 3.35 TB/s. The products are few: as an all-phase 3x3 GEMM (K =
// 9 Ci, N = 4 Co padded to 8 or 16) 19.3 GFLOP at Co 3, 0.020 ms at 989
// TFLOP/s, so on the tensor cores the step is bound by its bytes. On the
// CUDA cores (16 Co FMAs an input value) the f32 FMA pipe would cap it
// at Co 3 (0.138 ms for the bf16 pair), above the bytes bound.
//
// A. bf16 (narrow_tc_kernel): an implicit GEMM on the tensor cores.
//    - Form: the all-phase 3x3 window. A row is one input position of a
//      16 x 32 tile, K its 3x3 neighbourhood x channels, N the 4 phases x
//      Co (8 columns at Co <= 2, 16 at Co 3..4), so the tile's output is
//      disjoint from its neighbours' and the epilogue writes each
//      position's 2 x 2 x Co outputs. The phase-grid form (4 taps over
//      (H+1) x (W+1), pallas_decoder.py:75-84) does 4/9 of the products,
//      but its tiles of the grid overlap the next tile's outputs or leave
//      a one-column tile at every edge (129 = 4 x 32 + 1 at 128^2).
//    - B, the expanded weight (9 taps x Ci x N, zero where a phase skips
//      a tap; 36 KB at Ci 128, N 16), is built inside the kernel from w4
//      into shared memory in mma fragment order (one 8- or 16-byte load a
//      thread per tap and k step), once a launch where every chunk's
//      slice fits (Ci <= 256 at N 16), else per chunk into two slots.
//    - Loads: a ring of 4 stages, each one 32-channel chunk of a tile's
//      18 x 34 halo (64 bytes a pixel, the 64-byte swizzle). A part whose
//      pointer is 16-byte aligned and whose channels are a multiple of 8
//      arrives by TMA: one 4-D tensor map (C, W, H, N) a part, one box a
//      stage completing the stage's mbarrier; out-of-range pixels and
//      channels past the part are TMA's zero fill, which is the zero-pad
//      form. Any other part is loaded element by element into the same
//      swizzled layout (the route is fixed before the launch, from the
//      pointers and channel counts). The edge form clamps the pixel each
//      ldmatrix row address names, so the halo itself is never patched.
//      The block is persistent (one a SM) and the ring runs across its
//      tiles, so the next tile's chunks are in flight (3 stages, ~118 KB
//      an SM) while this one's are multiplied and stored.
//    - LeakyReLU: once per element, in shared memory, after a stage lands
//      (bf16(0.2f * x) for x < 0, as F.leaky_relu in bf16).
//    - Products: 8 warps, each 4 rows x 16 columns of the tile (4 m16
//      tiles). mma.sync m16n8k16 bf16 -> f32 with A by ldmatrix: a
//      neighbour is another row address into the same halo, nothing is
//      transposed. A warp walks the 6 halo rows its 4 rows read: each
//      halo row's fragment, at each of the 3 column shifts, feeds every
//      one of the 4 rows that reads it, so A is read from shared memory
//      18 times a k step for 4 rows and not 36. Shared-memory traffic (A,
//      B and the TMA writes, ~1 KB a position and 32 channels) then stays
//      under the bytes bound; the tensor-core work is a quarter of it or
//      less, which is why mma.sync suffices and wgmma (m64, A from a
//      swizzled descriptor that a shifted neighbour would misalign) is
//      not used.
//    - Accuracy: the tensor cores' f32 sums do not round to nearest, so
//      each chunk (288-deep K) is summed in fresh registers and added to
//      the accumulator in f32 round-to-nearest, as decoder_upsample_tc.cu
//      does.
//    - Epilogue as before: the f32 affine with two roundings, the cast,
//      and the depth-to-space store, a bf16 pair a store (phases 0..1 and
//      2..3 are 2 Co contiguous outputs of rows 2i and 2i+1).
//
// B. f32 (narrow_f32_kernel): FMAs on the CUDA cores, fed like A.
//    - Bound: at 480x640 b16 zero pad (input 240 x 320, Ci 128, the
//      validation path) the step reads 629 MB; Co 1 writes 20 MB and is
//      bound by its bytes (0.194 ms at 3.35 TB/s; its 2.5 GFMA would take
//      0.075 ms at 67 TFLOP/s), Co 3 writes 59 MB and its 7.5 GFMA (16 Co
//      an input value, the all-phase count) bind it at 0.225 ms against
//      0.206 for its bytes. At 256^2 b32 (Ci 64 + 64): 0.083 and 0.096
//      ms. So the kernel has to stream at the memory's rate and keep the
//      FMA pipe busy at the same time, with little else in the way.
//    - Arithmetic: f32 FMAs rounded to nearest in registers. The TF32
//      tensor cores would not hold 2e-5 against the plain version, and a
//      split (3x) TF32 form in this all-phase layout (N 12 of 16, 4 of 9
//      taps a phase) would run at about the FMA pipe's useful rate.
//    - Persistent: one block an SM walks 16 x 32 position tiles in
//      (image, tile row, tile column) order, and the ring runs across its
//      tiles, so the next chunk is in flight while this one's FMAs and
//      the tile's stores run (a block a tile refilled its ring from empty
//      and overlapped no loads with its epilogue). The next load's tile
//      and the compute's are cursors advanced by one a step: the
//      divisions of a tile index run once a tile, not every step.
//    - Loads: a ring of 2 stages, each one 32-channel chunk (128 bytes a
//      pixel, the 128-byte swizzle) of the tile's 18 x 34 halo, by TMA
//      where the part is 16-byte aligned with channels a multiple of 4
//      (one 4-D map a part, zero fill for the zero-pad form and for
//      channels past the part), else element by element into the same
//      layout; the route is fixed before the launch and reported by the
//      plan entry. Why 2 stages of 32 channels and not 4 of 16: a step
//      (its block barrier, its wait, its bookkeeping) costs about as much
//      as a few hundred FMAs a thread, and on the H100 a ring of 16-
//      channel stages took ~16 % longer for the same work; 3 stages of
//      80 KB do not fit beside the staging tile and the weights. One stage in flight
//      still streams: a step's FMAs at Co 3 take longer than its 80 KB
//      take to arrive, and at Co 1 the ring runs at ~80 % of the bytes
//      bound. The box is 35 pixels wide, one more than the halo: an odd
//      row stride lets a quarter-warp (one column group x 8 rows) read 8
//      pixels whose index mod 8 differ, i.e. 8 distinct 16-byte bank
//      groups under the swizzle, so every float4 read of the FMA loop is
//      conflict-free. The edge form clamps the pixel each thread reads,
//      as A does.
//    - No transpose pass, one barrier a stage: LeakyReLU, where set, is
//      applied once in place after a stage lands (zero fill stays zero);
//      the FMA loop reads the swizzled channels-last records directly as
//      float4 of 4 channels; the stage goes back to the producer through
//      the one __syncthreads a step (which also orders the weight slots).
//      Element loads publish a stage only after a barrier of their own,
//      since with 2 stages the next step reads it. (A form with per-stage
//      "empty" mbarriers in place of that barrier measured slower.)
//    - Products: 256 threads in 4 groups of 64 over the same tile: a
//      group computes one output row pr of the 2 x 2 phases from one half
//      (16 channels) of each chunk. A thread owns 8 adjacent positions of
//      a tile row and keeps their 2 phases x Co sums (half of 4 Co: 16
//      Co registers, up to 251 in all at Co 4, no spill). For each of its
//      2 halo rows (pr + di) and 4 channels it reads the 10 pixels'
//      float4 once and the 4 x Co weights of that tap row as broadcast
//      float4: per 4 channels 20 + 8 Co shared loads feed 32 Co FMAs a
//      position, 8 positions. The loop at Co 3 follows its shared loads
//      a FMA more than its warp count: 4 positions a thread with 16 warps
//      an SM ran 12-15 % slower than 8 positions with 8 warps, each
//      broadcast weight load there serving half the FMAs.
//    - Weights: every chunk's slice (32 channels x 16 Co, zero past the
//      part; a channel's taps of output row pr lie together) is built
//      into shared memory once a launch where all fit (Ci <= 224 at Co
//      3), else per chunk into two slots.
//    - Epilogue: the groups of channel half 1 hand their sums to those of
//      half 0 through a staging tile in output order (2 x 16 rows of 2 x
//      32 x Co floats, each row padded by 16 bytes so a quarter-warp's 8
//      rows land in 8 bank groups); those add, apply the affine with two
//      roundings (__fmul_rn, then __fadd_rn) and write it back; then all
//      256 threads store each output row segment with coalesced 16-byte
//      stores (scalar where the output's rows are not 16-byte aligned,
//      and at a ragged tile's end).

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

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

__device__ __host__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// A. bf16 on the tensor cores

namespace tc {

constexpr int TH = 16, TW = 32;               // tile of input positions
constexpr int HR = TH + 2, HC = TW + 2;       // halo rows, columns
constexpr int HALO = HR * HC;                 // 612 pixels
constexpr int CK = 32;                        // channels a chunk
constexpr int PIX = 2 * CK;                   // bytes a pixel in a stage
constexpr int PIECES = CK / 8;                // 16-byte pieces a pixel
constexpr int KS = CK / 16;                   // k steps a chunk
constexpr int BOX_BYTES = HALO * PIX;         // one TMA box: 39,168
constexpr int STAGE = (BOX_BYTES + 511) / 512 * 512;  // 64-byte swizzle atom
constexpr int STAGES = 4;
constexpr int R = 4;                          // tile rows a warp
constexpr int NT = 32 * (TH / R) * (TW / 16); // 8 warps of 4 x 16
constexpr int SMEM_CAP = 232448;              // a block's dynamic maximum
constexpr int SMEM_FIXED = 1024 + STAGES * STAGE + 8 * STAGES;
static_assert(PIX == 64, "stages use the 64-byte swizzle");

// bytes of one chunk's B in fragment order: 9 taps x KS k steps x 32 lanes
// x NJ n8 tiles x 2 words
__host__ __device__ constexpr int slot_bytes(int nj) {
  return 9 * KS * 32 * nj * 8;
}

enum Load { TMA = 0, CP_ASYNC = 1, SCALAR = 2 };

struct KParams {
  const uint16_t* x0;
  const uint16_t* x1;
  int ci0, ci1, nq0, nq;
  int load0, load1;
  const uint16_t* w4;
  const float* scale4;
  const float* bias4;
  __nv_bfloat16* out;
  int h, w, tiles_x, tiles_y, tiles;
  int leaky, zero_pad, resident, out4;
};

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

// a (32 channels x 34 x 18 x 1) box of a part's map (C, W, H, N)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// byte offset of 16-byte piece j (0..3) of halo pixel P in a stage: the
// 64-byte swizzle TMA writes (piece bits 4-5 XOR address bits 7-8)
__device__ __forceinline__ uint32_t piece_at(int P, int j) {
  return static_cast<uint32_t>(P * PIX + ((j ^ ((P >> 1) & 3)) << 4));
}

struct Tile {
  int img, i0, j0;
};

__device__ __forceinline__ Tile tile_at(const KParams& p, int t) {
  const int tx = t % p.tiles_x, r = t / p.tiles_x;
  const int ty = r % p.tiles_y;
  return Tile{r / p.tiles_y, ty * TH, tx * TW};
}

template <int CO>
__global__ void __launch_bounds__(NT, 1)
    narrow_tc_kernel(const __grid_constant__ CUtensorMap map0,
                     const __grid_constant__ CUtensorMap map1,
                     const KParams p) {
  constexpr int NJ = CO <= 2 ? 1 : 2;           // n8 tiles: N = 8 or 16
  constexpr int SLOT = slot_bytes(NJ);
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle pattern follows address bits: stages start 512-aligned
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  uint8_t* const gb = gbase + STAGES * STAGE;   // B slots
  const int nslots = p.resident ? p.nq : 2;
  const uint32_t bars = base + STAGES * STAGE + nslots * SLOT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci = p.ci0 + p.ci1;

  // chunk q's B (every tap, both k steps) from w4 into slot `slot`:
  // word ((tap * KS + ks) * 32 + lane) * 2 NJ + 2 j + r holds the bf16 pair
  // b_r of n8 tile j of mma.sync's B fragment for that lane
  auto build_b = [&](int q, int slot) {
    const bool first = q < p.nq0;
    const int cip = first ? p.ci0 : p.ci1, off = first ? 0 : p.ci0;
    const int cq = (first ? q : q - p.nq0) * CK;
    uint32_t* dst = reinterpret_cast<uint32_t*>(gb + slot * SLOT);
    for (int e = tid; e < SLOT / 4; e += NT) {
      const int r = e & 1, j = (e >> 1) % NJ, rest = e / (2 * NJ);
      const int l = rest & 31, tk = rest >> 5;
      const int tap = tk / KS, ks = tk - KS * tap;
      const int dr = tap / 3, dc = tap - 3 * dr;
      const int n = 8 * j + (l >> 2);
      const int k = cq + 16 * ks + 2 * (l & 3) + 8 * r;
      uint32_t v = 0;
      if (n < 4 * CO) {
        const int ph = n / CO;
        const int di = dr - (ph >> 1), dj = dc - (ph & 1);
        if (di >= 0 && di <= 1 && dj >= 0 && dj <= 1) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            if (k + e2 < cip)
              v |= static_cast<uint32_t>(
                       p.w4[(static_cast<int64_t>(2 * di + dj) * ci + off +
                             k + e2) *
                                (4 * CO) +
                            n])
                   << (16 * e2);
        }
      }
      dst[e] = v;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.resident)
    for (int q = 0; q < p.nq; ++q) build_b(q, q);

  const int my_tiles =
      (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nsteps = my_tiles * p.nq;

  // step k: chunk k % nq of this block's tile k / nq, into stage k % STAGES
  auto issue = [&](int k) {
    const int q = k % p.nq, s = k % STAGES;
    const Tile t = tile_at(p, blockIdx.x + (k / p.nq) * gridDim.x);
    const bool first = q < p.nq0;
    const int cq = (first ? q : q - p.nq0) * CK;
    const uint32_t bar = bars + 8 * s;
    if ((first ? p.load0 : p.load1) == TMA) {
      if (tid == 0) {
        mbar_arrive_expect_tx(bar, BOX_BYTES);
        tma_load_4d(base + s * STAGE, first ? &map0 : &map1, bar, cq,
                    t.j0 - 1, t.i0 - 1, t.img);
      }
      return;
    }
    // element by element, zero outside the image and past the part
    const uint16_t* x = first ? p.x0 : p.x1;
    const int cip = first ? p.ci0 : p.ci1;
    uint8_t* stage = gbase + s * STAGE;
    for (int e = tid; e < HALO * PIECES; e += NT) {
      const int P = e / PIECES, j = e % PIECES;
      const int rr = t.i0 - 1 + P / HC, qq = t.j0 - 1 + P % HC;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (rr >= 0 && rr < p.h && qq >= 0 && qq < p.w) {
        const int64_t px =
            ((static_cast<int64_t>(t.img) * p.h + rr) * p.w + qq) * cip;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int ch = cq + 8 * j + c;
          if (ch < cip)
            v[c >> 1] |= static_cast<uint32_t>(x[px + ch]) << (16 * (c & 1));
        }
      }
      *reinterpret_cast<uint4*>(stage + piece_at(P, j)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();  // before a later TMA write to this stage
    if (tid == 0) mbar_arrive(bar);
  };

  for (int k = 0; k < STAGES - 1 && k < nsteps; ++k) issue(k);
  __syncthreads();  // barriers initialised, B built, element loads done

  // this warp's rows r0 .. r0+3 and columns c0 .. c0+15 of the tile
  const int r0 = R * (warp / (TW / 16)), c0 = 16 * (warp % (TW / 16));
  const int g = lane >> 2, t4 = lane & 3;
  const int arow = lane & 15, akc = lane >> 4;  // ldmatrix row, 8-chan half
  // the epilogue's columns n = 8 j + 2 t4 + e, their scale and bias
  float sc[NJ][2], bi[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t4 + e;
      const bool on = p.scale4 != nullptr && n < 4 * CO;
      sc[j][e] = on ? p.scale4[n] : 1.f;
      bi[j][e] = on ? p.bias4[n] : 0.f;
    }

  float acc[R][NJ][4];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    const int q = k % p.nq, s = k % STAGES;
    if (!p.resident) build_b(q, k & 1);  // slot k & 1 last read at k - 2
    mbar_wait(bars + 8 * s, (k / STAGES) & 1);
    if (p.leaky) {
      uint4* v = reinterpret_cast<uint4*>(gbase + s * STAGE);
      for (int e = tid; e < BOX_BYTES / 16; e += NT) {
        uint4 u = v[e];
        u.x = leaky2(u.x);
        u.y = leaky2(u.y);
        u.z = leaky2(u.z);
        u.w = leaky2(u.w);
        v[e] = u;
      }
      fence_proxy_async();
    }
    __syncthreads();  // stage s ready; every warp is done with step k - 1
    if (k + STAGES - 1 < nsteps) issue(k + STAGES - 1);  // stage of k - 1

    const Tile t = tile_at(p, blockIdx.x + (k / p.nq) * gridDim.x);
    // halo pixel of each of the 6 halo rows and 3 column shifts this
    // thread's ldmatrix rows read; the edge form clamps them to the image
    int hrow[R + 2], hcol[3];
#pragma unroll
    for (int u = 0; u < R + 2; ++u) {
      int r = r0 + u;
      if (!p.zero_pad)
        r = min(max(t.i0 + r - 1, 0), p.h - 1) - t.i0 + 1;
      hrow[u] = r * HC;
    }
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      int c = c0 + arow + dc;
      if (!p.zero_pad) c = min(max(t.j0 + c - 1, 0), p.w - 1) - t.j0 + 1;
      hcol[dc] = c;
    }

    const uint32_t st = base + s * STAGE;
    const uint8_t* bq = gb + (p.resident ? q : (k & 1)) * SLOT;
    float part[R][NJ][4];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[9][NJ][2];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint8_t* src = bq + ((tap * KS + ks) * 32 + lane) * NJ * 8;
        if constexpr (NJ == 2) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          b[tap][0][0] = v.x;
          b[tap][0][1] = v.y;
          b[tap][NJ - 1][0] = v.z;
          b[tap][NJ - 1][1] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          b[tap][0][0] = v.x;
          b[tap][0][1] = v.y;
        }
      }
      const int kc = 2 * ks + akc;
#pragma unroll
      for (int u = 0; u < R + 2; ++u)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int P = hrow[u] + hcol[dc];
          uint32_t a[4];
          ldmatrix_x4(a, st + piece_at(P, kc));
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
            const int m = u - dr;  // tile row r0 + m reads halo row u here
            if (m < 0 || m >= R) continue;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              mma_bf16(part[m][j], a, b[3 * dr + dc][j][0],
                       b[3 * dr + dc][j][1]);
          }
        }
    }
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][j][e] = __fadd_rn(acc[m][j][e], part[m][j][e]);

    if (q != p.nq - 1) continue;
    // epilogue: affine, cast, depth-to-space store of the tile
    const int64_t h2 = 2 * static_cast<int64_t>(p.h), w2 = 2 * p.w;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = t.i0 + r0 + m;
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // accumulator rows g and g + 8
        const int jj = t.j0 + c0 + g + 8 * e;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = 8 * j + 2 * t4;  // n, n + 1: one phase row's pair
          if (i < p.h && jj < p.w && n < 4 * CO) {
            float v0 = acc[m][j][2 * e], v1 = acc[m][j][2 * e + 1];
            if (p.scale4 != nullptr) {  // two roundings, as the plain one
              v0 = __fadd_rn(__fmul_rn(v0, sc[j][0]), bi[j][0]);
              v1 = __fadd_rn(__fmul_rn(v1, sc[j][1]), bi[j][1]);
            }
            const int pr = n >= 2 * CO ? 1 : 0;
            __nv_bfloat16* dst =
                p.out + ((t.img * h2 + 2 * i + pr) * w2 + 2 * jj) * CO +
                (n - 2 * CO * pr);
            const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
            if (p.out4) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
            } else {
              dst[0] = pair.x;
              dst[1] = pair.y;
            }
          }
          acc[m][j][2 * e] = acc[m][j][2 * e + 1] = 0.f;
        }
      }
    }
  }
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

// a part's load route: TMA where its rows are whole 16-byte pieces on a
// 16-byte aligned base (the tensor map's rules), else element by element
int part_load(const void* x, int cip) {
  return aligned16(x) && cip > 0 && cip % 8 == 0 ? TMA : SCALAR;
}

// the launch: blocks, whether every chunk's B stays resident, bytes of
// dynamic shared memory
struct Plan {
  int load0, load1, nq0, nq, nj, tiles_x, tiles_y, tiles, grid, resident;
  int smem;
};

Plan make_plan(const Params& p, int sms) {
  Plan q{};
  q.load0 = part_load(p.x0, p.ci0);
  q.load1 = p.ci1 > 0 ? part_load(p.x1, p.ci1) : -1;
  q.nq0 = (p.ci0 + CK - 1) / CK;
  q.nq = q.nq0 + (p.ci1 + CK - 1) / CK;
  q.nj = p.co <= 2 ? 1 : 2;
  q.tiles_x = (p.w + TW - 1) / TW;
  q.tiles_y = (p.h + TH - 1) / TH;
  const int64_t tiles = static_cast<int64_t>(q.tiles_x) * q.tiles_y * p.n;
  q.tiles = static_cast<int>(std::min<int64_t>(tiles, INT32_MAX));
  q.grid = static_cast<int>(std::min<int64_t>(tiles, sms));
  const int slot = slot_bytes(q.nj);
  q.resident = SMEM_FIXED + q.nq * slot <= SMEM_CAP;
  q.smem = SMEM_FIXED + (q.resident ? q.nq : 2) * slot;
  return q;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// a part's 4-D map (C, W, H, N), boxes of 32 channels x 34 x 18 x 1
bool encode_part(CUtensorMap* map, EncodeTiled encode, const void* x,
                 int cip, const Params& p) {
  const cuuint64_t c = cip, e = 2;
  const cuuint64_t dims[4] = {c, static_cast<cuuint64_t>(p.w),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[3] = {c * e, c * e * p.w, c * e * p.w * p.h};
  const cuuint32_t box[4] = {CK, HC, HR, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CO>
int launch(const Params& p, cudaStream_t stream) {
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const Plan q = make_plan(p, sms);
  if (q.tiles == 0) return 0;
  CUtensorMap map0{}, map1{};
  if (q.load0 == TMA || q.load1 == TMA) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if ((q.load0 == TMA && !encode_part(&map0, encode, p.x0, p.ci0, p)) ||
        (q.load1 == TMA && !encode_part(&map1, encode, p.x1, p.ci1, p)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  KParams k{};
  k.x0 = static_cast<const uint16_t*>(p.x0);
  k.x1 = static_cast<const uint16_t*>(p.x1);
  k.ci0 = p.ci0;
  k.ci1 = p.ci1;
  k.nq0 = q.nq0;
  k.nq = q.nq;
  k.load0 = q.load0;
  k.load1 = q.load1;
  k.w4 = static_cast<const uint16_t*>(p.w4);
  k.scale4 = p.scale4;
  k.bias4 = p.bias4;
  k.out = static_cast<__nv_bfloat16*>(p.out);
  k.h = p.h;
  k.w = p.w;
  k.tiles_x = q.tiles_x;
  k.tiles_y = q.tiles_y;
  k.tiles = q.tiles;
  k.leaky = p.leaky;
  k.zero_pad = p.zero_pad;
  k.resident = q.resident;
  k.out4 = (reinterpret_cast<uintptr_t>(p.out) & 3) == 0;
  const cudaError_t set = cudaFuncSetAttribute(
      narrow_tc_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      q.smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  narrow_tc_kernel<CO><<<q.grid, NT, q.smem, stream>>>(map0, map1, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// B. f32 on the CUDA cores

namespace f32 {

constexpr int TH = 16, TW = 32;                // tile of input positions
constexpr int HR = TH + 2, HC = TW + 2;        // halo rows, columns read
constexpr int BW = HC + 1;                     // box columns: odd row stride
constexpr int CK = 32;                         // channels a chunk
constexpr int PIX = 4 * CK;                    // bytes a pixel in a stage
constexpr int BOX_BYTES = HR * BW * PIX;       // one TMA box: 80,640
constexpr int STAGE = (BOX_BYTES + 1023) / 1024 * 1024;  // swizzle atom
constexpr int STAGES = 2;
constexpr int PX = 8;                          // positions a thread, along W
constexpr int GT = (TW / PX) * TH;             // threads of a group
constexpr int NT = 4 * GT;                     // 2 output rows x 2 halves
constexpr int SMEM_CAP = 232448;               // a block's dynamic maximum
static_assert(PIX == 128, "stages use the 128-byte swizzle");
static_assert(BW % 2 == 1, "an odd row stride keeps float4 reads apart");
static_assert(GT == 64, "a group is 2 warps of 4 column groups x 8 rows");

// bytes of one chunk's weights: 32 channels x 16 Co floats
__host__ __device__ constexpr int slot_bytes(int co) { return CK * 16 * co * 4; }
// bytes of the staging tile: 2 TH output rows of 2 TW x Co floats, each
// row padded by 16 bytes so a quarter-warp's 8 rows hit 8 bank groups
__host__ __device__ constexpr int out_bytes(int co) {
  return 2 * TH * (2 * TW * co + 4) * 4;
}
__host__ __device__ constexpr int smem_fixed(int co) {
  return 1024 + STAGES * STAGE + out_bytes(co) + 8 * STAGES;
}

struct KParams {
  const float* x0;
  const float* x1;
  int ci0, ci1, nq0, nq;
  int load0, load1;
  const float* w4;
  const float* scale4;
  const float* bias4;
  float* out;
  int h, w, tiles_x, tiles_y, tiles;
  int leaky, zero_pad, resident, vec_out;
};

struct Tile {
  int img, i0, j0;
};

__device__ __forceinline__ Tile tile_at(const KParams& p, int t) {
  const int tx = t % p.tiles_x, r = t / p.tiles_x;
  const int ty = r % p.tiles_y;
  return Tile{r / p.tiles_y, ty * TH, tx * TW};
}

// byte offset of 16-byte piece j (0..7) of halo pixel P in a stage: the
// 128-byte swizzle TMA writes (piece bits 4-6 XOR address bits 7-9)
__device__ __forceinline__ int piece_at(int P, int j) {
  return P * PIX + ((j ^ (P & 7)) << 4);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float leaky1(float x) {
  return x < 0.f ? 0.2f * x : x;
}

template <int CO>
__global__ void __launch_bounds__(NT, 1)
    narrow_f32_kernel(const __grid_constant__ CUtensorMap map0,
                      const __grid_constant__ CUtensorMap map1,
                      const KParams p) {
  constexpr int NW = 16 * CO;           // weights a channel
  constexpr int CHUNK_W = CK * NW;      // floats of one chunk's weights
  constexpr int OROW = 2 * TW * CO;     // floats an output row of the tile
  constexpr int OSTR = OROW + 4;        // its stride in the staging tile
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle pattern follows address bits: stages start 1024-aligned
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  float* const stg = reinterpret_cast<float*>(gbase + STAGES * STAGE);
  float* const ws = stg + 2 * TH * OSTR;
  const int nslots = p.resident ? p.nq : 2;
  const uint32_t bars =
      base + STAGES * STAGE + out_bytes(CO) + nslots * slot_bytes(CO);
  const int tid = threadIdx.x;
  const int ci = p.ci0 + p.ci1;

  // chunk q's weights into slot `slot`: channel c's 16 Co floats are
  // [b = 2 pr + di][u = 2 pc + dj][o] = w4[di, dj, c, (2 pr + pc) Co + o],
  // so the taps of output row pr (blocks 2 pr, 2 pr + 1) lie together
  auto build_w = [&](int q, int slot) {
    const bool first = q < p.nq0;
    const int cip = first ? p.ci0 : p.ci1, off = first ? 0 : p.ci0;
    const int cq = (first ? q : q - p.nq0) * CK;
    float* dst = ws + slot * CHUNK_W;
    for (int e = tid; e < CHUNK_W; e += NT) {
      const int c = e / NW, r = e - c * NW;
      const int b = r / (4 * CO), u = (r / CO) & 3, o = r % CO;
      const int pr = b >> 1, di = b & 1, pc = u >> 1, dj = u & 1;
      const int k = cq + c;
      dst[e] = k < cip ? p.w4[(static_cast<int64_t>(2 * di + dj) * ci + off +
                               k) * (4 * CO) + (2 * pr + pc) * CO + o]
                       : 0.f;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.resident)
    for (int q = 0; q < p.nq; ++q) build_w(q, q);

  const int my_tiles =
      (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nsteps = my_tiles * p.nq;

  // the next load: step ik, chunk iq of tile itile (coordinates itl), into
  // stage ik % STAGES; advanced by each issue, divisions once a tile
  int ik = 0, iq = 0, itile = blockIdx.x;
  Tile itl = tile_at(p, itile);
  auto issue_next = [&]() {
    const int s = ik % STAGES;
    const bool first = iq < p.nq0;
    const int cq = (first ? iq : iq - p.nq0) * CK;
    const uint32_t bar = bars + 8 * s;
    if ((first ? p.load0 : p.load1) == tc::TMA) {
      if (tid == 0) {
        tc::mbar_arrive_expect_tx(bar, BOX_BYTES);
        tc::tma_load_4d(base + s * STAGE, first ? &map0 : &map1, bar, cq,
                        itl.j0 - 1, itl.i0 - 1, itl.img);
      }
    } else {  // element by element, zero outside the image and the part
      const float* x = first ? p.x0 : p.x1;
      const int cip = first ? p.ci0 : p.ci1;
      uint8_t* stage = gbase + s * STAGE;
      for (int e = tid; e < HR * BW * 8; e += NT) {
        const int P = e >> 3, j = e & 7;
        const int rr = itl.i0 - 1 + P / BW, qq = itl.j0 - 1 + P % BW;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (rr >= 0 && rr < p.h && qq >= 0 && qq < p.w) {
          const int64_t px =
              ((static_cast<int64_t>(itl.img) * p.h + rr) * p.w + qq) * cip;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (cq + 4 * j + c < cip) v[c] = x[px + cq + 4 * j + c];
        }
        *reinterpret_cast<float4*>(stage + piece_at(P, j)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      tc::fence_proxy_async();  // before a later TMA write to this stage
      // every thread's part is in before the stage is published: with 2
      // stages it is read (LeakyReLU'd) at the next step, before its barrier
      __syncthreads();
      if (tid == 0) tc::mbar_arrive(bar);
    }
    ++ik;
    if (++iq == p.nq) {
      iq = 0;
      itile += gridDim.x;
      if (ik < nsteps) itl = tile_at(p, itile);
    }
  };

  const Tile first_tile = itl;
  for (int k = 0; k < STAGES - 1 && k < nsteps; ++k) issue_next();
  __syncthreads();  // barriers initialised, weights built, element loads done

  // group g computes output row pr = g & 1 (phases 2 pr, 2 pr + 1) from
  // channels 16 h .. 16 h + 15 (pieces 4 h .. 4 h + 3) of every chunk, h =
  // g >> 1; a quarter-warp is one column group x 8 rows (see the header)
  const int g = tid / GT, t = tid % GT, lane = t & 31;
  const int pr = g & 1, half = g >> 1;
  const int tx = lane >> 3;                          // positions PX tx ..
  const int ty = 8 * (t >> 5) + (lane & 7);          // tile row
  // byte offset in a stage of piece 4 half of the halo pixel this thread
  // reads at halo row pr + di (tile row ty + pr + di - 1) and column k
  // (tile column PX tx + k - 1); piece 4 half + jj is the offset ^ 16 jj
  int poff[2][PX + 2];

  float acc[PX][2][CO];
#pragma unroll
  for (int px = 0; px < PX; ++px)
#pragma unroll
    for (int pc = 0; pc < 2; ++pc)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[px][pc][o] = 0.f;

  int q = 0, ctile = blockIdx.x;
  Tile tl = first_tile;
  for (int k = 0; k < nsteps; ++k) {
    const int s = k % STAGES;
    if (!p.resident) build_w(q, k & 1);  // slot k & 1 last read at k - 2
    tc::mbar_wait(bars + 8 * s, (k / STAGES) & 1);
    if (p.leaky) {
      float4* v = reinterpret_cast<float4*>(gbase + s * STAGE);
      for (int e = tid; e < BOX_BYTES / 16; e += NT) {
        float4 u = v[e];
        u.x = leaky1(u.x);
        u.y = leaky1(u.y);
        u.z = leaky1(u.z);
        u.w = leaky1(u.w);
        v[e] = u;
      }
      tc::fence_proxy_async();
    }
    __syncthreads();  // stage s ready; every thread is done with step k - 1
    if (ik < nsteps) issue_next();  // step k + 1, into the stage of k - 1

    if (q == 0) {  // a new tile: its halo pixels, clamped in the edge form
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        int r = ty + pr + di;
        if (!p.zero_pad) r = min(max(tl.i0 + r - 1, 0), p.h - 1) - tl.i0 + 1;
#pragma unroll
        for (int kk = 0; kk < PX + 2; ++kk) {
          int c = PX * tx + kk;
          if (!p.zero_pad)
            c = min(max(tl.j0 + c - 1, 0), p.w - 1) - tl.j0 + 1;
          const int P = r * BW + c;
          poff[di][kk] = piece_at(P, 4 * half);
        }
      }
    }

    const uint8_t* st = gbase + s * STAGE;
    const float* wq = ws + (p.resident ? q : (k & 1)) * CHUNK_W +
                      16 * half * NW + 2 * pr * 4 * CO;
#pragma unroll 1
    for (int jj = 0; jj < 4; ++jj) {
      const int jx = jj << 4;
      const float* wj = wq + 4 * jj * NW;
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        float4 xv[PX + 2];
#pragma unroll
        for (int kk = 0; kk < PX + 2; ++kk)
          xv[kk] = *reinterpret_cast<const float4*>(st + (poff[di][kk] ^ jx));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // block 2 pr + di of channel 4 jj + e: 4 taps x Co
          float wv[4 * CO];
          const float4* w4v =
              reinterpret_cast<const float4*>(wj + e * NW + di * 4 * CO);
#pragma unroll
          for (int v = 0; v < CO; ++v) {
            const float4 f = w4v[v];
            wv[4 * v] = f.x;
            wv[4 * v + 1] = f.y;
            wv[4 * v + 2] = f.z;
            wv[4 * v + 3] = f.w;
          }
#pragma unroll
          for (int px = 0; px < PX; ++px)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int pc = u >> 1, dj = u & 1;  // column px + pc + dj - 1
              const float xval = lane_of(xv[px + pc + dj], e);
#pragma unroll
              for (int o = 0; o < CO; ++o)
                acc[px][pc][o] =
                    fmaf(xval, wv[u * CO + o], acc[px][pc][o]);
            }
        }
      }
    }

    if (q != p.nq - 1) {
      ++q;
      continue;
    }
    // epilogue. This thread's 2 x 4 outputs of output row 2 ty + pr are 8
    // Co contiguous floats of the staging tile: the groups of channel half
    // 1 write their sums there, those of half 0 add their own, apply the
    // affine and write them back
    float* const mine = stg + (2 * ty + pr) * OSTR + 2 * PX * tx * CO;
    if (half == 1) {
      float v[2 * PX * CO];
#pragma unroll
      for (int px = 0; px < PX; ++px)
#pragma unroll
        for (int pc = 0; pc < 2; ++pc)
#pragma unroll
          for (int o = 0; o < CO; ++o)
            v[(2 * px + pc) * CO + o] = acc[px][pc][o];
      float4* d = reinterpret_cast<float4*>(mine);
#pragma unroll
      for (int m = 0; m < PX * CO / 2; ++m)
        d[m] = make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2],
                           v[4 * m + 3]);
    }
    __syncthreads();
    if (half == 0) {
      const bool affine = p.scale4 != nullptr;
      float4* d = reinterpret_cast<float4*>(mine);
      float v[2 * PX * CO];
#pragma unroll
      for (int m = 0; m < PX * CO / 2; ++m) {
        const float4 f = d[m];
        v[4 * m] = f.x;
        v[4 * m + 1] = f.y;
        v[4 * m + 2] = f.z;
        v[4 * m + 3] = f.w;
      }
#pragma unroll
      for (int px = 0; px < PX; ++px)
#pragma unroll
        for (int pc = 0; pc < 2; ++pc)
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const int ph = 2 * pr + pc;
            float r = __fadd_rn(acc[px][pc][o], v[(2 * px + pc) * CO + o]);
            if (affine)  // two roundings, as the plain version
              r = __fadd_rn(__fmul_rn(r, p.scale4[ph * CO + o]),
                            p.bias4[ph * CO + o]);
            v[(2 * px + pc) * CO + o] = r;
          }
#pragma unroll
      for (int m = 0; m < PX * CO / 2; ++m)
        d[m] = make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2],
                           v[4 * m + 3]);
    }
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int pc = 0; pc < 2; ++pc)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[px][pc][o] = 0.f;
    __syncthreads();
    // the depth-to-space store: each output row segment of the tile, in
    // 16-byte pieces across the block
    const int rows = min(2 * TH, 2 * (p.h - tl.i0));
    const int cols = 2 * min(TW, p.w - tl.j0) * CO;  // floats a row
    const int64_t ostride = 2 * static_cast<int64_t>(p.w) * CO;
    float* const obase =
        p.out + (static_cast<int64_t>(tl.img) * 2 * p.h + 2 * tl.i0) *
                    ostride + 2 * tl.j0 * CO;
    if (p.vec_out) {
      for (int e = tid; e < 2 * TH * (OROW / 4); e += NT) {
        const int r = e / (OROW / 4), c = 4 * (e - r * (OROW / 4));
        if (r >= rows || c >= cols) continue;
        const float4 f =
            *reinterpret_cast<const float4*>(stg + r * OSTR + c);
        float* d = obase + r * ostride + c;
        if (c + 4 <= cols) {
          *reinterpret_cast<float4*>(d) = f;
        } else {  // a ragged tile's last 1..3 floats of the row
          d[0] = f.x;
          if (c + 1 < cols) d[1] = f.y;
          if (c + 2 < cols) d[2] = f.z;
        }
      }
    } else {
      for (int e = tid; e < 2 * TH * OROW; e += NT) {
        const int r = e / OROW, c = e - r * OROW;
        if (r < rows && c < cols) obase[r * ostride + c] = stg[r * OSTR + c];
      }
    }
    q = 0;
    ctile += gridDim.x;
    if (k + 1 < nsteps) tl = tile_at(p, ctile);
  }
}

// a part's load route: TMA where its rows are whole 16-byte pieces on a
// 16-byte aligned base (the tensor map's rules), else element by element
int part_load(const void* x, int cip) {
  return aligned16(x) && cip > 0 && cip % 4 == 0 ? tc::TMA : tc::SCALAR;
}

// the launch: blocks, whether every chunk's weights stay resident, bytes
// of dynamic shared memory
struct Plan {
  int load0, load1, nq0, nq, tiles_x, tiles_y, tiles, grid, resident;
  int smem;
};

Plan make_plan(const Params& p, int sms) {
  Plan q{};
  q.load0 = part_load(p.x0, p.ci0);
  q.load1 = p.ci1 > 0 ? part_load(p.x1, p.ci1) : -1;
  q.nq0 = (p.ci0 + CK - 1) / CK;
  q.nq = q.nq0 + (p.ci1 + CK - 1) / CK;
  q.tiles_x = (p.w + TW - 1) / TW;
  q.tiles_y = (p.h + TH - 1) / TH;
  const int64_t tiles = static_cast<int64_t>(q.tiles_x) * q.tiles_y * p.n;
  q.tiles = static_cast<int>(std::min<int64_t>(tiles, INT32_MAX));
  q.grid = static_cast<int>(std::min<int64_t>(tiles, sms));
  const int slot = slot_bytes(p.co);
  q.resident = smem_fixed(p.co) + q.nq * slot <= SMEM_CAP;
  q.smem = smem_fixed(p.co) + (q.resident ? q.nq : 2) * slot;
  return q;
}

// a part's 4-D map (C, W, H, N), boxes of 32 channels x 35 x 18 x 1
bool encode_part(CUtensorMap* map, tc::EncodeTiled encode, const void* x,
                 int cip, const Params& p) {
  const cuuint64_t c = cip, e = 4;
  const cuuint64_t dims[4] = {c, static_cast<cuuint64_t>(p.w),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[3] = {c * e, c * e * p.w, c * e * p.w * p.h};
  const cuuint32_t box[4] = {CK, BW, HR, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CO>
int launch(const Params& p, cudaStream_t stream) {
  int sms = 0;
  if (const int e = tc::sm_count(&sms)) return e;
  const Plan q = make_plan(p, sms);
  if (q.tiles == 0) return 0;
  CUtensorMap map0{}, map1{};
  if (q.load0 == tc::TMA || q.load1 == tc::TMA) {
    const tc::EncodeTiled encode = tc::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if ((q.load0 == tc::TMA && !encode_part(&map0, encode, p.x0, p.ci0, p)) ||
        (q.load1 == tc::TMA && !encode_part(&map1, encode, p.x1, p.ci1, p)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  KParams k{};
  k.x0 = static_cast<const float*>(p.x0);
  k.x1 = static_cast<const float*>(p.x1);
  k.ci0 = p.ci0;
  k.ci1 = p.ci1;
  k.nq0 = q.nq0;
  k.nq = q.nq;
  k.load0 = q.load0;
  k.load1 = q.load1;
  k.w4 = static_cast<const float*>(p.w4);
  k.scale4 = p.scale4;
  k.bias4 = p.bias4;
  k.out = static_cast<float*>(p.out);
  k.h = p.h;
  k.w = p.w;
  k.tiles_x = q.tiles_x;
  k.tiles_y = q.tiles_y;
  k.tiles = q.tiles;
  k.leaky = p.leaky;
  k.zero_pad = p.zero_pad;
  k.resident = q.resident;
  // every output row segment starts 16-byte aligned: the tile's columns
  // start at a multiple of 64 Co floats, a row holds 2 W Co floats
  k.vec_out = aligned16(p.out) && (2 * static_cast<int64_t>(p.w) * CO) % 4 == 0;
  const cudaError_t set = cudaFuncSetAttribute(
      narrow_f32_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      q.smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  narrow_f32_kernel<CO><<<q.grid, NT, q.smem, stream>>>(map0, map1, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <int CO>
int launch(int dtype, const Params& p, cudaStream_t stream) {
  return dtype == 0 ? f32::launch<CO>(p, stream) : tc::launch<CO>(p, stream);
}

bool args_ok(int dtype, int ci0, int ci1, int n, int h, int w, int co) {
  return co >= 1 && co <= 4 && (dtype == 0 || dtype == 1) && ci0 >= 1 &&
         ci1 >= 0 && n >= 0 && h >= 0 && w >= 0;
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
  if (!args_ok(dtype, ci0, ci1, n, h, w, co))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x0, x1, ci0, ci1, w4,
           static_cast<const float*>(scale4),
           static_cast<const float*>(bias4), out, n, h, w, co, leaky,
           zero_pad};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(n) * h * w == 0) return 0;
  switch (co) {
    case 1: return launch<1>(dtype, p, s);
    case 2: return launch<2>(dtype, p, s);
    case 3: return launch<3>(dtype, p, s);
    default: return launch<4>(dtype, p, s);
  }
}

// The launch srit_decoder_upsample_narrow makes for these arguments on the
// current device: plan[0..9] = route (0 CUDA cores, f32; 1 tensor cores,
// bf16), part 0's load and part 1's (0 TMA, 2 element by element, -1 no
// part), ring stages, tile rows, tile columns, blocks, 1 where every
// chunk's weights stay resident in shared memory, GEMM columns N (4 Co in
// f32, 8 or 16 in bf16), tiles.
// cudaErrorInvalidValue for arguments the entry refuses.
extern "C" int srit_decoder_upsample_narrow_plan(int dtype, const void* x0,
                                                 const void* x1, int ci0,
                                                 int ci1, int n, int h, int w,
                                                 int co, long long* plan) {
  if (!args_ok(dtype, ci0, ci1, n, h, w, co))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x0, x1, ci0, ci1, nullptr, nullptr, nullptr, nullptr,
                 n, h, w, co, 0, 0};
  int sms = 0;
  if (const int e = tc::sm_count(&sms)) return e;
  if (dtype == 0) {
    const f32::Plan q = f32::make_plan(p, sms);
    const long long f[10] = {0,       q.load0, q.load1,    f32::STAGES,
                             f32::TH, f32::TW, q.grid,     q.resident,
                             4 * co,  q.tiles};
    std::copy(f, f + 10, plan);
    return 0;
  }
  const tc::Plan q = tc::make_plan(p, sms);
  const long long b[10] = {1,      q.load0, q.load1,   tc::STAGES, tc::TH,
                           tc::TW, q.grid,  q.resident, 8 * q.nj,   q.tiles};
  std::copy(b, b + 10, plan);
  return 0;
}
