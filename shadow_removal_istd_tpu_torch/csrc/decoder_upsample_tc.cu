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
// operations: 0.452 ms for the 8 wide launches of a 256x256 b32 stacked
// forward, 1.112 ms for UNet's 8 up-convs there. Only wgmma gets near it.
//
// Design (Hopper; chip_smoke.py --compare-tc times it beside another
// source of this file):
// - Form: per phase an implicit GEMM, M = positions, N = Co, K = 4 taps
//   x (Ci0 + Ci1). A unit of work is one phase's Co tile at a tile of 128
//   positions: th x tw positions of nb images (tw 16, or 8 where W <= 8;
//   th up to 128 / tw; nb images where an image has fewer positions), so
//   8x8 and 1x1 inputs fill it. The Co tile is BN = 128 where Co > 64,
//   else BN = 64 with stages twice as deep (CK = 64 input channels, not
//   32), so a stage holds as many products either way. The TPU kernel's
//   phase-grid form (N = 4 Co over (H+1) x (W+1) positions) needs 4x the
//   accumulators a row for one Co tile and wastes up to 27 % of its rows
//   at 8x8; a unit of two phases for Co <= 64 (two N-64 wgmmas a tap over
//   one halo three columns wide) measured slower than BN 64.
// - A leaves device memory about once a launch: units run tile-major
//   (Co tile, then phase, fastest), so the 4 x Co/BN units that read one
//   tile's halo run at about the same time on neighbouring SMs and read
//   it from L2.
// - Persistent, warp-specialised: one block an SM (min(units, SMs)
//   blocks) walks units b, b + grid, ...; warps 0-7 are two consumer
//   warpgroups, one a 64-row half of the tile; warp 8 is the producer
//   (one thread; warps 9-11 idle). The ring runs on across units, so the
//   next unit's loads are in flight during this one's epilogue. 384
//   threads: the producer's warpgroup gives its registers to the
//   consumers (setmaxnreg 24 and 240). With 288 threads and no
//   setmaxnreg ptxas held every thread to 168 and spilled; with 288
//   threads and a lone producer warp at 24 the consumers' raise to 248
//   never returned.
// - Ring: 4 to 8 stages (as many as fit 227 KB), one stage a CK-channel
//   chunk of one part: the tile's halo for this phase, a 4-D box (CK
//   channels x tw+1 x th+1 x nb) of the part's (C, W, H, N) tensor map
//   (2 CK bytes a pixel under the swizzle of that width), and the
//   weights of the 4 taps for those channels: (BN / 64) x (CK / 32) 3-D
//   boxes (64 columns x 32 rows x 4 taps) of w4 read as it lies, (4 Co,
//   Ci, 4), with the 128-byte swizzle. TMA's zero fill is the zero pad
//   and covers channels past a part, images past the batch and columns
//   past 4 Co. One mbarrier a stage for its bytes, one for its release
//   by the 8 consumer warps.
// - Products: wgmma.mma_async m64nBNk16 f32.bf16.bf16 with A from
//   registers and B by descriptor: B is MN-major (output columns
//   contiguous, the transpose flag), so the weights need no re-layout.
//   A is the tap-shifted 16 x 16 fragment a warp loads by ldmatrix from
//   the halo: a tap is another row address into the same halo, the edge
//   form clamps the pixel each row address names (the halo is never
//   patched), and the LeakyReLU is applied in registers (leaky2), so no
//   pass over shared memory and no block barrier is needed. A k16 step
//   is 4 wgmmas (one a tap) in one commit group; two fragment sets and
//   accumulators take turns, so a step's loads and the sum of the step
//   before it overlap the products in flight. One commit group a tap
//   (half the fragment registers) measured 6 % slower.
// - Accuracy: the tensor cores do not round their f32 accumulation to
//   nearest. One accumulator carried through all K/16 steps (128 at K =
//   2048) drifted from the exact sum far enough to flip the bf16
//   rounding of outputs in [4, 8), whose ulp (0.031) exceeds the 3e-2
//   tolerance (seen with this kernel's earlier mma.sync form). So each
//   k16 step (K = 64: 4 taps x 16 channels) is summed in a fresh
//   accumulator (wgmma's scale-d off on its first tap) and added to the
//   running sum in f32 round-to-nearest, step by step. A fresh
//   accumulator a 32-channel stage (K = 128) ran up to 4 % faster but
//   left more outputs off the rounded f64 value than the mma.sync form
//   at a K = 2048 step; chip_smoke.py counts them ([accuracy],
//   --compare-tc).
// - Epilogue: the f32 affine with two roundings (__fmul_rn, __fadd_rn),
//   the cast, and bf16 pairs stored at their depth-to-space addresses
//   straight from the accumulators.
// - Host: the tensor maps (one a part, one for w4) are encoded each call
//   by libcuda's cuTensorMapEncodeTiled, looked up at run time (no
//   -lcuda).
// - ptxas (sm_90a, CUDA 12.8): 168 registers a thread at entry, the
//   consumers raised to 240; no stack frame, no spill in either
//   instance. Dynamic shared memory at 16 x 8 tiles: 216,192 bytes at
//   BN 128 (5 stages of 43,008), 214,144 at BN 64 (4 of 53,248).

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int B_ROWS = 32;         // K rows (channels) a weight box
constexpr int BM = 128;            // positions a tile: 2 warpgroups x 64
constexpr int NT = 384;            // 2 consumer warpgroups, 1 producer
constexpr int B_COLS = 64;         // columns a weight box: 128 bytes
constexpr int B_BOX = B_COLS * B_ROWS * 4 * 2;  // 64 cols x 32 x 4 taps
constexpr int MAX_STAGES = 8;
constexpr int SMEM_CAP = 232448;   // a block's dynamic maximum
constexpr int EMPTY_ARRIVALS = 8;  // consumer warps

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

struct KParams {
  const float* scale4;
  const float* bias4;
  __nv_bfloat16* out;
  int n, h, w, co, ci0, nq0, nq;
  int tw, th, nb, tiles_x, tiles_y, n_ct, units;
  int stages, a_slot, stage_bytes, a_bytes;
  int leaky, zero_pad;
};

__device__ __host__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// a (CK channels x tw+1 x th+1 x nb) box of a part's map (C, W, H, N)
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

// a (64 columns x 32 rows x 4 taps) box of w4's map (4 Co, Ci, 4)
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int tap) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(tap)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// the wgmma descriptor of an MN-major B tile with the 128-byte swizzle:
// 128-byte rows of 64 output columns, one a K row; 8-row groups 1024
// bytes apart (SBO); the next 64 columns one weight box further (LBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(B_BOX >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// registers move from the producer warpgroup to the consumers: at one
// block an SM, 128 x 24 + 256 x 240 of the SM's 65,536
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers at this point of the program: the compiler moves no
// read or write of an accumulator across it, and keeps an A fragment's
// registers (read by an asynchronous wgmma) from reuse before it
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// d (+)= A (64 x 16, this warpgroup's registers) * B (16 x N, an MN-major
// descriptor); acc 0 ignores d. Thread t of the warpgroup holds d[4j + e]
// at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8j + 2 (t % 4) +
// e % 2; a[] is mma.sync's m16n8k16 A fragment of its warp's 16 rows.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

// one unit of work: phase (pr, pc) of the output channels c0 .. c0+BN-1
// at a tile of th x tw positions of nb images from (b0, i0, j0)
struct Unit {
  int b0, i0, j0, pr, pc, c0;
};

template <int BN>
__device__ __forceinline__ Unit unit_at(const KParams& p, int u) {
  const int ct = u % p.n_ct, r = u / p.n_ct;
  const int ph = r & 3, tile = r >> 2;
  const int tx = tile % p.tiles_x, r2 = tile / p.tiles_x;
  const int ty = r2 % p.tiles_y, g = r2 / p.tiles_y;
  return Unit{g * p.nb, ty * p.th, tx * p.tw, ph >> 1, ph & 1, ct * BN};
}

// BN output channels a unit, CK input channels a stage
template <int BN, int CK>
__global__ void __launch_bounds__(NT, 1)
    decoder_upsample_tc_kernel(const __grid_constant__ CUtensorMap map0,
                               const __grid_constant__ CUtensorMap map1,
                               const __grid_constant__ CUtensorMap wmap,
                               const KParams p) {
  constexpr int R = BN / 2;          // accumulators a thread
  constexpr int PIX = 2 * CK;        // bytes of a halo pixel in a stage
  constexpr int NKS = CK / 16;       // k16 steps a stage
  constexpr int BC = BN / B_COLS;    // weight boxes along the columns
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle follows address bits: stages start 1024-aligned
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + p.stages * p.stage_bytes;  // 8 bytes each
  const uint32_t empty = full + 8 * MAX_STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, EMPTY_ARRIVALS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int my_units =
      (p.units - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (warp >= 8) {
    // producer: one thread keeps the ring full, across this block's units
    producer_registers();
    if (warp != 8 || lane != 0) return;
    const uint32_t bytes = p.a_bytes + BC * (CK / B_ROWS) * B_BOX;
    int k = 0;
    for (int t = 0; t < my_units; ++t) {
      const Unit u = unit_at<BN>(p, blockIdx.x + t * gridDim.x);
      const int col = (2 * u.pr + u.pc) * p.co + u.c0;
      for (int q = 0; q < p.nq; ++q, ++k) {
        const int s = k % p.stages;
        if (k >= p.stages) mbar_wait(empty + 8 * s, (k / p.stages - 1) & 1);
        const bool first = q < p.nq0;
        const int cq = (first ? q : q - p.nq0) * CK;
        const int row = (first ? 0 : p.ci0) + cq;  // w4 row of channel cq
        const uint32_t dst = base + s * p.stage_bytes, bar = full + 8 * s;
        mbar_arrive_expect_tx(bar, bytes);
        tma_load_4d(dst, first ? &map0 : &map1, bar, cq, u.j0 + u.pc - 1,
                    u.i0 + u.pr - 1, u.b0);
#pragma unroll
        for (int hb = 0; hb < BC * (CK / B_ROWS); ++hb)
          tma_load_3d(dst + p.a_slot + hb * B_BOX, &wmap, bar,
                      col + (hb % BC) * B_COLS, row + (hb / BC) * B_ROWS,
                      0);
      }
    }
    return;
  }

  consumer_registers();
  // consumers: warpgroup wg owns tile positions 64 wg .. 64 wg + 63; this
  // lane's ldmatrix row is position `pos`, its 16-byte piece of a k16
  // step lane / 16
  const int wg = warp >> 2;

  float acc[R], part[2][R];
  int k = 0;
  for (int t = 0; t < my_units; ++t) {
    const int unit = blockIdx.x + t * gridDim.x;
    // the halo pixel each tap's ldmatrix row reads, as its byte offset
    // with this lane's piece (lane / 16, bit 4) set: the swizzle XORs a
    // piece index with the pixel's address bits 7 and up; the edge form
    // clamps the input pixel to the image. The unit and this lane's
    // position are decoded again each unit, so that they hold no
    // registers during the K loop.
    uint32_t off[4];
    {
      const Unit u = unit_at<BN>(p, unit);
      const int pos = 64 * wg + 16 * (warp & 3) + (lane & 15);
      const int pc_ = pos % p.tw, pr_ = (pos / p.tw) % p.th;
      const int pb = pos / (p.tw * p.th);
      const int hw = p.tw + 1, hh = p.th + 1;  // halo box columns, rows
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        int hr = pr_ + (tap >> 1), hc = pc_ + (tap & 1);
        if (!p.zero_pad) {
          hr = min(max(hr, 1 - u.i0 - u.pr), p.h - u.i0 - u.pr);
          hc = min(max(hc, 1 - u.j0 - u.pc), p.w - u.j0 - u.pc);
        }
        off[tap] = static_cast<uint32_t>(((pb * hh + hr) * hw + hc) * PIX) |
                   ((lane >> 4) << 4);
      }
    }

    for (int q = 0; q < p.nq; ++q, ++k) {
      const int s = k % p.stages;
      const uint32_t sa = base + s * p.stage_bytes, sb = sa + p.a_slot;
      mbar_wait(full + 8 * s, (k / p.stages) & 1);
      // k16 step ks: the tap-shifted 16 x 16 fragment of each tap, by
      // ldmatrix from the halo (the swizzle TMA wrote), LeakyReLU'd; the
      // step's sum in a fresh accumulator (scale-d off on tap 0), one
      // commit group a step. Two fragment sets and accumulators take
      // turns: before step ks reuses step ks - 2's, that step's products
      // are waited for and its sum added to acc in f32 round-to-nearest
      // (see the note), while step ks - 1's products run.
      uint32_t a[2][4][4];
#pragma unroll
      for (int ks = 0; ks < NKS + 2; ++ks) {
        const int x = ks & 1;
        if (ks >= 2) {
          if (ks < NKS + 1) {
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
            __syncwarp();  // the stage is read: back to the producer
            if (lane == 0) mbar_arrive(empty + 8 * s);
          }
          pin(part[x]);
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) pin(a[x][tap]);
          const bool first = q == 0 && ks == 2;
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i] = first ? part[x][i] : __fadd_rn(acc[i], part[x][i]);
        }
        if (ks >= NKS) continue;
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const uint32_t o = off[tap];
          ldmatrix_x4(a[x][tap],
                      sa + (o ^ (((2 * ks) ^ ((o >> 7) & (PIX / 16 - 1)))
                                 << 4)));
          if (p.leaky) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[x][tap][e] = leaky2(a[x][tap][e]);
          }
        }
        wgmma_fence();
        // the weights of step ks: row box ks / 2, its rows 16 (ks % 2) ..
        const uint32_t sbk = sb + (ks / 2) * BC * B_BOX + (ks % 2) * 2048;
#pragma unroll
        for (int tap = 0; tap < 4; ++tap)
          Wgmma<BN>::mma(part[x], a[x][tap],
                         b_desc(sbk + tap * (B_ROWS * 128)), tap);
        wgmma_commit();
      }
    }

    // epilogue: affine on the f32 sums, cast, depth-to-space store.
    // Accumulator 4j + e sits at warpgroup row 16 (warp % 4) + lane / 4 +
    // 8 (e / 2) and column 8j + 2 (lane % 4) + e % 2.
    const Unit u = unit_at<BN>(p, unit);
    const int phase = 2 * u.pr + u.pc;
    const int64_t h2 = 2 * static_cast<int64_t>(p.h), w2 = 2 * p.w;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * half;
      const int i = u.i0 + (m / p.tw) % p.th, j = u.j0 + m % p.tw;
      const int b = u.b0 + m / (p.tw * p.th);
      if (i >= p.h || j >= p.w || b >= p.n) continue;
      __nv_bfloat16* o =
          p.out + ((b * h2 + 2 * i + u.pr) * w2 + 2 * j + u.pc) * p.co;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int oc = u.c0 + 8 * jb + 2 * (lane & 3);
        if (oc >= p.co) continue;  // co % 8 == 0: oc + 1 < co as well
        float v0 = acc[4 * jb + 2 * half], v1 = acc[4 * jb + 2 * half + 1];
        if (p.scale4 != nullptr) {  // two roundings, as the plain version
          const float* s4 = p.scale4 + phase * p.co + oc;
          const float* b4 = p.bias4 + phase * p.co + oc;
          v0 = __fadd_rn(__fmul_rn(v0, s4[0]), b4[0]);
          v1 = __fadd_rn(__fmul_rn(v1, s4[1]), b4[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(o + oc) =
            __floats2bfloat162_rn(v0, v1);
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

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

int pow2_at_least(int v) {
  int r = 1;
  while (r < v) r *= 2;
  return r;
}

// the launch: tile, units, blocks, ring and dynamic shared memory
struct Plan {
  int tw, th, nb, tiles_x, tiles_y, n_ct, units, grid;
  int stages, a_slot, a_bytes, stage_bytes, smem;
};

bool make_plan(const Params& p, int bn, int ck, int sms, Plan* q) {
  q->tw = p.w > 8 ? 16 : 8;
  q->th = std::min(pow2_at_least(p.h), BM / q->tw);
  q->nb = BM / (q->tw * q->th);
  q->tiles_x = (p.w + q->tw - 1) / q->tw;
  q->tiles_y = (p.h + q->th - 1) / q->th;
  q->n_ct = (p.co + bn - 1) / bn;
  const int64_t units = static_cast<int64_t>(q->tiles_x) * q->tiles_y *
                        ((p.n + q->nb - 1) / q->nb) * 4 * q->n_ct;
  if (units > INT_MAX) return false;
  q->units = static_cast<int>(units);
  q->grid = std::min(q->units, sms);
  q->a_bytes = (q->tw + 1) * (q->th + 1) * q->nb * 2 * ck;
  q->a_slot = (q->a_bytes + 1023) / 1024 * 1024;
  q->stage_bytes = q->a_slot + (bn / B_COLS) * (ck / B_ROWS) * B_BOX;
  q->stages = std::min(MAX_STAGES,
                       (SMEM_CAP - 1024 - 16 * MAX_STAGES) / q->stage_bytes);
  q->smem = 1024 + q->stages * q->stage_bytes + 16 * MAX_STAGES;
  return q->stages >= 2;
}

// a part's 4-D map (C, W, H, N), boxes of ck channels x tw+1 x th+1 x nb,
// a pixel's 2 ck bytes under the swizzle of that width
bool encode_part(CUtensorMap* map, EncodeTiled encode, const void* x,
                 int cip, int ck, const Params& p, const Plan& q) {
  const cuuint64_t c = cip, e = 2;
  const cuuint64_t dims[4] = {c, static_cast<cuuint64_t>(p.w),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[3] = {c * e, c * e * p.w, c * e * p.w * p.h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(ck),
                             static_cast<cuuint32_t>(q.tw + 1),
                             static_cast<cuuint32_t>(q.th + 1),
                             static_cast<cuuint32_t>(q.nb)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                ck == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w4 as a 3-D map (4 Co, Ci, 4 taps), boxes of 64 columns x 32 x 4
bool encode_weights(CUtensorMap* map, EncodeTiled encode, const Params& p) {
  const cuuint64_t n4 = 4 * static_cast<cuuint64_t>(p.co),
                   ci = p.ci0 + p.ci1;
  const cuuint64_t dims[3] = {n4, ci, 4};
  const cuuint64_t strides[2] = {n4 * 2, n4 * 2 * ci};
  const cuuint32_t box[3] = {B_COLS, B_ROWS, 4};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p.w4), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int CK>
int launch(const Params& p, cudaStream_t stream) {
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  Plan q{};
  if (!make_plan(p, BN, CK, sms, &q))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q.units == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map0{}, map1{}, wmap{};
  if ((p.ci0 > 0 && !encode_part(&map0, encode, p.x0, p.ci0, CK, p, q)) ||
      (p.ci1 > 0 && !encode_part(&map1, encode, p.x1, p.ci1, CK, p, q)) ||
      !encode_weights(&wmap, encode, p))
    return static_cast<int>(cudaErrorInvalidValue);
  KParams k{};
  k.scale4 = p.scale4;
  k.bias4 = p.bias4;
  k.out = static_cast<__nv_bfloat16*>(p.out);
  k.n = p.n;
  k.h = p.h;
  k.w = p.w;
  k.co = p.co;
  k.ci0 = p.ci0;
  k.nq0 = (p.ci0 + CK - 1) / CK;
  k.nq = k.nq0 + (p.ci1 + CK - 1) / CK;
  k.tw = q.tw;
  k.th = q.th;
  k.nb = q.nb;
  k.tiles_x = q.tiles_x;
  k.tiles_y = q.tiles_y;
  k.n_ct = q.n_ct;
  k.units = q.units;
  k.stages = q.stages;
  k.a_slot = q.a_slot;
  k.stage_bytes = q.stage_bytes;
  k.a_bytes = q.a_bytes;
  k.leaky = p.leaky;
  k.zero_pad = p.zero_pad;
  const cudaError_t set = cudaFuncSetAttribute(
      decoder_upsample_tc_kernel<BN, CK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  decoder_upsample_tc_kernel<BN, CK><<<q.grid, NT, q.smem, stream>>>(
      map0, map1, wmap, k);
  return static_cast<int>(cudaGetLastError());
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
      ci0 + ci1 <= 0 || !aligned16(x0) || !aligned16(x1) ||
      !aligned16(w4) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x0,
                 x1,
                 ci0,
                 ci1,
                 w4,
                 static_cast<const float*>(scale4),
                 static_cast<const float*>(bias4),
                 out,
                 n,
                 h,
                 w,
                 co,
                 leaky,
                 zero_pad};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return co > 64 ? launch<128, 32>(p, s) : launch<64, 64>(p, s);
}
