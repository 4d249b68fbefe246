// 3x3, stride-1, SAME convolution as an implicit GEMM on Hopper's bf16
// tensor cores (sm_90a): wgmma from shared memory, fed through an mbarrier
// ring by a producer warpgroup that loads with TMA.
//
// Replaces tools/proto_pallas_conv.py::conv_pallas (_tap_kernel for
// Cin >= 128, _im2col_kernel for Cin < 128).  x is (B, H, W, Cin) bf16, the
// NHWC view of a channels_last map; w is (3, 3, Cin, Cout) HWIO bf16, read
// as the (9 Cin, Cout) row-major matrix of w.reshape(9 * Cin, Cout); y is
// (B, H, W, Cout) bf16.  With M = B H W output pixels, N = Cout and
// K = 9 Cin in tap-major order (k = (ky * 3 + kx) * Cin + ci):
//   y[p, n] = bf16(sum_k A[p, k] w[k, n]),  A[p, k] = x[b, y+ky-1, x+kx-1, ci]
// with fp32 accumulation in a fixed K order and one rounding at the end (no
// split-K, no atomics: two launches give the same bits).  Cin and Cout are
// multiples of 16; any B, H, W.
//
// What bounds it on the H100: operations.  At the probe's geometries it
// does 2 M N K = 86-207 GFLOP per call: 0.087-0.209 ms at 989 TFLOP/s bf16
// dense, against 0.015-0.215 ms for its bytes at 3.35 TB/s.  Only wgmma
// reaches the tensor cores' full rate, and only if loads never stall it;
// the A tile is an im2col gather that reads each input pixel nine times,
// from L2.
//
// Design.  A persistent grid (one block per SM) walks BM x BN output tiles,
// N-tiles of one M-tile next to each other.  A block is three warpgroups:
// warpgroup 2 produces, warpgroups 0 and 1 consume (setmaxnreg moves
// registers from the first to the others).  K goes in steps of 64 bf16
// (128 bytes: one tap of 64 channels at Cin >= 64) through a ring of as
// many stages as shared memory holds (5 at BN = 128, 4 at BN = 64), each
// with a full and an empty mbarrier; no __syncthreads in the main loop.
// - B (the weights): TMA loads of 64 x 64 boxes of the (9 Cin, Cout)
//   matrix, 128-byte swizzled; rows past K and columns past Cout arrive as
//   zeros.  B is N-contiguous, so the wgmma descriptor declares it MN-major
//   (trans-b): 8-row K groups 1024 bytes apart, 64-wide N blocks 8192
//   bytes apart.
// - A at Cin a multiple of 64: one thread loads each K step as a TMA
//   im2col box (cuTensorMapEncodeIm2col over x as (B, H, W, Cin)): BM
//   pixels from the tile's first, each shifted by the tap, 64 channels, the
//   corner box of SAME padding, so pixels outside their image arrive as
//   zeros; 128-byte swizzled.  The producer issues no per-row work, and the
//   copy engine, not the LSU, moves the bytes.
// - A at other Cin (16, 32, 48, 80, ...: a K step spans taps): the
//   producer's 128 threads gather it with 16-byte cp.async, each a fixed
//   8-channel chunk of BM / 16 rows whose pixel it decodes once per tile; a
//   chunk whose source pixel lies outside its image, or past K or M, is a
//   zero-filling copy of 0 bytes.  Chunk c of row r lands at chunk
//   c ^ (r % 8) of its 128-byte row, the swizzle the K-major descriptor
//   declares; completion is counted on the stage's full barrier by
//   cp.async.mbarrier.arrive.noinc, and consumers fence the proxy.
// - Consumers: BN = 128 for Cout > 64, each consumer warpgroup 64 rows with
//   wgmma m64n128k16 (BM = 128); BN = 64 for Cout <= 64, each 128 rows as
//   two m64n64k16 tiles (BM = 256), so each B tile feeds as much math as at
//   BN = 128.  Per stage: wait full, four k16 steps, commit, wait until one
//   group is in flight, release the previous stage.
// - Epilogue: fp32 -> bf16 once, into a padded shared tile per warpgroup
//   (its own, so the producer keeps loading the next tile), then 16-byte
//   stores with the M and N tails masked.  Storing straight from the
//   accumulators (half-sector stores) ran slower in a trial build.
//
// Measured by chip_smoke.py (phase 10) on an NVIDIA H100 80GB HBM3 at
// 700.00 W: 2.0849 ms for one call at each of the 8 probe geometries
// (bound 1.2246 ms, cuDNN 1.9264, the earlier mma.sync design 5.0286), 42%
// of the bf16 peak at Cin = 64 and 60-73% above.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
constexpr int kBK = 64;                           // bf16: 128 bytes
constexpr int kProducerRegs = 56;   // 168 at entry (384 threads, 1 block)
constexpr int kConsumerRegs = 224;  // 128 * (168 - 56) = 256 * (224 - 168)
constexpr int kBox = 64;            // TMA box: 64 x 64 bf16, 8 KB
constexpr int kMaxSmem = 232448;
// a barrier wait that lasts this long (ns) traps: a lost arrival is a
// launch error, not a hung card
constexpr uint64_t kWaitLimitNs = 2000000000ull;

template <int BM, int BN>
struct Tile {
  static constexpr int kWgRows = BM / kConsumers;  // 64 or 128
  static constexpr int kMmas = kWgRows / 64;       // m64 tiles per warpgroup
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kEpiLd = BN + 8;  // bf16: rows 16 bytes apart in banks
  static constexpr int kEpiBytes = kConsumers * kWgRows * kEpiLd * 2;
  // as many stages as shared memory holds: 5 at 128 x 128, 4 at 256 x 64
  static constexpr int kStages =
      (kMaxSmem - 1024 - kEpiBytes - 256) / kStageBytes;
  static constexpr int kBarOffset = kStages * kStageBytes + kEpiBytes;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;
  static constexpr int kRowsPerThread = BM / 16;  // producer: 8 chunks a row
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle atoms");
  static_assert(kSmem <= kMaxSmem, "shared memory");
  static_assert(kRowsPerThread <= 16, "room bits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// 16 bytes from src, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// one arrival on `bar` when this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// an im2col box: BM pixels from (w, h, n) on, each shifted by the tap's
// (ow, oh), c .. c + 63 of each; pixels outside their image read as zeros
__device__ __forceinline__ void tma_im2col_4d(uint32_t dst,
                                              const CUtensorMap* map, int c,
                                              int w, int h, int n,
                                              uint16_t ow, uint16_t oh,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w),
         "r"(h), "r"(n), "r"(bar), "h"(ow), "h"(oh)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// B's K step ks, columns n0 .. n0 + BN: BN / 64 TMA boxes of 64 x 64
template <int BN>
__device__ __forceinline__ void load_b(uint32_t dst, const CUtensorMap* map,
                                       int n0, int ks, uint32_t bar) {
#pragma unroll
  for (int half = 0; half < BN / kBox; ++half) {
    tma_load_2d(dst + half * kBox * kBK * 2, map, n0 + kBox * half, ks * kBK,
                bar);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, fp32) += A (64 x 16, K-major) B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, K-major) B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a,
                                          uint64_t b) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, a, b);
  } else {
    wgmma_m64n128(d, a, b);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap xmap, int a_tma,
               const bf16* __restrict__ x, bf16* __restrict__ y, int64_t m,
               int h, int wd, int cin, int cout, int n_tiles, int num_tiles) {
  using T = Tile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms (8 rows of 128 bytes) must start 1024-aligned
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t bars = base + T::kBarOffset;
  constexpr int kStages = T::kStages;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int k_tiles = (9 * cin + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival, and in the gather, the 128 copiers'
      mbar_init(full(s), a_tma ? 1 : 128 + 1);
      mbar_init(empty(s), kConsumers);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: B by TMA; A by im2col TMA, or gathered by cp.async ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int t = tid - 128 * kConsumers;
    const int hw = h * wd;
    if (a_tma) {
      // Cin a multiple of 64: a K step is one tap of 64 channels, and one
      // thread loads A as an im2col box and B as two tiles
      if (t == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
          const int64_t m0 = (int64_t)(tile / n_tiles) * BM;
          const int n0 = (tile % n_tiles) * BN;
          const int img = (int)(m0 / hw);
          const int rem = (int)(m0 - (int64_t)img * hw);
          const int py = rem / wd, px = rem % wd;
          int tap = 0, c0 = 0;
          for (int ks = 0; ks < k_tiles; ++ks) {
            mbar_wait(empty(stage), phase ^ 1);
            const uint32_t a_s = base + stage * T::kStageBytes;
            const uint32_t b_s = a_s + T::kABytes;
            mbar_arrive_expect_tx(full(stage), T::kStageBytes);
            load_b<BN>(b_s, &wmap, n0, ks, full(stage));
            // the box's corner is one pixel up and left of the output
            // pixel (the SAME padding); the tap offsets it by (kx, ky)
            tma_im2col_4d(a_s, &xmap, c0, px - 1, py - 1, img,
                          (uint16_t)(tap % 3), (uint16_t)(tap / 3),
                          full(stage));
            c0 += kBK;
            if (c0 == cin) { c0 = 0; ++tap; }
            if (++stage == kStages) { stage = 0; phase ^= 1; }
          }
        }
      }
    } else {
      const int chunk = t % 8;  // this thread's 16-byte chunk of every row
      const int row0 = t / 8;   // its rows: row0 + 16 i
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const int64_t m0 = (int64_t)(tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        // per row, 4 bits of room around its pixel (a row above, below, a
        // column left, right), and whether the row is inside M: 3 registers
        // (one division for the first row, then steps of 16 pixels)
        uint64_t room = 0;
        uint32_t row_ok = 0;
        const int64_t p0 = m0 + row0;
        const int rem = (int)(p0 % hw);
        int py = rem / wd, px = rem % wd;
#pragma unroll
        for (int i = 0; i < T::kRowsPerThread; ++i) {
          const uint64_t bits =
              (uint64_t)(py > 0) | (uint64_t)(py < h - 1) << 1 |
              (uint64_t)(px > 0) << 2 | (uint64_t)(px < wd - 1) << 3;
          room |= bits << (4 * i);
          row_ok |= (uint32_t)(p0 + 16 * i < m) << i;
          px += 16;
          while (px >= wd) { px -= wd; ++py; }
          while (py >= h) py -= h;
        }
        // the tap and channel of this thread's chunk at the current K step
        int tap = 0, ci = chunk * 8;
        while (ci >= cin) { ci -= cin; ++tap; }
        for (int ks = 0; ks < k_tiles; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t a_s = base + stage * T::kStageBytes;
          if (t == 0) {
            mbar_arrive_expect_tx(full(stage), T::kBBytes);
            load_b<BN>(a_s + T::kABytes, &wmap, n0, ks, full(stage));
          }
          const int ky = tap / 3;
          const int dy = ky - 1;
          const int dx = tap - 3 * ky - 1;
          // this K step's source of row row0; row row0 + 16 i is 16 i cin
          // elements further
          const bf16* src0 =
              x + (m0 + row0 + (int64_t)dy * wd + dx) * cin + ci;
          const int64_t step = 16 * (int64_t)cin;
          // the room this tap needs; past K (tap 9) nothing is valid
          const uint32_t need = (uint32_t)(dy < 0) | (uint32_t)(dy > 0) << 1 |
                                (uint32_t)(dx < 0) << 2 |
                                (uint32_t)(dx > 0) << 3;
          const uint32_t ok = tap < 9 ? row_ok : 0u;
          const uint32_t dst0 =
              a_s + row0 * 128 + ((chunk ^ (row0 & 7)) << 4);
#pragma unroll
          for (int i = 0; i < T::kRowsPerThread; ++i) {
            const bool valid = ((ok >> i) & 1) &&
                               (((uint32_t)(room >> (4 * i)) & need) == need);
            cp_async16(dst0 + i * 2048, valid ? src0 + i * step : x, valid);
          }
          cp_async_arrive(full(stage));
          ci += kBK;
          while (ci >= cin) { ci -= cin; ++tap; }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the stages that have landed ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[T::kMmas][BN / 2];
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const int64_t m0 = (int64_t)(tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
#pragma unroll
      for (int mi = 0; mi < T::kMmas; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < k_tiles; ++ks) {
        mbar_wait(full(stage), phase);
        // a gathered A tile came by cp.async (generic proxy); wgmma reads
        // it through the async proxy
        if (!a_tma) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        const uint32_t a_s =
            base + stage * T::kStageBytes + wg * T::kWgRows * kBK * 2;
        const uint32_t b_s = base + stage * T::kStageBytes + T::kABytes;
#pragma unroll
        for (int mi = 0; mi < T::kMmas; ++mi) fence_operands(acc[mi]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // B: 16 K rows = two 8-row groups (1024 bytes apart), N blocks of
          // 64 8192 bytes apart; A: 32 bytes further along each 128-byte row
          const uint64_t db = sw128_desc(b_s + kk * 2048, kBox * kBK * 2, 1024);
#pragma unroll
          for (int mi = 0; mi < T::kMmas; ++mi) {
            const uint64_t da = sw128_desc(a_s + mi * 64 * kBK * 2 + kk * 32,
                                           16, 1024);
            wgmma_k16<BN>(acc[mi], da, db);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
        for (int mi = 0; mi < T::kMmas; ++mi) fence_operands(acc[mi]);
        if (prev >= 0 && t == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int mi = 0; mi < T::kMmas; ++mi) fence_operands(acc[mi]);
      if (t == 0) mbar_arrive(empty(prev));

      // accumulator (mi, 4 j + 2 hh + e): row mi 64 + warp 16 + lane / 4 +
      // 8 hh, column 8 j + 2 (lane % 4) + e
      bf16* const epi = reinterpret_cast<bf16*>(
          base_ptr + kStages * T::kStageBytes +
          wg * T::kWgRows * T::kEpiLd * 2);
#pragma unroll
      for (int mi = 0; mi < T::kMmas; ++mi) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = mi * 64 + warp * 16 + lane / 4 + 8 * hh;
            const int col = 8 * j + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(epi + row * T::kEpiLd + col) =
                __floats2bfloat162_rn(acc[mi][4 * j + 2 * hh],
                                      acc[mi][4 * j + 2 * hh + 1]);
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      constexpr int kChunksRow = BN / 8;
      const int64_t row_base = m0 + wg * T::kWgRows;
#pragma unroll 4
      for (int c = t; c < T::kWgRows * kChunksRow; c += 128) {
        const int row = c / kChunksRow;
        const int col = (c % kChunksRow) * 8;
        if (row_base + row < m && n0 + col < cout) {
          *reinterpret_cast<uint4*>(y + (row_base + row) * cout + n0 + col) =
              *reinterpret_cast<const uint4*>(epi + row * T::kEpiLd + col);
        }
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// a driver function from the driver the runtime has loaded: no -lcuda
void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                            &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p
                                                                     : nullptr;
}

template <int BM, int BN>
cudaError_t launch(const CUtensorMap& wmap, const bf16* x, bf16* y, int b,
                   int h, int w, int cin, int cout, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  static bool configured = false;
  auto kernel = conv3x3_kernel<BM, BN>;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  // x as (b, h, w, cin) for im2col boxes of BM pixels, 64 channels
  const int64_t m = (int64_t)b * h * w;
  CUtensorMap xmap = {};
  const int a_tma = cin % kBK == 0;
  if (a_tma) {
    static EncodeIm2colFn encode = reinterpret_cast<EncodeIm2colFn>(
        driver_entry("cuTensorMapEncodeIm2col"));
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)cin * 2,
                                   (cuuint64_t)w * cin * 2,
                                   (cuuint64_t)h * w * cin * 2};
    // the corner box of SAME 3x3: base pixels run from -1 to dim - 2
    const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<bf16*>(x), dims, strides, lower, upper, kBK, BM,
               elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const int64_t m_tiles = (m + BM - 1) / BM;
  const int n_tiles = (cout + BN - 1) / BN;
  if (m_tiles * n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int num_tiles = (int)(m_tiles * n_tiles);
  const int grid = num_tiles < sms ? num_tiles : sms;
  kernel<<<grid, kThreads, T::kSmem, stream>>>(wmap, xmap, a_tma, x, y, m, h,
                                               w, cin, cout, n_tiles,
                                               num_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (b, h, w, cin) bf16; wt: (9 cin, cout) bf16 row-major (HWIO); y:
// (b, h, w, cout) bf16; all contiguous and 16-byte aligned, cin and cout
// multiples of 16.  Returns a cudaError_t.
int mmct_conv3x3(const void* x, const void* wt, void* y, int b, int h, int w,
                 int cin, int cout, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 16 ||
      cout % 16 || (int64_t)h * w > INT32_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  static EncodeTiledFn encode =
      reinterpret_cast<EncodeTiledFn>(driver_entry("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the (9 cin, cout) weight matrix, N innermost; 64 x 64 boxes, 128-byte
  // swizzle; out-of-bounds rows and columns are read as zeros
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * sizeof(bf16)};
  const cuuint32_t box[2] = {kBox, kBK};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(wt), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  const cudaError_t err =
      cout <= 64 ? launch<256, 64>(wmap, xp, yp, b, h, w, cin, cout, s)
                 : launch<128, 128>(wmap, xp, yp, b, h, w, cin, cout, s);
  return (int)err;
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
