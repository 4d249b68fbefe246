// 3x3, stride-1, SAME convolution as an implicit GEMM on the bf16 tensor
// cores, for Hopper (sm_90a).
//
// Replaces tools/proto_pallas_conv.py::conv_pallas (_tap_kernel for
// Cin >= 128, _im2col_kernel for Cin < 128).  x is (B, H, W, Cin) bf16, the
// NHWC view of a channels_last map; w is (3, 3, Cin, Cout) HWIO bf16, read
// as the (9 Cin, Cout) row-major matrix of w.reshape(9 * Cin, Cout); y is
// (B, H, W, Cout) bf16.  With M = B H W output pixels, N = Cout and
// K = 9 Cin in tap-major order (k = (ky * 3 + kx) * Cin + ci):
//   y[p, n] = bf16(sum_k A[p, k] w[k, n]),  A[p, k] = x[b, y+ky-1, x+kx-1, ci]
// with fp32 accumulation and one rounding at the end.  The TPU kernel's flat
// (H+2)(W+2) rows, junk columns, images per step and its two MXU paths are
// TPU idioms; one kernel here serves every Cin that is a multiple of 16.
//
// What bounds it: operations, all but evenly with bytes at the first stage.
// At the probe's geometries it does 2 M N K = 86-207 GFLOP per call on
// 51-719 MB: 0.087-0.209 ms at 989 TFLOP/s bf16 dense, against
// 0.015-0.215 ms for its bytes at 3.35 TB/s (bytes win only at the two
// Cin = 64 geometries, by 3%).
//
// Design (a right, simple first kernel; wgmma, TMA and a deeper pipeline are
// later work): a block of 256 threads (8 warps) computes a 128 x BN tile of
// y (BN = 64 for Cout <= 64, else 128), walking K in steps of 32.  Each step
// stages a 128 x 32 tile of A and a 32 x BN tile of w in shared memory with
// 16-byte cp.async copies, double-buffered so the next step's copies fly
// while this step computes.  The halo is masked in the kernel: an A chunk
// (8 channels of one tap of one pixel) whose source pixel lies outside its
// image (or a K or M tail) is a zero-filling cp.async of 0 source bytes, so
// no padded copy of x is made and pixel (y, W-1) never reads (y+1, 0).
// Warps read the A fragments with ldmatrix and the w fragments with
// ldmatrix.trans (w is K x N row-major; mma wants B column-major), and run
// mma.sync.m16n8k16 bf16 with fp32 accumulators.  Shared rows are padded by
// 16 bytes, so the 8 rows of an ldmatrix phase fall in distinct banks.
// Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 2;
constexpr int kLda = kBK + 8;  // A row in shared memory, bf16 elements

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ y, int64_t m, int h, int wd, int cin,
               int cout) {
  constexpr int kWarpsN = BN / 32;            // a warp's tile is 32 wide
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWarpM = kBM / kWarpsM;       // 32 or 64 rows
  constexpr int kMi = kWarpM / 16;            // m16 tiles per warp
  constexpr int kNi = 4;                      // n8 tiles per warp
  constexpr int kLdb = BN + 8;                // w row in shared memory
  constexpr int kBChunksRow = BN / 8;
  constexpr int kBIters = kBK * kBChunksRow / kThreads;
  constexpr int kARows = kThreads / (kBK / 8);  // rows one pass of A covers
  constexpr int kAIters = kBM / kARows;
  static_assert(kBIters * kThreads == kBK * kBChunksRow, "B tile split");

  __shared__ __align__(16) bf16 sa[kStages][kBM * kLda];
  __shared__ __align__(16) bf16 sb[kStages][kBK * kLdb];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int k_total = 9 * cin;

  // This thread's A chunks: channel chunk a_chunk of rows a_row + i kARows.
  const int a_chunk = tid % (kBK / 8);
  const int a_row = tid / (kBK / 8);
  const int hw = h * wd;
  int64_t a_base[kAIters];
  int a_y[kAIters], a_x[kAIters];
  bool a_ok[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int64_t p = m0 + a_row + i * kARows;
    a_ok[i] = p < m;
    const int64_t img = p / hw;
    const int rem = (int)(p - img * hw);
    a_y[i] = rem / wd;
    a_x[i] = rem - a_y[i] * wd;
    a_base[i] = p * cin;
  }
  // the tap and channel of this thread's chunk at the current K step
  int a_tap = 0, a_ci = a_chunk * 8;
  while (a_ci >= cin) { a_ci -= cin; ++a_tap; }

  auto load_tile = [&](int stage, int k0) {
    const int ky = a_tap / 3;
    const int dy = ky - 1;
    const int dx = a_tap - 3 * ky - 1;
    const int64_t shift = ((int64_t)dy * wd + dx) * cin + a_ci;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int iy = a_y[i] + dy;
      const int ix = a_x[i] + dx;
      const bool valid = a_ok[i] && a_tap < 9 && iy >= 0 && iy < h &&
                         ix >= 0 && ix < wd;
      const bf16* src = valid ? x + a_base[i] + shift : x;
      cp_async16(smem_addr(&sa[stage][(a_row + i * kARows) * kLda +
                                      a_chunk * 8]),
                 src, valid);
    }
    a_ci += kBK;
    while (a_ci >= cin) { a_ci -= cin; ++a_tap; }
#pragma unroll
    for (int j = 0; j < kBIters; ++j) {
      const int c = tid + j * kThreads;
      const int row = c / kBChunksRow;
      const int col = (c % kBChunksRow) * 8;
      const int k = k0 + row;
      const bool valid = k < k_total && n0 + col < cout;
      const bf16* src = valid ? w + (int64_t)k * cout + n0 + col : w;
      cp_async16(smem_addr(&sb[stage][row * kLdb + col]), src, valid);
    }
  };

  float acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (k_total + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) load_tile((kt + 1) % kStages, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tile has landed
    __syncthreads();
    const bf16* a_s = sa[kt % kStages];
    const bf16* b_s = sb[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMi][4];
      uint32_t bfr[kNi][2];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const int row = warp_m * kWarpM + i * 16 + (lane % 16);
        const int col = kk + (lane / 16) * 8;
        ldmatrix_x4(af[i], smem_addr(a_s + row * kLda + col));
      }
#pragma unroll
      for (int j = 0; j < kNi / 2; ++j) {
        const int row = kk + (lane % 16);
        const int col = warp_n * 32 + j * 16 + (lane / 16) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(b_s + row * kLdb + col));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // accumulator (i, j): rows lane / 4 and lane / 4 + 8 of the m16 tile,
  // columns 2 (lane % 4) and the next of the n8 tile
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
#pragma unroll
    for (int j = 0; j < kNi; ++j) {
      const int col = n0 + warp_n * 32 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row =
            m0 + warp_m * kWarpM + i * 16 + lane / 4 + half * 8;
        if (row < m && col < cout) {
          *reinterpret_cast<__nv_bfloat162*>(y + row * cout + col) =
              __floats2bfloat162_rn(acc[i][j][2 * half],
                                    acc[i][j][2 * half + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (b, h, w, cin) bf16; wt: (9 cin, cout) bf16 row-major (HWIO); y:
// (b, h, w, cout) bf16; all contiguous and 16-byte aligned, cin and cout
// multiples of 16.  Returns a cudaError_t.
int mmct_conv3x3(const void* x, const void* wt, void* y, int b, int h, int w,
                 int cin, int cout, void* stream) {
  const int64_t m = (int64_t)b * h * w;
  const int64_t m_tiles = (m + kBM - 1) / kBM;
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 16 ||
      cout % 16 || (int64_t)h * w > INT32_MAX || m_tiles > INT32_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wt);
  bf16* yp = static_cast<bf16*>(y);
  if (cout <= 64) {
    conv3x3_kernel<64><<<dim3((unsigned)m_tiles, (cout + 63) / 64), kThreads,
                         0, s>>>(xp, wp, yp, m, h, w, cin, cout);
  } else {
    conv3x3_kernel<128><<<dim3((unsigned)m_tiles, (cout + 127) / 128),
                          kThreads, 0, s>>>(xp, wp, yp, m, h, w, cin, cout);
  }
  return (int)cudaGetLastError();
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
