// Per-channel batch-norm sums for Hopper (sm_90a), forward and backward.
//
// Replaces multimodal_clinical_tpu/ops/fused_bn.py::_channel_sums_pallas
// (_sums_kernel) and ::_bwd_sums_pallas (_bwd_sums_kernel).  Over the
// (M, C) row-major view of a channels_last feature map (C innermost):
//   forward   out[0][c] = sum_m x,   out[1][c] = sum_m x * x
//   backward  out[0][c] = sum_m dy,  out[1][c] = sum_m dy * (x - mean[c]) * rstd[c]
// accumulated in fp32 from bf16 (the main path) or fp32 inputs.
//
// What bounds it: bytes.  Each element is read once and costs two or
// three fp32 operations, far below the card's ~20 operations per byte of
// fp32 rate over bandwidth.  At the visual stem, (11 239 424, 64) bf16, the
// forward reads 1.44 GB: 0.43 ms at 3.35 TB/s; the backward twice that.
// The towers' stage-4 maps read 23-45 MB, 7-13 us: there a launch, the
// grid's ramp and the fold of the blocks' partial sums cost as much as the
// reads.
//
// Forward design: one launch.  The grid is (row blocks, channel groups of
// kGroupC = 64), persistent: kBlocksPerSM = 2 blocks per SM in all, fewer
// where M is too short to give each thread one full step of loads (the
// wrapper sizes it from the SM count, read once per device).  A block takes a contiguous slab of
// rows of its group: a thread owns 8 channels (one 16-byte load of bf16,
// two of fp32) and one of 256 / (group width / 8) row lanes, and keeps 256
// bytes of loads in flight (16 rows of bf16, 8 of fp32; the loads of a
// slab's ragged end are predicated, not a serial tail).  Little's law at
// 3.35 TB/s over 132 SMs: 25.4 GB/s per SM times a loaded latency of about
// 1 us is ~25 KB in flight per SM; two blocks of 256 threads keep 128 KB.
// The block folds its lanes in shared memory in lane order and writes its
// (2, 64) partial sums; every thread fences them before the block takes an
// integer ticket from its group's counter; the block that draws the
// group's last ticket folds the group's partials in the same launch (warp
// w adds blocks w, w + 8, ... in order, one 16-byte load per lane per
// block, then the warps' runs in warp order) and sets the counter back to
// 0.  No float atomics: two launches on one input agree bit for bit.  The
// partials and counters are scratch the wrapper keeps per (device,
// stream), sized for the largest grid.
//
// Backward design: two launches.  Stage 1: a grid fixed by M and C alone
// (at most kMaxBlocks blocks), each block taking a contiguous slab of rows;
// a thread owns 8 consecutive channels and one of 256 / (C / 8) row lanes,
// walks its slab kUnroll rows at a time, and keeps 16 fp32 sums in
// registers; the block folds its lanes in shared memory in lane order and
// writes its (2, C) partial sums to scratch.  Stage 2 sums the partials of
// all blocks per channel in a fixed order.  No atomics.
//
// Offsets are 64-bit (the largest view on the main path holds 719 M
// elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // channels per thread
constexpr int kMaxC = kThreads * kVec;  // every thread owns at least one row lane
// forward
constexpr int kGroupC = 64;               // channels of one group
constexpr int kOutputs = 2 * kGroupC;     // a group's sums: 64 x, 64 x^2
constexpr int kBlocksPerSM = 2;          // the wrapper's grid: 2 per SM
constexpr int kBytesInFlight = 256;       // per thread
// backward
constexpr int kUnroll = 4;       // rows in flight per thread
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

bool shape_ok(int64_t m, int c) {
  return m > 0 && c > 0 && c % kVec == 0 && c <= kMaxC;
}

// 8 channels of one row as loaded, converted to fp32 only when added, so
// that a thread's loads in flight hold 4 registers (bf16) or 8 (fp32) each
struct RowBf16 {
  uint4 raw;
};
struct RowF32 {
  float4 a, b;
};
template <typename T>
using Row = typename std::conditional<sizeof(T) == 2, RowBf16, RowF32>::type;

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, RowBf16& r) {
  r.raw = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load_row(const float* p, RowF32& r) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ void to_float(const RowBf16& r, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_float(const RowF32& r, float (&v)[kVec]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

// ------------------------------------------------------------- forward

__host__ inline int num_groups(int c) { return (c + kGroupC - 1) / kGroupC; }

// partial: (groups, gridDim.x, kOutputs) fp32 scratch; counters: one uint32
// per group, 0 before the launch and 0 after it; out: (2, c) fp32 = (sum x,
// sum x^2).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sums_fwd_kernel(const T* __restrict__ x, float* partial,
                unsigned int* counters, float* __restrict__ out, int64_t m,
                int c) {
  constexpr int kSteps = kBytesInFlight / (kVec * (int)sizeof(T));  // rows
  __shared__ __align__(16) float fold[2][kThreads * kVec];
  __shared__ bool last;
  const int group = blockIdx.y;
  const int gc0 = group * kGroupC;
  const int width = c - gc0 < kGroupC ? c - gc0 : kGroupC;
  const int vecs = width / kVec;
  const int lanes = kThreads / vecs;
  const int col = threadIdx.x % vecs;
  const int lane = threadIdx.x / vecs;
  const int64_t per_block = (m + gridDim.x - 1) / gridDim.x;
  const int64_t row0 = (int64_t)blockIdx.x * per_block;
  const int64_t row1 = row0 + per_block < m ? row0 + per_block : m;
  const int ch0 = col * kVec;
  const T* xg = x + gc0 + ch0;

  if (lane < lanes) {
    float s[kVec] = {};
    float s2[kVec] = {};
    for (int64_t r = row0 + lane; r < row1; r += (int64_t)kSteps * lanes) {
      Row<T> rows[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int64_t row = r + (int64_t)u * lanes;
        if (row < row1) load_row(xg + row * c, rows[u]);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (r + (int64_t)u * lanes < row1) {
          float v[kVec];
          to_float(rows[u], v);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            s[j] += v[j];
            s2[j] += v[j] * v[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      fold[0][lane * width + ch0 + j] = s[j];
      fold[1][lane * width + ch0 + j] = s2[j];
    }
  }
  __syncthreads();
  float* group_partial = partial + (int64_t)group * gridDim.x * kOutputs;
  float* mine = group_partial + (int64_t)blockIdx.x * kOutputs;
  for (int o = threadIdx.x; o < 2 * width; o += kThreads) {
    const int k = o < width ? 0 : 1;
    const int ch = o - k * width;
    float a = 0.f;
    for (int l = 0; l < lanes; ++l) a += fold[k][l * width + ch];
    mine[k * kGroupC + ch] = a;
  }
  // publish this block's partials before its ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + group, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The group's last block: sums[o] = sum over blocks of partial[blk][o].
  // Warp w adds blocks w, w + kWarps, ... in order, lane l outputs 4l ..
  // 4l + 3 (one 16-byte load per block); then the warps' runs in order.
  // Outputs past a narrow group's width hold no partial and are not read
  // out.
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  const float4* sums = reinterpret_cast<const float4*>(group_partial) + wlane;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int blk = warp; blk < (int)gridDim.x; blk += kWarps) {
    const float4 p = __ldcg(sums + (int64_t)blk * (kOutputs / 4));
    a.x += p.x;
    a.y += p.y;
    a.z += p.z;
    a.w += p.w;
  }
  float4* runs = reinterpret_cast<float4*>(fold[0]);  // (kWarps, kOutputs)
  runs[warp * (kOutputs / 4) + wlane] = a;
  __syncthreads();
  for (int o = threadIdx.x; o < kOutputs; o += kThreads) {
    const int ch = o % kGroupC;
    if (ch < width) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += fold[0][w * kOutputs + o];
      out[(o / kGroupC) * c + gc0 + ch] = t;
    }
  }
  if (threadIdx.x == 0) counters[group] = 0u;
}

template <typename T>
int launch_fwd(const void* x, int64_t m, int c, float* scratch,
               int row_blocks, unsigned int* counters, float* out,
               cudaStream_t stream) {
  const dim3 grid(row_blocks, num_groups(c));
  sums_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scratch, counters, out, m, c);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- backward

__host__ __device__ inline int row_lanes(int c) { return kThreads / (c / kVec); }

__host__ inline int num_blocks(int64_t m, int c) {
  const int64_t lanes = row_lanes(c);
  const int64_t want = (m + lanes - 1) / lanes;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

// partial[block][k][c]
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_sums_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        float* __restrict__ partial, int64_t m, int c) {
  __shared__ float fold[2][kThreads * kVec];
  const int vecs = c / kVec;
  const int lanes = kThreads / vecs;
  const int col = threadIdx.x % vecs;
  const int lane = threadIdx.x / vecs;
  const int64_t per_block = (m + gridDim.x - 1) / gridDim.x;
  const int64_t row0 = (int64_t)blockIdx.x * per_block;
  const int64_t row1 = row0 + per_block < m ? row0 + per_block : m;
  const int ch0 = col * kVec;

  float s[kVec] = {};
  float s2[kVec] = {};
  if (lane < lanes) {
    float mu[kVec], rs[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu[j] = mean[ch0 + j];
      rs[j] = rstd[ch0 + j];
    }
    int64_t r = row0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < row1;
         r += (int64_t)kUnroll * lanes) {
      float v[kUnroll][kVec];
      float g[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t off = (r + (int64_t)u * lanes) * c + ch0;
        load8(x + off, v[u]);
        load8(dy + off, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = (v[u][j] - mu[j]) * rs[j];
          s[j] += g[u][j];
          s2[j] += g[u][j] * xhat;
        }
      }
    }
    for (; r < row1; r += lanes) {
      float v[kVec];
      float g[kVec];
      const int64_t off = r * c + ch0;
      load8(x + off, v);
      load8(dy + off, g);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = (v[j] - mu[j]) * rs[j];
        s[j] += g[j];
        s2[j] += g[j] * xhat;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      fold[0][lane * c + ch0 + j] = s[j];
      fold[1][lane * c + ch0 + j] = s2[j];
    }
  }
  __syncthreads();
  float* out = partial + (int64_t)blockIdx.x * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += fold[0][l * c + ch];
      b += fold[1][l * c + ch];
    }
    out[ch] = a;
    out[c + ch] = b;
  }
}

// out[k][c] = sum over blocks of partial[block][k][c]: 8 strided sums per
// channel, then those 8 in order.  Block (32, 8), grid (ceil(C / 32), 2).
__global__ void bwd_sums_finalize_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int blocks,
                                         int c) {
  __shared__ float red[8][33];
  const int k = blockIdx.y;
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (ch < c) {
    for (int g = threadIdx.y; g < blocks; g += 8) {
      a += partial[((int64_t)g * 2 + k) * c + ch];
    }
  }
  red[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) t += red[l][threadIdx.x];
    out[k * c + ch] = t;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const float* mean,
               const float* rstd, int64_t m, int c, float* partial,
               int blocks, float* out, cudaStream_t stream) {
  bwd_sums_partial_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd,
      partial, m, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_sums_finalize_kernel<<<dim3((c + 31) / 32, 2), dim3(32, 8), 0,
                             stream>>>(partial, out, blocks, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, c) row-major, bf16 (is_bf16 = 1) or fp32, 16-byte aligned; the
// grid is (row_blocks, ceil(c / 64)) (the wrapper sizes it to the card:
// ops/cuda_fused_bn.py::fwd_row_blocks); scratch: scratch_floats fp32,
// 16-byte aligned, at least row_blocks * ceil(c / 64) * 128; counters: one
// uint32 per channel group, each 0, and 0 again when the launch ends (a set
// per stream: two launches in flight at once must not share one); out:
// (2, c) fp32 = (sum x, sum x^2).  One kernel launch.  Returns a
// cudaError_t.
int mmct_bn_sums(const void* x, int is_bf16, int64_t m, int c,
                 int row_blocks, float* scratch, int64_t scratch_floats,
                 unsigned int* counters, float* out, void* stream) {
  if (!shape_ok(m, c) || row_blocks < 1 ||
      (int64_t)row_blocks * num_groups(c) * kOutputs > scratch_floats) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, m, c, scratch, row_blocks,
                                             counters, out, s)
                 : launch_fwd<float>(x, m, c, scratch, row_blocks, counters,
                                     out, s);
}

// Blocks of the backward's stage 1 for an (m, c) view: the wrapper
// allocates the (blocks, 2, c) fp32 scratch.  0 for a shape the kernels do
// not take.
int mmct_bn_sums_blocks(int64_t m, int c) {
  return shape_ok(m, c) ? num_blocks(m, c) : 0;
}

// dy, x: (m, c) row-major of one dtype; mean, rstd: (c,) fp32; partial:
// (blocks, 2, c) fp32 scratch with blocks = mmct_bn_sums_blocks; out: (2,
// c) fp32 = (sum dy, sum dy * (x - mean) * rstd).  Returns a cudaError_t.
int mmct_bn_bwd_sums(const void* dy, const void* x, int is_bf16,
                     const float* mean, const float* rstd, int64_t m, int c,
                     float* partial, int blocks, float* out, void* stream) {
  if (!shape_ok(m, c) || blocks != num_blocks(m, c)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, dy, mean, rstd, m, c,
                                             partial, blocks, out, s)
                 : launch_bwd<float>(x, dy, mean, rstd, m, c, partial,
                                     blocks, out, s);
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
