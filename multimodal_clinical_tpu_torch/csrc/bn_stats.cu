// One-pass batch-norm statistics in one launch, for Hopper (sm_90a).
//
// Replaces tools/proto_bn_stats.py::pallas_bn_stats (_stats_kernel): over
// the (M, C) row-major view of a channels_last feature map (C innermost),
//   mean[c] = sum_m x / M,   var[c] = sum_m x^2 / M - mean[c]^2
// with the sums in fp32 from bf16 (the probe) or fp32 inputs.  var is not
// clamped, as in the TPU probe.  The probe's (H, W, C, N) bitcast view is a
// TPU batch-minor layout trick; here the kernel reads the map in place.
//
// What bounds it: bytes.  Each element is read once and costs two fp32
// operations.  At the probe's visual stage 1, (2 809 856, 64) bf16, it reads
// 360 MB: 0.107 ms at 3.35 TB/s.
//
// Design.  The grid is (row blocks, channel groups of kGroupC = 64).  A
// block takes a contiguous slab of rows of its group: a thread owns 8
// channels (one 16-byte load of bf16) and one of 256 / (group width / 8)
// row lanes, walks its slab with kUnroll rows in flight, and keeps 16 fp32
// sums in registers; the block folds its lanes in shared memory in lane
// order and writes its (2, 64) partial sums.  Then, in the same launch, the
// last block of each group to finish folds that group's partials: every
// thread fences its partials before the block takes an integer ticket from
// its group's counter with atomicAdd; the block that draws the group's last
// ticket reads the group's partials through L2 (warp w the blocks w,
// w + 8, ..., lanes over the channels) and adds the warps' runs in warp
// order.  So a group's fold reads at most kMaxBlocks * 128 floats, and the
// groups fold on as many SMs at once.  No float atomics: two launches on
// one input agree bit for bit.  The last block sets its group's counter
// back to 0, so back-to-back launches on one stream need no memset.  Row
// blocks are capped so that the grid holds about two blocks per SM of an
// H100.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;           // channels per thread
constexpr int kUnroll = 8;        // rows in flight per thread
constexpr int kGroupC = 64;       // channels of one group
constexpr int kOutputs = 2 * kGroupC;  // a group's sums: 64 x, 64 x^2
constexpr int kMaxBlocks = 264;   // two per SM of an H100 (132 SMs)
constexpr int kMaxC = 2048;
constexpr int kMaxGroups = kMaxC / kGroupC;

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

__host__ inline int num_groups(int c) { return (c + kGroupC - 1) / kGroupC; }

// row blocks of each channel group
__host__ inline int num_row_blocks(int64_t m, int c) {
  const int widest = c < kGroupC ? c : kGroupC;
  const int64_t lanes = kThreads / (widest / kVec);
  const int64_t want = (m + lanes - 1) / lanes;
  const int64_t cap = kMaxBlocks / num_groups(c) > 0
                          ? kMaxBlocks / num_groups(c) : 1;
  return (int)(want < cap ? want : cap);
}

// partial: (groups, gridDim.x, 2, kGroupC) fp32 scratch; counters: one
// uint32 per group, 0 before the launch and 0 after it; out: (2, c) fp32 =
// (mean, var).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* partial,
                unsigned int* counters, float* __restrict__ out, int64_t m,
                int c) {
  __shared__ float fold[2][kThreads * kVec];
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
    int64_t r = row0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < row1;
         r += (int64_t)kUnroll * lanes) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load8(xg + (r + (int64_t)u * lanes) * c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[j] += v[u][j];
          s2[j] += v[u][j] * v[u][j];
        }
      }
    }
    for (; r < row1; r += lanes) {
      float v[kVec];
      load8(xg + r * c, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] += v[j];
        s2[j] += v[j] * v[j];
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
  for (int ch = threadIdx.x; ch < width; ch += kThreads) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += fold[0][l * width + ch];
      b += fold[1][l * width + ch];
    }
    mine[ch] = a;
    mine[kGroupC + ch] = b;
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
  // Warp w sums blocks w, w + kWarps, ... (several in flight) with lane l
  // on outputs l, l + 32, l + 64, l + 96; then the warps' runs in order.
  constexpr int kPerLane = kOutputs / 32;
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  float* runs = fold[0];  // (kWarps, kOutputs)
  float a[kPerLane] = {};
#pragma unroll 4
  for (int blk = warp; blk < (int)gridDim.x; blk += kWarps) {
    const float* row = group_partial + (int64_t)blk * kOutputs + wlane;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if ((wlane + 32 * j) % kGroupC < width) a[j] += __ldcg(row + 32 * j);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    runs[warp * kOutputs + wlane + 32 * j] = a[j];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < width; ch += kThreads) {
    float s = 0.f, s2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += runs[w * kOutputs + ch];
      s2 += runs[w * kOutputs + kGroupC + ch];
    }
    const float mean = s / (float)m;
    out[gc0 + ch] = mean;
    out[c + gc0 + ch] = s2 / (float)m - mean * mean;
  }
  if (threadIdx.x == 0) counters[group] = 0u;
}

bool shape_ok(int64_t m, int c) {
  return m > 0 && c > 0 && c % kVec == 0 && c <= kMaxC;
}

}  // namespace

extern "C" {

// Row blocks of an (m, c) launch, per channel group of 64 (the last group
// may be narrower): the wrapper allocates a (groups, blocks, 2, 64) fp32
// scratch and one uint32 counter per group.  0 for a shape the kernel does
// not take.
int mmct_bn_stats_blocks(int64_t m, int c) {
  return shape_ok(m, c) ? num_row_blocks(m, c) : 0;
}

// Channel groups of a launch over c channels (at most
// mmct_bn_stats_max_groups).
int mmct_bn_stats_groups(int c) { return num_groups(c); }

int mmct_bn_stats_max_groups() { return kMaxGroups; }

// x: (m, c) row-major, bf16 (is_bf16 = 1) or fp32, 16-byte aligned;
// partial: (groups, blocks, 2, 64) fp32 scratch with blocks =
// mmct_bn_stats_blocks; counters: one uint32 per group, each 0, and 0
// again when the launch ends (a set per stream: two launches in flight at
// once must not share one); out: (2, c) fp32 = (mean, biased var).
// Returns a cudaError_t.
int mmct_bn_stats(const void* x, int is_bf16, int64_t m, int c,
                  float* partial, int blocks, unsigned int* counters,
                  float* out, void* stream) {
  if (!shape_ok(m, c) || blocks != num_row_blocks(m, c)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, num_groups(c));
  if (is_bf16) {
    bn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, counters, out, m, c);
  } else {
    bn_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), partial, counters, out, m, c);
  }
  return (int)cudaGetLastError();
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
