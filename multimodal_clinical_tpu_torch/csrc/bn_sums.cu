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
//
// Design.  Stage 1: a grid fixed by M and C alone (at most kMaxBlocks
// blocks), each block taking a contiguous slab of rows.  A thread owns 8
// consecutive channels (one 16-byte load of bf16, two of fp32) and one of
// `lanes` = 256 / (C / 8) row lanes; it walks its slab with stride `lanes`,
// kUnroll rows at a time so that several loads are in flight, and keeps 16
// fp32 sums in registers.  The block folds its lanes in shared memory in
// lane order and writes its (2, C) partial sums to scratch.  Stage 2 sums
// the partials of all blocks per channel in a fixed order.  No atomics:
// two runs on the same input add the same numbers in the same order and
// agree bit for bit.  Offsets are 64-bit (the largest view on the main
// path holds 719 M elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // channels per thread
constexpr int kUnroll = 4;       // rows in flight per thread
constexpr int kMaxBlocks = 1024;
constexpr int kMaxC = kThreads * kVec;  // every thread owns at least one row lane

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

__host__ __device__ inline int row_lanes(int c) { return kThreads / (c / kVec); }

__host__ inline int num_blocks(int64_t m, int c) {
  const int64_t lanes = row_lanes(c);
  const int64_t want = (m + lanes - 1) / lanes;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

// partial[block][k][c]; kBackward selects the backward sums.
template <typename T, bool kBackward>
__global__ void __launch_bounds__(kThreads)
sums_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
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
    if (kBackward) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        mu[j] = mean[ch0 + j];
        rs[j] = rstd[ch0 + j];
      }
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
        if (kBackward) load8(dy + off, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (kBackward) {
            const float xhat = (v[u][j] - mu[j]) * rs[j];
            s[j] += g[u][j];
            s2[j] += g[u][j] * xhat;
          } else {
            s[j] += v[u][j];
            s2[j] += v[u][j] * v[u][j];
          }
        }
      }
    }
    for (; r < row1; r += lanes) {
      float v[kVec];
      float g[kVec];
      const int64_t off = r * c + ch0;
      load8(x + off, v);
      if (kBackward) load8(dy + off, g);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (kBackward) {
          const float xhat = (v[j] - mu[j]) * rs[j];
          s[j] += g[j];
          s2[j] += g[j] * xhat;
        } else {
          s[j] += v[j];
          s2[j] += v[j] * v[j];
        }
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
__global__ void sums_finalize_kernel(const float* __restrict__ partial,
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

template <typename T, bool kBackward>
int launch(const void* x, const void* dy, const float* mean,
           const float* rstd, int64_t m, int c, float* partial, int blocks,
           float* out, cudaStream_t stream) {
  sums_partial_kernel<T, kBackward><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd,
      partial, m, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_finalize_kernel<<<dim3((c + 31) / 32, 2), dim3(32, 8), 0, stream>>>(
      partial, out, blocks, c);
  return (int)cudaGetLastError();
}

bool shape_ok(int64_t m, int c) {
  return m > 0 && c > 0 && c % kVec == 0 && c <= kMaxC;
}

}  // namespace

extern "C" {

// Blocks of stage 1 for an (m, c) view: the wrapper allocates the
// (blocks, 2, c) fp32 scratch.  0 for a shape the kernels do not take.
int mmct_bn_sums_blocks(int64_t m, int c) {
  return shape_ok(m, c) ? num_blocks(m, c) : 0;
}

// x: (m, c) row-major, bf16 (is_bf16 = 1) or fp32, 16-byte aligned;
// partial: (blocks, 2, c) fp32 scratch with blocks = mmct_bn_sums_blocks;
// out: (2, c) fp32 = (sum x, sum x^2).  Returns a cudaError_t.
int mmct_bn_sums(const void* x, int is_bf16, int64_t m, int c,
                 float* partial, int blocks, float* out, void* stream) {
  if (!shape_ok(m, c) || blocks != num_blocks(m, c)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16, false>(x, nullptr, nullptr, nullptr, m,
                                            c, partial, blocks, out, s)
             : launch<float, false>(x, nullptr, nullptr, nullptr, m, c,
                                    partial, blocks, out, s);
}

// dy, x: (m, c) row-major of one dtype; mean, rstd: (c,) fp32; out: (2, c)
// fp32 = (sum dy, sum dy * (x - mean) * rstd).  Otherwise as mmct_bn_sums.
int mmct_bn_bwd_sums(const void* dy, const void* x, int is_bf16,
                     const float* mean, const float* rstd, int64_t m, int c,
                     float* partial, int blocks, float* out, void* stream) {
  if (!shape_ok(m, c) || blocks != num_blocks(m, c)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, true>(x, dy, mean, rstd, m, c,
                                               partial, blocks, out, s)
                 : launch<float, true>(x, dy, mean, rstd, m, c, partial,
                                       blocks, out, s);
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
