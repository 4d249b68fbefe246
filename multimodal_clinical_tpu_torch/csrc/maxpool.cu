// 3x3 / stride 2 / pad 1 max-pool with a stored tap index, for Hopper
// (sm_90a), forward and backward.
//
// Replaces multimodal_clinical_tpu/ops/maxpool_pallas.py::_pool_fwd_pallas
// (_fwd_kernel) and ::_pool_bwd_pallas (_bwd_kernel).  On a physical NHWC
// map (a channels_last tensor), bf16 or fp32:
//   forward   y[b, i, j, c] = max of the 9 taps x[b, 2i - 1 + a, 2j - 1 + t, c]
//             (-inf outside the map), and idx = 3a + t of the FIRST tap in
//             row-major order that holds the maximum (a strict > decides);
//   backward  dx[b, h, w, c] = sum of dy[b, i, j, c] over the windows
//             (i, j) whose stored idx points at (h, w).
// NaN propagates into y as jnp.maximum does, and never moves the index.
//
// What bounds it: bytes.  A compare per tap and an add per routed window
// are far below the card's operation rate.  At the visual stem
// (896, 112, 112, 64) bf16 the forward moves 1.44 GB in, 0.36 GB of y and
// 0.18 GB of index out (0.59 ms at 3.35 TB/s); the backward the reverse.
//
// Design.  The index is uint8, one byte per output element: the Pallas
// kernel kept it in the feature dtype only because Mosaic has no int8
// vector stores.  The TPU kernel's (H, W, C, N) transpose and halo blocks
// are not carried over: here the channels are innermost in memory, so a
// thread takes 8 channels of one pixel and every load and store is one
// 16-byte (bf16) or two (fp32) vector accesses, neighbouring threads on
// neighbouring channels.  Forward: a thread per (output pixel, 8 channels)
// reads the 9 taps; the overlap of neighbouring windows is served by the
// caches.  Backward: a gather, a thread per (input pixel, 8 channels) over
// the at most 4 windows that can have chosen that pixel (1 for an even
// row or column, 2 for an odd one), summed in fp32 in the Pallas kernel's
// order.  Each dx element is written once by one thread: no atomics, no
// zero-fill pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

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

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// exact for the forward (every value came from bf16); rounds the
// backward's fp32 sums to nearest even
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                uint8_t* __restrict__ idx, int h, int w, int c, int ho,
                int wo, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / kVec;
  const int ch0 = (int)(t % vecs) * kVec;
  int64_t p = t / vecs;
  const int ow = (int)(p % wo);
  p /= wo;
  const int oh = (int)(p % ho);
  const int64_t b = p / ho;

  float best[kVec];
  uint8_t arg[kVec];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ih = 2 * oh - 1 + a;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int iw = 2 * ow - 1 + s;
      const int tap = 3 * a + s;
      float v[kVec];
      if (ih >= 0 && ih < h && iw >= 0 && iw < w) {
        load8(x + ((b * h + ih) * w + iw) * c + ch0, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = -CUDART_INF_F;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (tap == 0) {
          best[j] = v[j];
          arg[j] = 0;
        } else if (v[j] > best[j]) {
          best[j] = v[j];
          arg[j] = (uint8_t)tap;
        } else if (v[j] != v[j]) {  // NaN: into the max, not the index
          best[j] = v[j];
        }
      }
    }
  }
  const int64_t out = ((b * ho + oh) * wo + ow) * c + ch0;
  store8(y + out, best);
  uint2 packed;
  packed.x = arg[0] | (arg[1] << 8) | (arg[2] << 16) | ((uint32_t)arg[3] << 24);
  packed.y = arg[4] | (arg[5] << 8) | (arg[6] << 16) | ((uint32_t)arg[7] << 24);
  *reinterpret_cast<uint2*>(idx + out) = packed;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ idx,
                T* __restrict__ dx, int h, int w, int c, int ho, int wo,
                int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / kVec;
  const int ch0 = (int)(t % vecs) * kVec;
  int64_t p = t / vecs;
  const int iw = (int)(p % w);
  p /= w;
  const int ih = (int)(p % h);
  const int64_t b = p / h;

  // window row oh covers input rows 2 * oh - 1 .. 2 * oh + 1: an even row
  // 2r sits in window r (tap row 1); an odd row 2r + 1 in windows r (tap
  // row 2) and r + 1 (tap row 0).  Columns alike.  Visited in the order
  // (r, s), (r, s + 1), (r + 1, s), (r + 1, s + 1).
  const int r = ih >> 1, s = iw >> 1;
  const int rows = (ih & 1) ? 2 : 1, cols = (iw & 1) ? 2 : 1;
  float acc[kVec] = {};
  for (int i = 0; i < rows; ++i) {
    const int oh = r + i;
    if (oh >= ho) break;
    const int a = (ih & 1) ? (i == 0 ? 2 : 0) : 1;
    for (int k = 0; k < cols; ++k) {
      const int ow = s + k;
      if (ow >= wo) break;
      const int tap = 3 * a + ((iw & 1) ? (k == 0 ? 2 : 0) : 1);
      const int64_t off = ((b * ho + oh) * wo + ow) * c + ch0;
      const uint2 packed = __ldg(reinterpret_cast<const uint2*>(idx + off));
      float g[kVec];
      load8(dy + off, g);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const uint32_t word = j < 4 ? packed.x : packed.y;
        if (((word >> (8 * (j & 3))) & 0xff) == (uint32_t)tap) acc[j] += g[j];
      }
    }
  }
  store8(dx + ((b * h + ih) * w + iw) * c + ch0, acc);
}

inline unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

bool shape_ok(int b, int h, int w, int c) {
  return b > 0 && h > 0 && w > 0 && c > 0 && c % kVec == 0;
}

}  // namespace

extern "C" {

// x: (b, h, w, c) contiguous, bf16 (is_bf16 = 1) or fp32, 16-byte aligned;
// y: (b, ho, wo, c) of x's dtype and idx: (b, ho, wo, c) uint8, with
// ho = (h - 1) / 2 + 1 and wo = (w - 1) / 2 + 1.  Returns a cudaError_t.
int mmct_maxpool_fwd(const void* x, void* y, void* idx, int is_bf16, int b,
                     int h, int w, int c, void* stream) {
  if (!shape_ok(b, h, w, c)) return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int64_t total = (int64_t)b * ho * wo * (c / kVec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pool_fwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        static_cast<uint8_t*>(idx), h, w, c, ho, wo, total);
  } else {
    pool_fwd_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<uint8_t*>(idx), h, w, c, ho, wo, total);
  }
  return (int)cudaGetLastError();
}

// dy: (b, ho, wo, c) and idx: (b, ho, wo, c) uint8 from mmct_maxpool_fwd;
// dx: (b, h, w, c) of dy's dtype, every element written.
int mmct_maxpool_bwd(const void* dy, const void* idx, void* dx, int is_bf16,
                     int b, int h, int w, int c, void* stream) {
  if (!shape_ok(b, h, w, c)) return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int64_t total = (int64_t)b * h * w * (c / kVec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pool_bwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const uint8_t*>(idx), static_cast<__nv_bfloat16*>(dx), h,
        w, c, ho, wo, total);
  } else {
    pool_bwd_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const uint8_t*>(idx),
        static_cast<float*>(dx), h, w, c, ho, wo, total);
  }
  return (int)cudaGetLastError();
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
