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
// vector stores.  The TPU kernel's (H, W, C, N) transpose is not carried
// over: here the channels are innermost in memory, so a thread takes 8
// channels of a pixel and every load and store is one 16-byte (bf16) or
// two (fp32) vector accesses, neighbouring threads on neighbouring
// channels.
//
// Forward: a thread per (output pixel, 8 channels) reads the 9 taps; the
// overlap of neighbouring windows is served by the caches.
//
// Backward: the TPU kernel's own tiling.  Window (i, j) owns the quad of dx
// rows 2i, 2i + 1 and columns 2j, 2j + 1, and that quad takes taps only
// from windows (i, j), (i, j + 1), (i + 1, j) and (i + 1, j + 1):
//   dx[2i,     2j]     = tap 4 of (i, j)
//   dx[2i,     2j + 1] = tap 5 of (i, j) + tap 3 of (i, j + 1)
//   dx[2i + 1, 2j]     = tap 7 of (i, j) + tap 1 of (i + 1, j)
//   dx[2i + 1, 2j + 1] = tap 8 of (i, j) + tap 6 of (i, j + 1)
//                        + tap 2 of (i + 1, j) + tap 0 of (i + 1, j + 1)
// summed in fp32 in this order and rounded once, as the Pallas kernel (and
// ops/maxpool.py::pool_bwd) do.  A block owns a tile of kRows window rows x
// tw windows x cv channel vectors of one image (tw * cv <= 256, cv <= 8 a
// power of two dividing C / 8) and stages the tile's dy and idx, with a
// one-row and one-column halo, into shared memory with 16- and 8-byte
// cp.async: each dy and idx element leaves device memory once (the halo
// again from L2), where a gather per input pixel fetched each up to 9
// times.  Then a thread per (window column, channel vector) walks the tile's
// window rows and writes its four 16-byte dx vectors; a warp's four
// windows x 8 vectors fill whole 128-byte lines (evict-first stores
// measured no faster).  Windows past the map's last row or column are staged as
// index 9, which matches no tap, and a quad row or column past an odd H or
// W is not written: predicates, where the gather's loops broke early on
// pixel parity.  Index arithmetic is 32-bit from a 1-D grid
// (column tile fastest, so neighbouring blocks share their halo in L2);
// only device addresses are 64-bit.  Each dx element is written once by
// one thread: no atomics, no zero-fill pass.

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

// exact for the forward (every value came from the input); rounds the
// backward's fp32 sums to nearest even, once
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

// Backward tiles: kRows window rows of (tw + 1) x cv staged vectors plus
// the halo row; a 16- or 32-byte dy vector and an 8-byte idx vector each.
template <typename T>
struct BwdTile {
  static constexpr int kRows = sizeof(T) == 2 ? 4 : 2;
  static constexpr int kMaxCv = 8;
  static constexpr int kMaxItems = (kRows + 1) * (kThreads + kMaxCv);
  static constexpr int kVecBytes = kVec * (int)sizeof(T);
};

// 8 bytes of index 9: a window outside the map, chosen by no tap
constexpr uint32_t kNoTap = 0x09090909u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(static_cast<char*>(dst) + 16 * i)),
                   "l"(static_cast<const char*>(src) + 16 * i));
    }
  }
}

__device__ __forceinline__ void load8_shared(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8_shared(const __nv_bfloat16* p,
                                             float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t tap_of(uint2 packed, int j) {
  return ((j < 4 ? packed.x : packed.y) >> (8 * (j & 3))) & 0xffu;
}

// One block per tile: blockIdx.x = ((b * bands + band) * slices + slice)
// * col_tiles + col_tile.  cv = 1 << lcv channel vectors per tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
pool_bwd_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ idx,
                T* __restrict__ dx, int h, int w, int c, int ho, int wo,
                int tw, int lcv, int col_tiles, int slices, int bands) {
  using Tile = BwdTile<T>;
  constexpr int kRows = Tile::kRows;
  __shared__ __align__(16) unsigned char dy_s[Tile::kMaxItems *
                                              Tile::kVecBytes];
  __shared__ uint2 ix_s[Tile::kMaxItems];

  unsigned int t = blockIdx.x;
  const int col_tile = (int)(t % col_tiles);
  t /= col_tiles;
  const int slice = (int)(t % slices);
  t /= slices;
  const int band = (int)(t % bands);
  const int b = (int)(t / bands);
  const int cv = 1 << lcv;
  const int oh0 = band * kRows, ow0 = col_tile * tw;
  const int ch_tile = slice * cv * kVec;
  const int row_items = (tw + 1) << lcv;  // staged vectors per window row

  // stage windows oh0 .. oh0 + kRows, ow0 .. ow0 + tw (the halo included)
  const int64_t image = (int64_t)b * ho * wo;
#pragma unroll
  for (int r = 0; r <= kRows; ++r) {
    const int oh = oh0 + r;
    for (int j = threadIdx.x; j < row_items; j += kThreads) {
      const int ow = ow0 + (j >> lcv);
      const int k = r * row_items + j;
      if (oh < ho && ow < wo) {
        const int64_t off = (image + (int64_t)oh * wo + ow) * c + ch_tile +
                            (j & (cv - 1)) * kVec;
        cp_async<Tile::kVecBytes>(dy_s + k * Tile::kVecBytes, dy + off);
        cp_async<8>(&ix_s[k], idx + off);
      } else {
        ix_s[k] = make_uint2(kNoTap, kNoTap);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // route: thread j takes window column ow0 + (j >> lcv), vector j & (cv - 1)
  const int j = threadIdx.x;
  const int ow = ow0 + (j >> lcv);
  if (j >= (tw << lcv) || ow >= wo) return;
  const int ch = ch_tile + (j & (cv - 1)) * kVec;
  const bool right = 2 * ow + 1 < w;
  const T* tile = reinterpret_cast<const T*>(dy_s);
  // one output vector live at a time, and one window row per iteration:
  // the four windows' values and indices stay in registers, no spills
#pragma unroll 1
  for (int r = 0; r < kRows && oh0 + r < ho; ++r) {
    const int oh = oh0 + r;
    // windows (r, w), (r, w + 1), (r + 1, w), (r + 1, w + 1) of the tile
    const int k00 = r * row_items + j, k01 = k00 + cv;
    const int k10 = k00 + row_items, k11 = k10 + cv;
    float d00[kVec], d01[kVec], d10[kVec], d11[kVec], o[kVec];
    load8_shared(tile + k00 * kVec, d00);
    load8_shared(tile + k01 * kVec, d01);
    load8_shared(tile + k10 * kVec, d10);
    load8_shared(tile + k11 * kVec, d11);
    const uint2 i00 = ix_s[k00], i01 = ix_s[k01];
    const uint2 i10 = ix_s[k10], i11 = ix_s[k11];
    T* px = dx + (((int64_t)b * h + 2 * oh) * w + 2 * ow) * c + ch;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      o[q] = tap_of(i00, q) == 4 ? d00[q] : 0.f;
    }
    store8(px, o);
    if (right) {
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        o[q] = (tap_of(i00, q) == 5 ? d00[q] : 0.f) +
               (tap_of(i01, q) == 3 ? d01[q] : 0.f);
      }
      store8(px + c, o);
    }
    if (2 * oh + 1 < h) {
      px += (int64_t)w * c;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        o[q] = (tap_of(i00, q) == 7 ? d00[q] : 0.f) +
               (tap_of(i10, q) == 1 ? d10[q] : 0.f);
      }
      store8(px, o);
      if (right) {
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          o[q] = (((tap_of(i00, q) == 8 ? d00[q] : 0.f) +
                   (tap_of(i01, q) == 6 ? d01[q] : 0.f)) +
                  (tap_of(i10, q) == 2 ? d10[q] : 0.f)) +
                 (tap_of(i11, q) == 0 ? d11[q] : 0.f);
        }
        store8(px + c, o);
      }
    }
  }
}

// The backward's tiling of an (b, ho, wo, c) window map for dtype T.
struct BwdGrid {
  int tw, lcv, col_tiles, slices, bands;
  int64_t blocks;
};

template <typename T>
BwdGrid bwd_grid(int b, int ho, int wo, int c) {
  BwdGrid g;
  const int vecs = c / kVec;
  g.lcv = 0;
  while (g.lcv < 3 && vecs % (2 << g.lcv) == 0) ++g.lcv;
  const int tw_max = kThreads >> g.lcv;
  g.col_tiles = (wo + tw_max - 1) / tw_max;
  g.tw = (wo + g.col_tiles - 1) / g.col_tiles;
  g.slices = vecs >> g.lcv;
  g.bands = (ho + BwdTile<T>::kRows - 1) / BwdTile<T>::kRows;
  g.blocks = (int64_t)b * g.bands * g.slices * g.col_tiles;
  return g;
}

template <typename T>
int launch_bwd(const void* dy, const void* idx, void* dx, int b, int h,
               int w, int c, cudaStream_t s) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const BwdGrid g = bwd_grid<T>(b, ho, wo, c);
  if (g.blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  pool_bwd_kernel<T><<<(unsigned int)g.blocks, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const uint8_t*>(idx),
      static_cast<T*>(dx), h, w, c, ho, wo, g.tw, g.lcv, g.col_tiles,
      g.slices, g.bands);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(dy, idx, dx, b, h, w, c, s)
                 : launch_bwd<float>(dy, idx, dx, b, h, w, c, s);
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
