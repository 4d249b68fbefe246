// Identity copy of a dense tensor in its storage order, for Hopper (sm_90a).
//
// Replaces tools/probe_pallas_layout.py::pallas_identity (_identity_kernel),
// the TPU probe's copy blocked over the first two dims.  A tensor that is
// dense and non-overlapping fills one span of memory whatever its strides,
// and its copy with the same strides fills another, so the copy is a flat
// move of bytes: the (H, W, C, N) view of an NHWC map and the map itself
// cost the same.  The TPU's (1, n1/split, ...) VMEM blocks and the split
// search do not carry over.
//
// What bounds it: bytes.  It reads and writes each byte once and computes
// nothing: at the layout probe's (896, 112, 112, 64) bf16 map, 1.44 GB each
// way, 0.86 ms at 3.35 TB/s.
//
// Design: each block copies one contiguous tile of kThreads * kUnroll
// 16-byte words (kUnroll loads in flight per thread, then the stores),
// threads on neighbouring words; block 0 also copies the last (bytes % 16)
// bytes one at a time.  Offsets are 64-bit (the probe's map is 719 M
// elements).  A first version, a grid-stride loop over 8 blocks per SM
// with streaming loads and stores, ran 8% slower than `clone` at the
// probe's map (chip_smoke.py on an H100; PERF.md has the times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int64_t kTile = (int64_t)kThreads * kUnroll;

__global__ void __launch_bounds__(kThreads)
identity_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     int64_t words, const uint8_t* __restrict__ src_tail,
                     uint8_t* __restrict__ dst_tail, int tail) {
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < words) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < words) dst[i] = v[u];
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    dst_tail[threadIdx.x] = src_tail[threadIdx.x];
  }
}

}  // namespace

extern "C" {

// Copies `bytes` bytes from src to dst, both 16-byte aligned and not
// overlapping, on `stream`.  Returns a cudaError_t.
int mmct_identity_copy(const void* src, void* dst, int64_t bytes,
                       void* stream) {
  if (bytes <= 0 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t words = bytes / 16;
  const int tail = (int)(bytes % 16);
  const int64_t blocks = words > 0 ? (words + kTile - 1) / kTile : 1;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  identity_copy_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), words,
      static_cast<const uint8_t*>(src) + words * 16,
      static_cast<uint8_t*>(dst) + words * 16, tail);
  return (int)cudaGetLastError();
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
