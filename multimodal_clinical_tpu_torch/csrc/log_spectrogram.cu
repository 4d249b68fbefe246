// Log-magnitude STFT for Hopper (sm_90a), in fp32 FMAs.
//
// Replaces multimodal_clinical_tpu/ops/pallas_spectrogram.py::
// pallas_log_spectrogram: centred (reflect-padded) Hann STFT, then
// log(|X| + eps), written transposed as out[b, f, t].
//
// What bounds it.  As a DFT the work is a dense product: frames (T, n_fft)
// times the window-folded tables (n_fft, 2 * n_bins).  At the VGGSound
// geometry (224 x 80000 samples, n_fft 256, hop 128) that is 18.5 GFLOP
// against 144 MB moved, 128 FLOP per byte: the fp32 CUDA-core rate bounds
// it (about 0.28 ms at 67 TFLOP/s, against 0.04 ms for the bytes).  fp32
// and not TF32 or bf16, because the log amplifies the rounding error of a
// low-precision product in near-zero bins (the Pallas kernel runs its dots
// at Precision.HIGHEST for the same reason).
//
// Design.  One block takes one batch row, a tile of 64 frames and a tile of
// 32 frequencies.  It stages in shared memory the samples its frames span
// (reflect padding is done here, by index) and the 32 columns of the cos
// and sin tables it needs (64 KB for n_fft 256; the whole tables, 264 KB,
// would not fit in the 227 KB a block may use).  Each thread keeps 2 frames
// x 4 frequencies x (re, im) in registers, so one step of the inner loop
// makes 2 sample loads and 2 float4 table loads for 16 FMAs.  Lanes run
// along t: the table loads of a warp are broadcasts, and the stores to
// out[b, f, t..t+31] coalesce.  The samples are stored with one pad word
// per hop, so the 32 lanes, whose frames start hop samples apart, read 32
// different banks when hop is even.  No assumption on hop: unlike the
// Pallas kernel this one needs no hop == n_fft / 2.
//
// Measured on an H100 SXM at 700 W (chip_smoke.py): 1.12 ms at the VGGSound
// shape, 4x its own operation floor and 26x the byte bound.  The inner loop
// issues four shared-memory loads per 16 FMAs, and the last frequency tile
// computes 32 bins for the one real bin 128.  Making it fast (an FFT
// factorisation, or tensor cores with a split-precision product) is later
// work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerThread = 2;
constexpr int kFreqsPerThread = 4;  // one float4 of a table row
constexpr int kFrameTile = 32 * kFramesPerThread;                    // 64
constexpr int kFreqTile = (kThreads / 32) * kFreqsPerThread;          // 32
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int span_samples(int n_fft, int hop) {
  return (kFrameTile - 1) * hop + n_fft;
}

__host__ inline size_t smem_bytes(int n_fft, int hop) {
  size_t span = (size_t)span_samples(n_fft, hop);
  size_t table = 2 * (size_t)n_fft * kFreqTile;
  return (table + span + span / hop + 1) * sizeof(float);
}

// numpy "reflect" padding (the edge sample is not repeated).  The wrapper
// guarantees n > n_fft / 2, so one reflection suffices.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(kThreads)
log_spectrogram_kernel(const float* __restrict__ wave,
                       const float* __restrict__ table,
                       float* __restrict__ out, int n, int n_fft, int hop,
                       int n_bins, int n_bins_pad, int n_frames, float eps) {
  extern __shared__ float4 smem4[];
  float* s_cos = reinterpret_cast<float*>(smem4);  // [n_fft][kFreqTile]
  float* s_sin = s_cos + n_fft * kFreqTile;        // [n_fft][kFreqTile]
  float* s_x = s_sin + n_fft * kFreqTile;          // samples + pad words

  const int t0 = blockIdx.x * kFrameTile;
  const int f0 = blockIdx.y * kFreqTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // table tile: rows 0..n_fft-1, columns f0..f0+31 of the zero-padded tables
  const float* cos_g = table;
  const float* sin_g = table + (size_t)n_fft * n_bins_pad;
  for (int i = tid; i < n_fft * kFreqTile; i += kThreads) {
    const int k = i / kFreqTile;
    const int c = i % kFreqTile;
    s_cos[i] = cos_g[(size_t)k * n_bins_pad + f0 + c];
    s_sin[i] = sin_g[(size_t)k * n_bins_pad + f0 + c];
  }
  // samples at padded positions t0*hop .. t0*hop + span - 1; position p is
  // stored at p + p / hop
  const int half = n_fft / 2;
  const int span = span_samples(n_fft, hop);
  const int padded_len = n + 2 * half;
  const float* row = wave + (size_t)b * n;
  const int p0 = t0 * hop;
  for (int p = tid; p < span; p += kThreads) {
    const int gp = p0 + p;
    s_x[p + p / hop] = gp < padded_len ? row[reflect(gp - half, n)] : 0.f;
  }
  __syncthreads();

  float re[kFramesPerThread][kFreqsPerThread] = {};
  float im[kFramesPerThread][kFreqsPerThread] = {};
  int base[kFramesPerThread];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    base[i] = (lane + 32 * i) * (hop + 1);  // frame start, pad words included
  }
  const float4* c4 = reinterpret_cast<const float4*>(s_cos) + warp;
  const float4* s4 = reinterpret_cast<const float4*>(s_sin) + warp;
  int koff = 0;  // k + k / hop, kept without a division
  int krem = 0;
#pragma unroll 4
  for (int k = 0; k < n_fft; ++k) {
    const float4 c = c4[k * (kFreqTile / 4)];
    const float4 s = s4[k * (kFreqTile / 4)];
#pragma unroll
    for (int i = 0; i < kFramesPerThread; ++i) {
      const float x = s_x[base[i] + koff];
      re[i][0] = fmaf(x, c.x, re[i][0]);
      re[i][1] = fmaf(x, c.y, re[i][1]);
      re[i][2] = fmaf(x, c.z, re[i][2]);
      re[i][3] = fmaf(x, c.w, re[i][3]);
      im[i][0] = fmaf(x, s.x, im[i][0]);
      im[i][1] = fmaf(x, s.y, im[i][1]);
      im[i][2] = fmaf(x, s.z, im[i][2]);
      im[i][3] = fmaf(x, s.w, im[i][3]);
    }
    ++koff;
    if (++krem == hop) {
      krem = 0;
      ++koff;
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int t = t0 + lane + 32 * i;
    if (t >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < kFreqsPerThread; ++j) {
      const int f = f0 + kFreqsPerThread * warp + j;
      if (f < n_bins) {
        const float mag = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
        out[((size_t)b * n_bins + f) * n_frames + t] = logf(mag + eps);
      }
    }
  }
}

}  // namespace

extern "C" {

// Columns of a table tile: the wrapper pads the tables to a multiple.
int mmct_log_spectrogram_freq_tile() { return kFreqTile; }

// wave (batch, n) fp32; table (2, n_fft, n_bins_pad) fp32 (cos, sin, window
// folded, zero beyond n_bins); out (batch, n_bins, n_frames) fp32.  All
// contiguous, on the current device.  Returns a cudaError_t:
// cudaErrorInvalidValue for a shape whose block would need more than
// kMaxSmem bytes of shared memory.
int mmct_log_spectrogram(const float* wave, const float* table, float* out,
                         int batch, int n, int n_fft, int hop, int n_bins,
                         int n_bins_pad, int n_frames, float eps,
                         void* stream) {
  const size_t smem = smem_bytes(n_fft, hop);
  if (smem > (size_t)kMaxSmem || n_bins_pad % kFreqTile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      log_spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kFrameTile - 1) / kFrameTile,
                  n_bins_pad / kFreqTile, batch);
  log_spectrogram_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      wave, table, out, n, n_fft, hop, n_bins, n_bins_pad, n_frames, eps);
  return (int)cudaGetLastError();
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
