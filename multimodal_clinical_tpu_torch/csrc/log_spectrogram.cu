// Log-magnitude STFT for Hopper (sm_90a), as a four-step FFT in shared
// memory, fp32 throughout.
//
// Replaces multimodal_clinical_tpu/ops/pallas_spectrogram.py::
// pallas_log_spectrogram: centred (reflect-padded) periodic-Hann STFT, then
// log(|X| + eps), written transposed as out[b, f, t].  Any hop (the Pallas
// kernel needs hop == n_fft / 2); n_fft a power of two from 64 to 1024.
//
// What bounds it on the H100: bytes.  At the VGGSound geometry (224 x 80000
// samples, n_fft 256, hop 128, 626 frames) it reads 72 MB and writes 72 MB:
// 0.043 ms at 3.35 TB/s.  This design executes about 1 GFLOP of fp32 (0.015
// ms at 67 TFLOP/s).  The first design, a direct DFT, executed 18.5 GFLOP,
// which put its own floor at 0.28 ms, 26x the byte bound; no DFT
// formulation gets near the bytes.
//
// Design.  Two real frames per complex transform: z = x_t + i x_{t+1}, one
// n-point FFT, then X_t[k] = (Z[k] + conj Z[n-k]) / 2 and X_{t+1}[k] =
// (Z[k] - conj Z[n-k]) / 2i.  The FFT is four-step, n = N1 N2 (the wrapper's
// digit plan, one template instance per n: 8x8, 16x8, 16x16, 32x16,
// 32x32): N2 threads per transform each run an N1-point radix-2 FFT in
// registers over the samples x[N2 n1 + p], multiply by W_n^(p k1), and
// exchange through padded shared memory; then each runs the N2-point
// FFTs of its rows k1.  The register FFTs decimate in frequency (natural
// order in, bit-reversed out), so the bit reversal lands in shared-memory
// addresses and no register array is indexed at run time (the first FFT
// build, decimating in time from bit-reversed registers, put its arrays
// in local memory).  Twiddles and the window are fp32 tables the wrapper
// builds in float64 and casts once; inside a register FFT every thread
// reads the same twiddle, a broadcast.  A block takes one batch row and
// 2 * 256 / N2 frames (32 at n_fft 256), reading its frames' samples
// straight from device memory (reflect padding by index; frames that
// overlap hit in L1), so its shared memory does not grow with hop.  The
// epilogue reads Z[k] and Z[n-k] from shared memory (transforms padded by
// one complex word, so 16 transforms fall in distinct banks), computes |X|
// and the log, and writes out[b, f, t0 .. t0 + frames) in runs of
// consecutive t.  fp32, no TF32 or bf16 product: the log amplifies the
// rounding of near-zero bins.
//
// Measured by chip_smoke.py (phase 3) on an NVIDIA H100 80GB HBM3 at
// 700.00 W: 0.1061 ms at (224, 80000) hop 128, 40.5% of the byte bound
// (torch.stft + abs + log 0.5510 ms; the direct DFT 1.1153 ms).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r = (r << 1) | ((i >> b) & 1);
  return r;
}

template <int N, int N1, int N2>
struct Plan {
  static_assert(N1 * N2 == N && N1 >= N2, "digit plan");
  static constexpr int kPerTransform = N2;            // threads
  static constexpr int kTransforms = kThreads / N2;   // per block
  static constexpr int kFrames = 2 * kTransforms;     // per block
  static constexpr int kRows = N1 / N2;               // step-3 rows/thread
  static constexpr int kERow = N2 + 1;                // padded, complex
  static constexpr int kEStride = N1 * kERow;
  static constexpr int kZStride = N + 1;
  static constexpr int kBuf = kTransforms * (kEStride > kZStride ? kEStride
                                                                : kZStride);
  static constexpr size_t kSmem = (size_t)(kBuf + N) * sizeof(float2) +
                                  (size_t)N * sizeof(float);
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 decimation-in-frequency FFT of L points held in
// registers: input in natural order, output bit-reversed (v[i] holds bin
// bitrev(i)).  One template instance per stage, so every loop bound and
// register index is a compile-time constant and the array stays in
// registers.  tw[m] = W_N^m = exp(-2 pi i m / N); the stage of length LEN
// uses W_LEN^j = tw[j N / LEN], the same index in every thread.
template <int L, int N, int LEN>
struct DifStages {
  static __device__ __forceinline__ void run(float2 (&v)[L],
                                             const float2* tw) {
#pragma unroll
    for (int i = 0; i < L; i += LEN) {
#pragma unroll
      for (int j = 0; j < LEN / 2; ++j) {
        const float2 a = v[i + j];
        const float2 b = v[i + j + LEN / 2];
        v[i + j] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        v[i + j + LEN / 2] = j == 0 ? d : cmul(d, tw[j * (N / LEN)]);
      }
    }
    DifStages<L, N, LEN / 2>::run(v, tw);
  }
};

template <int L, int N>
struct DifStages<L, N, 1> {
  static __device__ __forceinline__ void run(float2 (&)[L], const float2*) {}
};

template <int L, int N>
__device__ __forceinline__ void fft_registers(float2 (&v)[L],
                                              const float2* tw) {
  DifStages<L, N, L>::run(v, tw);
}

// numpy "reflect" padding (the edge sample is not repeated).  The wrapper
// guarantees n > n_fft / 2, so one reflection suffices.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

template <int N, int N1, int N2>
__global__ void __launch_bounds__(kThreads)
log_spectrogram_kernel(const float* __restrict__ wave,
                       const float2* __restrict__ twiddle,
                       const float* __restrict__ window,
                       float* __restrict__ out, int n, int hop, int n_frames,
                       float eps) {
  using C = Plan<N, N1, N2>;
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float2* s_tw = buf + C::kBuf;
  float* s_win = reinterpret_cast<float*>(s_tw + N);

  const int tid = threadIdx.x;
  for (int i = tid; i < N; i += kThreads) {
    s_tw[i] = twiddle[i];
    s_win[i] = window[i];
  }
  __syncthreads();

  const int j = tid / C::kPerTransform;  // this thread's transform
  const int p = tid % C::kPerTransform;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * C::kFrames;
  const int ta = t0 + 2 * j;  // its frames ta (real part) and ta + 1
  const float* row = wave + (size_t)b * n;
  const bool ok_a = ta < n_frames;
  const bool ok_b = ta + 1 < n_frames;
  const int start = ta * hop - N / 2;  // signal index of frame ta's sample 0

  // step 1: the N1-point FFT over n1 of z[N2 n1 + p], windowed
  float2 v[N1];
#pragma unroll
  for (int n1 = 0; n1 < N1; ++n1) {
    const int k = N2 * n1 + p;
    const float w = s_win[k];
    const float xa = ok_a ? __ldg(row + reflect(start + k, n)) : 0.f;
    const float xb = ok_b ? __ldg(row + reflect(start + hop + k, n)) : 0.f;
    v[n1] = make_float2(xa * w, xb * w);
  }
  fft_registers<N1, N>(v, s_tw);
  // step 2: twiddle W_N^(p k1) (p k1 < N), exchange E[k1][p]; register i
  // holds bin k1 = bitrev(i)
  float2* e = buf + j * C::kEStride;
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    const int k1 = bitrev(i, log2i(N1));
    e[k1 * C::kERow + p] = i == 0 ? v[0] : cmul(v[i], s_tw[p * k1]);
  }
  __syncthreads();

  // step 3: the N2-point FFTs over n2 of rows k1 = p + N2 r
  float2 u[C::kRows][N2];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int k1 = p + N2 * r;
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) u[r][n2] = e[k1 * C::kERow + n2];
    fft_registers<N2, N>(u[r], s_tw);
  }
  __syncthreads();  // every row read before Z overwrites the buffer
  float2* z = buf + j * C::kZStride;
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      z[p + N2 * r + N1 * bitrev(i, log2i(N2))] = u[r][i];
    }
  }
  __syncthreads();

  // split the pairs, |X|, log; consecutive threads take consecutive frames
  constexpr int kBins = N / 2 + 1;
  for (int idx = tid; idx < kBins * C::kFrames; idx += kThreads) {
    const int f = idx / C::kFrames;
    const int tl = idx % C::kFrames;
    const int t = t0 + tl;
    if (t >= n_frames) continue;
    const float2* zj = buf + (tl / 2) * C::kZStride;
    const float2 a = zj[f];
    const float2 c = zj[(N - f) & (N - 1)];
    // 2 X_t = a + conj(c); 2 i X_{t+1} = a - conj(c), the same modulus
    const float re = (tl & 1) ? a.x - c.x : a.x + c.x;
    const float im = (tl & 1) ? a.y + c.y : a.y - c.y;
    const float mag = 0.5f * sqrtf(re * re + im * im);
    out[((size_t)b * kBins + f) * n_frames + t] = logf(mag + eps);
  }
}

template <int N, int N1, int N2>
cudaError_t launch(const float* wave, const float* twiddle,
                   const float* window, float* out, int batch, int n, int hop,
                   int n_frames, float eps, cudaStream_t stream) {
  using C = Plan<N, N1, N2>;
  static_assert(C::kSmem <= (size_t)kMaxSmem, "shared memory");
  auto kernel = log_spectrogram_kernel<N, N1, N2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + C::kFrames - 1) / C::kFrames, batch);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      wave, reinterpret_cast<const float2*>(twiddle), window, out, n, hop,
      n_frames, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wave (batch, n) fp32; twiddle (n_fft, 2) fp32, W_n^m = (cos, sin) of
// -2 pi m / n_fft; window (n_fft,) fp32; out (batch, n_fft / 2 + 1,
// n_frames) fp32.  All contiguous, on the current device.  (n1, n2) is the
// digit plan, which must be the one compiled for n_fft.  Returns a
// cudaError_t: cudaErrorInvalidValue for a plan or shape it does not take.
int mmct_log_spectrogram(const float* wave, const float* twiddle,
                         const float* window, float* out, int batch, int n,
                         int n_fft, int n1, int n2, int hop, int n_frames,
                         float eps, void* stream) {
  if (batch <= 0 || batch > 65535 || hop <= 0 || n <= n_fft / 2 ||
      n_frames <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plan = n_fft * 10000 + n1 * 100 + n2;
  switch (plan) {
    case 64 * 10000 + 8 * 100 + 8:
      return (int)launch<64, 8, 8>(wave, twiddle, window, out, batch, n, hop,
                                   n_frames, eps, s);
    case 128 * 10000 + 16 * 100 + 8:
      return (int)launch<128, 16, 8>(wave, twiddle, window, out, batch, n,
                                     hop, n_frames, eps, s);
    case 256 * 10000 + 16 * 100 + 16:
      return (int)launch<256, 16, 16>(wave, twiddle, window, out, batch, n,
                                      hop, n_frames, eps, s);
    case 512 * 10000 + 32 * 100 + 16:
      return (int)launch<512, 32, 16>(wave, twiddle, window, out, batch, n,
                                      hop, n_frames, eps, s);
    case 1024 * 10000 + 32 * 100 + 32:
      return (int)launch<1024, 32, 32>(wave, twiddle, window, out, batch, n,
                                       hop, n_frames, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mmct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
