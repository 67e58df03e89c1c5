// FIR filter with decimation for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:fir_decimate (core
// _fir_pallas_1x, kernel body _fir_kernel). For each row b of x:
//
//     y[b, j] = sum_{t < K} taps[t] * x[b, j*f + t],   j < n_out,
//     n_out = max((N - K) / f + 1, 0)
//
// in correlation form, computing only the kept outputs. x is real float32
// or complex64; real taps filter the real and imaginary parts of a complex
// sample in one pass (8 bytes read per sample). Sums are FP32 FMAs in tap
// order.
//
// What bounds it: device-memory bytes. Each input sample is read once and
// each output written once, against 2K (real) or 4K (complex) flops per
// output: at K = 63 on complex input that is 3.9 flop/byte at the DDC's
// f = 8 and 15.7 flop/byte at the dense f = 1, both under the card's FP32
// ridge of 20 flop/byte (67 TFLOP/s over 3.35 TB/s).
//
// Design: a block computes threads * R consecutive outputs. The taps are
// walked in chunks of at most 256; for each chunk the block stages the
// chunk's taps and its input window in shared memory with coalesced loads,
// then each thread accumulates its R outputs (outputs i, i + T, ..., so the
// R accumulators stay in registers across chunks and K has no upper limit).
// A strided read x[j*f + t] by neighbouring threads would hit the same
// shared-memory banks for even f, so the window is stored as its f
// polyphase planes, plane[p][e] = x[base + e*f + p]: tap t = q*f + p of
// output i reads plane[p][i + q], consecutive addresses for consecutive
// threads. Only the planes a chunk's taps touch are staged, so a factor
// above K loads no gaps. Block shape and chunk length are picked on the
// host to keep shared memory within 48 KB. No TMA and no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 256;           // taps staged per pass
constexpr size_t kSmemBudget = 48 * 1024;  // dynamic shared memory per block
constexpr long long kMaxGridY = 65535;

template <typename T>
struct Sample;

template <>
struct Sample<float> {
  __device__ static float zero() { return 0.0f; }
  __device__ static float fma(float w, float v, float acc) { return fmaf(w, v, acc); }
};

template <>
struct Sample<float2> {
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static float2 fma(float w, float2 v, float2 acc) {
    return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
  }
};

// One block: outputs [blockIdx.x * T * R, (blockIdx.x + 1) * T * R) of row
// blockIdx.y. `entries` is the plane stride in shared memory (odd).
template <typename T, int R>
__global__ void __launch_bounds__(256)
    fir_decimate_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                        T* __restrict__ out, long long n, int k, int f,
                        long long n_out, int chunk, int entries) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int block_out = nt * R;
  T* win = reinterpret_cast<T*>(smem);
  float* tap_s = reinterpret_cast<float*>(win + static_cast<size_t>(min(f, chunk)) * entries);

  const long long j0 = static_cast<long long>(blockIdx.x) * block_out;
  const T* row = x + static_cast<long long>(blockIdx.y) * n;

  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = Sample<T>::zero();

  for (int t0 = 0; t0 < k; t0 += chunk) {
    const int tn = min(chunk, k - t0);
    const int planes = min(f, tn);
    const int need = block_out + (tn - 1) / f;  // entries per plane this pass
    const long long base = j0 * f + t0;
    for (int i = threadIdx.x; i < tn; i += nt) tap_s[i] = taps[t0 + i];
    // g = e * planes + p walks the window in input order (contiguous when
    // planes == f); (e, p) advance by (nt / planes, nt % planes) per step.
    const int total = planes * need;
    const int de = nt / planes;
    const int dp = nt - de * planes;
    int e = threadIdx.x / planes;
    int p = threadIdx.x - e * planes;
    for (int g = threadIdx.x; g < total; g += nt) {
      const long long idx = base + static_cast<long long>(e) * f + p;
      win[p * entries + e] = idx < n ? row[idx] : Sample<T>::zero();
      e += de;
      p += dp;
      if (p >= planes) {
        p -= planes;
        ++e;
      }
    }
    __syncthreads();
    // tap tau = q * f + p2 of output i reads plane[p2][i + q]
    int p2 = 0;
    int q = 0;
    for (int tau = 0; tau < tn; ++tau) {
      const float w = tap_s[tau];
      const T* src = win + p2 * entries + q + threadIdx.x;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = Sample<T>::fma(w, src[r * nt], acc[r]);
      if (++p2 == f) {
        p2 = 0;
        ++q;
      }
    }
    __syncthreads();
  }

  T* dst = out + static_cast<long long>(blockIdx.y) * n_out;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j = j0 + threadIdx.x + r * nt;
    if (j < n_out) dst[j] = acc[r];
  }
}

struct Config {
  int threads;
  int r;
  int chunk;
  int entries;
  size_t smem;
};

// The largest block (threads * R outputs) and tap chunk whose staged window
// and taps fit kSmemBudget; at worst 32 threads, R = 1, one tap per pass.
Config choose(int k, int f, size_t elem) {
  for (int chunk = k < kMaxChunk ? k : kMaxChunk;; chunk = (chunk + 1) / 2) {
    const int planes = f < chunk ? f : chunk;
    for (int threads = 256; threads >= 32; threads /= 2) {
      for (int r = 4; r >= 1; r /= 2) {
        const int entries = (threads * r + (chunk - 1) / f) | 1;
        const size_t smem = static_cast<size_t>(planes) * entries * elem +
                            static_cast<size_t>(chunk) * sizeof(float);
        if (smem <= kSmemBudget) return Config{threads, r, chunk, entries, smem};
      }
    }
    if (chunk == 1) return Config{0, 0, 0, 0, 0};  // unreachable: 268 bytes fit
  }
}

template <typename T, int R>
cudaError_t launch_rows(const T* x, const float* taps, T* out, long long rows,
                        long long n, int k, int f, long long n_out,
                        const Config& c, cudaStream_t stream) {
  const long long block_out = static_cast<long long>(c.threads) * R;
  const long long tiles = (n_out + block_out - 1) / block_out;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  for (long long row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const long long nrows = rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(nrows));
    fir_decimate_kernel<T, R><<<grid, c.threads, c.smem, stream>>>(
        x + row0 * n, taps, out + row0 * n_out, n, k, f, n_out, c.chunk, c.entries);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const T* x, const float* taps, T* out, long long rows,
                   long long n, int k, int f, long long n_out,
                   cudaStream_t stream) {
  const Config c = choose(k, f, sizeof(T));
  if (c.threads == 0) return cudaErrorInvalidConfiguration;
  switch (c.r) {
    case 4:
      return launch_rows<T, 4>(x, taps, out, rows, n, k, f, n_out, c, stream);
    case 2:
      return launch_rows<T, 2>(x, taps, out, rows, n, k, f, n_out, c, stream);
    default:
      return launch_rows<T, 1>(x, taps, out, rows, n, k, f, n_out, c, stream);
  }
}

}  // namespace

// x: (rows, n) float32 (is_complex == 0) or complex64 (is_complex == 1),
// taps: (k,) float32, out: (rows, n_out) of x's type, all contiguous on the
// current device; k >= 1, f >= 1, n_out = max((n - k) / f + 1, 0).
// Launches on `stream` without synchronising and returns the launches'
// cudaError_t (0 on success).
extern "C" int r4w_fir_decimate(const void* x, const float* taps, void* out,
                                long long rows, long long n, int k, int f,
                                long long n_out, int is_complex,
                                cudaStream_t stream) {
  if (rows < 0 || n < 0 || k < 1 || f < 1) return cudaErrorInvalidValue;
  if (n_out != (n >= k ? (n - k) / f + 1 : 0)) return cudaErrorInvalidValue;
  if (rows == 0 || n_out == 0) return cudaSuccess;
  if (is_complex) {
    return launch(static_cast<const float2*>(x), taps, static_cast<float2*>(out),
                  rows, n, k, f, n_out, stream);
  }
  return launch(static_cast<const float*>(x), taps, static_cast<float*>(out), rows,
                n, k, f, n_out, stream);
}
