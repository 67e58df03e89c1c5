// FIR filter with decimation for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:fir_decimate (core
// _fir_pallas_1x, kernel body _fir_kernel). Row b reads the virtual stream
// v = state[b] ‖ x[b] of s + N samples, where s = 0 (no state) or K - 1 (a
// filter's carried state, read as zeros when the state pointer is null):
//
//     y[b, j] = sum_{t < K} taps[t] * v[b, j*f + t],   j < n_out,
//     n_out = max((s + N - K) / f + 1, 0)
//
// in correlation form, computing only the kept outputs. The state and the
// block are two pointers: sample g of v comes from state[b, g] when g < s
// and from x[b, g - s] otherwise, so a streaming filter never builds
// state ‖ x in device memory. x is real float32 or complex64; real taps
// filter the real and imaginary parts of a complex sample in one pass.
// Sums are FP32 FMAs, in tap order within each polyphase plane.
//
// What bounds it: device-memory bytes at the DDC's f = 8 (3.9 flop/byte on
// complex input at K = 63) and, nearly, at f = 1 (15.7 flop/byte, under the
// card's FP32 ridge of 20). Reading every tap of every output from shared
// memory, as a thread per output would, makes the dense filter
// shared-memory-bound instead: 63 loads of 8 bytes an output.
//
// Design: a tile is threads * R consecutive outputs of one row, R = 9. For each
// chunk of at most 256 taps a block stages the tile's window with cp.async,
// one copy a sample, in three runs of stream order (the state, or zeros
// before a null state; x; zeros past the row's end), as its f polyphase
// planes, plane[p][e] = v[base + e*f + p], so that tap t = q*f + p of
// output i reads plane[p][i + q]; only the planes the chunk's taps touch are
// staged. The chunk's taps are staged per plane, tap[p][q], zero-padded to a
// multiple of the window step. Thread l keeps the R consecutive outputs
// l*R ... l*R + R - 1 in registers and slides a register window of R + 7
// plane entries along each plane: per step of 8 taps it loads the 8 new
// entries once and applies each to R outputs, so a plane costs R + Q - 1
// shared loads for R outputs, not R * Q (Q = ceil(K / f) taps a plane); the
// 8 taps of a step are two warp-uniform 16-byte loads (broadcasts). Every
// register index is a compile-time constant: the window does not go to
// local memory. R is odd, so the 32 lanes' loads at a stride of R samples
// hit distinct banks (an even R gives up to 16-way conflicts on 8-byte
// samples); 9 was as fast as or faster than 5 and 7 at every factor on both
// sample types (PERF.md). The outputs go back through shared memory (the
// window's space) and leave in coalesced stores.
//
// A block computes one tile and holds one stage. Blocks are small (the
// host keeps a block's shared memory within 48 KB: 37 KB at complex f = 8
// and K = 63, 19 KB at f = 1) so that several stay resident on an SM and one
// block's staging overlaps another's FMAs; a persistent variant that staged
// its next tile while computing this one was no faster at either shape. The
// host plans the launch (kernels/fir.py: fir_plan: threads, tap chunk, plane
// stride and shared memory) and this entry point only checks that the plan's
// layout fits its shared memory and the budget. No tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 9;                      // consecutive outputs a thread keeps in registers
constexpr int kStep = 8;                   // taps a window step applies
constexpr int kMaxChunk = 256;             // taps staged per pass
constexpr int kMaxThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;  // dynamic shared memory per block
constexpr long long kMaxGridY = 65535;

template <typename T>
struct Sample;

template <>
struct Sample<float> {
  __device__ static float zero() { return 0.0f; }
  __device__ static float fma(float w, float v, float acc) { return fmaf(w, v, acc); }
  __device__ static void copy_async(float* dst, const float* src) {
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(src) : "memory");
  }
};

template <>
struct Sample<float2> {
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static float2 fma(float w, float2 v, float2 acc) {
    return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
  }
  __device__ static void copy_async(float2* dst, const float2* src) {
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(at), "l"(src) : "memory");
  }
};

// Entries a plane holds and taps a plane row holds, for a chunk of `chunk` taps.
__host__ __device__ inline int taps_per_plane(int chunk, int f) { return (chunk + f - 1) / f; }
__host__ __device__ inline int tap_stride(int chunk, int f) {
  return (taps_per_plane(chunk, f) + kStep - 1) / kStep * kStep;
}

// The first window entry g = e * planes + p (p < planes) whose stream
// offset e * f + p is at least d; `total` if none is.
__device__ __forceinline__ int first_entry(long long d, int f, int planes, int total) {
  if (d <= 0) return 0;
  const long long e = d / f;
  const int rem = static_cast<int>(d - e * f);
  const long long g = rem < planes ? e * planes + rem : (e + 1) * planes;
  return g < total ? static_cast<int>(g) : total;
}

// Stage this thread's window entries g in [g_lo, g_hi), those with
// g = threadIdx.x mod blockDim.x: entry g = e * planes + p goes to
// win[p * entries + e] and holds row[first + e * f + p] (by cp.async), or
// zero when kZero. (e, p) and both addresses advance by blockDim.x entries a
// step, with one carry, so a sample costs a copy and a few adds.
template <typename T, bool kZero>
__device__ __forceinline__ void stage(T* win, const T* row, long long first, int g_lo, int g_hi,
                                      int planes, int f, int entries) {
  const int nt = blockDim.x;
  int g = g_lo + (static_cast<int>(threadIdx.x) - g_lo % nt + nt) % nt;
  if (g >= g_hi) return;
  int e = g / planes;
  int p = g - e * planes;
  const int de = nt / planes;
  const int dp = nt - de * planes;
  T* dst = win + p * entries + e;
  long long at = first + static_cast<long long>(e) * f + p;
  for (; g < g_hi; g += nt) {
    if (kZero) {
      *dst = Sample<T>::zero();
    } else {
      Sample<T>::copy_async(dst, row + at);
    }
    dst += dp * entries + de;
    at += static_cast<long long>(de) * f + dp;
    p += dp;
    if (p >= planes) {
      p -= planes;
      dst += 1 - planes * entries;
      at += f - planes;
    }
  }
}

// One window step: taps q0 .. q0 + 7 of a plane (the first `un` of them when
// kTail). `src` points at the step's first new entry, buf[R - 1]; `w` at tap q0.
template <typename T, int R, bool kTail>
__device__ __forceinline__ void window_step(const T* src, const float* w, int un,
                                            T (&buf)[R + kStep - 1], T (&acc)[R]) {
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    if (!kTail || u < un) buf[R - 1 + u] = src[u];
  }
  const float4 w0 = reinterpret_cast<const float4*>(w)[0];
  const float4 w1 = reinterpret_cast<const float4*>(w)[1];
  const float wv[kStep] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    if (!kTail || u < un) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = Sample<T>::fma(wv[u], buf[r + u], acc[r]);
    }
  }
}

// The qn taps of one plane on this thread's R outputs: `src` is the plane
// at the thread's first output, `w` the plane's taps.
template <typename T, int R>
__device__ __forceinline__ void plane_pass(const T* src, const float* w, int qn, T (&acc)[R]) {
  T buf[R + kStep - 1];
#pragma unroll
  for (int i = 0; i < R - 1; ++i) buf[i] = src[i];
  int q0 = 0;
  for (; q0 + kStep <= qn; q0 += kStep) {
    window_step<T, R, false>(src + R - 1 + q0, w + q0, kStep, buf, acc);
#pragma unroll
    for (int i = 0; i < R - 1; ++i) buf[i] = buf[i + kStep];
  }
  if (q0 < qn) window_step<T, R, true>(src + R - 1 + q0, w + q0, qn - q0, buf, acc);
}

// One block: the tile of outputs [blockIdx.x * T * R, (blockIdx.x + 1) * T * R)
// of row blockIdx.y, chunk by chunk. `entries` is the plane stride in
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    fir_decimate_kernel(const T* __restrict__ state, const T* __restrict__ x,
                        const float* __restrict__ taps, T* __restrict__ out, long long s,
                        long long n, int k, int f, long long n_out, int chunk, int entries) {
  constexpr int R = kR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int block_out = nt * R;
  const int stride = tap_stride(chunk, f);
  const long long row = blockIdx.y;
  const long long j0 = static_cast<long long>(blockIdx.x) * block_out;

  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = Sample<T>::zero();

  T* win = nullptr;
  for (int t0 = 0; t0 < k; t0 += chunk) {
    const int tn = min(chunk, k - t0);
    const int planes = min(f, tn);
    float* tap_s = reinterpret_cast<float*>(smem);
    win = reinterpret_cast<T*>(tap_s + planes * stride);  // 32-byte aligned
    for (int i = threadIdx.x; i < planes * stride; i += nt) {
      const int p = i / stride;
      const int t = (i - p * stride) * f + p;
      if (t < tn) {
        Sample<float>::copy_async(tap_s + i, taps + t0 + t);
      } else {
        tap_s[i] = 0.0f;
      }
    }
    // The window's entries in stream order, g = e * planes + p (contiguous
    // samples when planes == f): those before x from the state (zeros for a
    // null state), then x, then zeros past the row's end.
    const long long base = j0 * f + t0;
    const int total = planes * (block_out + taps_per_plane(tn, f) - 1);
    const int g_x = first_entry(s - base, f, planes, total);
    const int g_end = first_entry(s + n - base, f, planes, total);
    if (state != nullptr) {
      stage<T, false>(win, state + row * s, base, 0, g_x, planes, f, entries);
    } else {
      stage<T, true>(win, nullptr, 0, 0, g_x, planes, f, entries);
    }
    stage<T, false>(win, x + row * n, base - s, g_x, g_end, planes, f, entries);
    stage<T, true>(win, nullptr, 0, g_end, total, planes, f, entries);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int p = 0; p < planes; ++p) {
      plane_pass<T, R>(win + p * entries + threadIdx.x * R, tap_s + p * stride,
                       taps_per_plane(tn - p, f), acc);
    }
    __syncthreads();
  }

  // Through shared memory (odd R: no conflicts) to coalesced stores.
#pragma unroll
  for (int r = 0; r < R; ++r) win[threadIdx.x * R + r] = acc[r];
  __syncthreads();
  T* dst = out + row * n_out + j0;
  const long long left = n_out - j0;
  for (int j = threadIdx.x; j < block_out && j < left; j += nt) dst[j] = win[j];
}

template <typename T>
cudaError_t launch(const T* state, const T* x, const float* taps, T* out, long long rows,
                   long long s, long long n, int k, int f, long long n_out, int threads,
                   int chunk, int entries, int smem, cudaStream_t stream) {
  // the plan's layout: each of the planes holds the chunk's taps of its plane
  // and `entries` window samples, enough for the tile and its taps' reach
  const int planes = f < chunk ? f : chunk;
  const size_t plane_bytes = tap_stride(chunk, f) * sizeof(float) + entries * sizeof(T);
  if (entries < threads * kR + taps_per_plane(chunk, f) - 1 || smem < 0 ||
      planes * plane_bytes > static_cast<size_t>(smem) ||
      static_cast<size_t>(smem) > kSmemBudget) {
    return cudaErrorInvalidConfiguration;
  }
  const long long block_out = static_cast<long long>(threads) * kR;
  const long long tiles = (n_out + block_out - 1) / block_out;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  for (long long row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const long long nrows = rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(nrows));
    fir_decimate_kernel<T><<<grid, threads, smem, stream>>>(
        state == nullptr ? nullptr : state + row0 * s, x + row0 * n, taps, out + row0 * n_out, s,
        n, k, f, n_out, chunk, entries);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// state: (rows, s) samples or null (zeros), x: (rows, n) float32
// (is_complex == 0) or complex64 (is_complex == 1), taps: (k,) float32,
// out: (rows, n_out) of x's type, all contiguous on the current device;
// k >= 1, f >= 1, s = 0 or k - 1 (a non-null state needs s = k - 1),
// n_out = max((s + n - k) / f + 1, 0). The launch plan comes from
// kernels/fir.py:fir_plan: threads (32-256, a multiple of 32), the tap
// chunk (1 to min(k, 256)), the plane stride `entries` and the block's
// shared memory `smem` in bytes, at most 48 KB. Launches on `stream`
// without synchronising and returns the launches' cudaError_t (0 on
// success).
extern "C" int r4w_fir_decimate(const void* state, const void* x, const float* taps, void* out,
                                long long rows, long long s, long long n, int k, int f,
                                long long n_out, int is_complex, int threads, int chunk,
                                int entries, int smem, cudaStream_t stream) {
  if (rows < 0 || n < 0 || k < 1 || f < 1) return cudaErrorInvalidValue;
  if ((s != 0 && s != k - 1) || (state != nullptr && s != k - 1)) return cudaErrorInvalidValue;
  if (n_out != (s + n >= k ? (s + n - k) / f + 1 : 0)) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || chunk < 1 ||
      chunk > (k < kMaxChunk ? k : kMaxChunk)) {
    return cudaErrorInvalidConfiguration;
  }
  if (rows == 0 || n_out == 0) return cudaSuccess;
  if (is_complex) {
    return launch(static_cast<const float2*>(state), static_cast<const float2*>(x), taps,
                  static_cast<float2*>(out), rows, s, n, k, f, n_out, threads, chunk, entries,
                  smem, stream);
  }
  return launch(static_cast<const float*>(state), static_cast<const float*>(x), taps,
                static_cast<float*>(out), rows, s, n, k, f, n_out, threads, chunk, entries, smem,
                stream);
}
