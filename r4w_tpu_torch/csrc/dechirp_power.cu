// Fused LoRa dechirp + FFT power for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:dechirp_power_mxu (kernel body
// _dechirp_power_kernel). For each row r of K = 2^sf complex samples,
// 32 <= K <= 4096:
//
//     out[r, b] = | sum_n x[r, n] * d[n] * exp(-2*pi*i * n * b / K) |^2
//
// The TPU kernel multiplied by two (K, K) DFT matrices on the MXU. Done as an
// FFT, the function does about K*(5*log2(K) + 9) flops per row against 12*K
// bytes of device memory (8 B of complex64 in, 4 B of float32 out), under
// 4 flop/byte at every K: it is bound by device-memory bytes, 0.0704 ms for
// the SF7 sweep's 153,600 x 128 rows and 0.0423 ms for SF12's 2,880 x 4096
// at 3.35 TB/s. So the design moves each byte once and keeps everything
// between the load and the store on chip:
//
// - One launch, one block of 256 threads per rows_per_block rows (K/16
//   threads a row; 128 rows at K = 32, one row at K = 4096), so every shape
//   gives the card many blocks. The host picks the rows per block
//   (kernels/dechirp.py: launch_plan); the kernel masks the ragged last block.
// - Loads are 16 bytes a thread (two samples), neighbouring threads on
//   neighbouring addresses. The downchirp multiply happens on load, so the
//   mixed signal never reaches device memory.
// - A Stockham (autosort) FFT: radix-16 passes, then one pass of the radix
//   left over (K = 128: 16 then 8; K = 4096: 16, 16, 16). Each thread holds
//   16 points in registers; the passes exchange them through shared memory,
//   where bins land in natural order. The last pass writes |X|^2 there, and
//   the block stores it with coalesced 4-byte stores.
// - Shared memory holds the block's points position-major, row-minor, with
//   one padding word per 32 (padded() below): consecutive threads of a warp
//   touch consecutive words, and the strided writes of a pass are at most
//   two-way bank conflicts.
// - Twiddles come from the K-entry table exp(-2*pi*i * m / K), computed in
//   float64 on the host and rounded to complex64, read at exact integer
//   indices: the in-register DFTs' own at stride K/R, and one a butterfly
//   per pass, whose powers are FP32 products (fft_pass). FP32 FMAs only:
//   no fast math, no TF32, no tensor cores, so the result stays within
//   1e-4 of the peak of an FP32 FFT.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kPoints = 16;  // points a thread holds, and the widest radix
constexpr int kMaxThreads = 1024;
constexpr int kStaticSharedBytes = 48 * 1024;  // a block's shared memory without opting in

__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

__host__ __device__ constexpr int bit_reverse(int q, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((q >> i) & 1) << (bits - 1 - i);
  return r;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// Calls f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled by the
// compiler's front end: every register-array index below is a constant, so
// the points never go to local memory.
template <typename F, int... I>
__device__ __forceinline__ void unrolled(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void unrolled(F&& f) {
  unrolled(f, std::make_integer_sequence<int, N>{});
}

// In-register radix-R DFT, decimation in frequency: on return v[s] holds
// X[bit_reverse(s)].
template <int K, int R, int SPAN = R / 2>
__device__ __forceinline__ void dft_in_registers(float2 (&v)[R], const float2* __restrict__ tw) {
  unrolled<R / 2>([&](auto i) {
    constexpr int t = decltype(i)::value % SPAN;
    constexpr int lo = decltype(i)::value / SPAN * 2 * SPAN + t;
    const float2 a = v[lo];
    const float2 b = v[lo + SPAN];
    v[lo] = make_float2(a.x + b.x, a.y + b.y);
    const float2 d = make_float2(a.x - b.x, a.y - b.y);
    if constexpr (t == 0) {
      v[lo + SPAN] = d;
    } else {
      v[lo + SPAN] = cmul(d, __ldg(tw + t * (K / (2 * SPAN))));
    }
  });
  if constexpr (SPAN > 1) dft_in_registers<K, R, SPAN / 2>(v, tw);
}

// One Stockham pass of radix R after sub-transforms of length NS are done.
// Butterfly j reads points j + r*K/R, twiddles them by W_{NS*R}^{r*(j % NS)},
// and writes X[q] to (j / NS)*NS*R + j % NS + q*NS. A thread does the
// kPoints / R butterflies j0 + b*(K / kPoints). Point i of row `row` sits at
// padded(i * rows_per_block + row).
//
// A butterfly reads one twiddle, W^(j % NS) at table stride K/(NS*R), and
// forms its powers by FP32 products (error under R ulps): the R-1 table
// entries themselves would be a gather at stride r*(j % NS), up to 32
// sectors for each warp's load.
template <int K, int R, int NS, bool LAST>
__device__ __forceinline__ void fft_pass(float* re, float* im, int rows_per_block, int row,
                                         int j0, const float2* __restrict__ tw) {
  constexpr int kThreadsPerRow = K / kPoints;
  constexpr int kButterflies = kPoints / R;
  float2 v[kButterflies][R];
  unrolled<kButterflies>([&](auto bi) {
    constexpr int b = decltype(bi)::value;
    const int j = j0 + b * kThreadsPerRow;
    unrolled<R>([&](auto ri) {
      constexpr int r = decltype(ri)::value;
      const int at = padded((j + r * (K / R)) * rows_per_block + row);
      v[b][r] = make_float2(re[at], im[at]);
    });
    if constexpr (NS > 1) {
      const float2 w = __ldg(tw + (j % NS) * (K / (NS * R)));
      float2 power = w;
      unrolled<R - 1>([&](auto ri) {
        constexpr int r = decltype(ri)::value + 1;
        v[b][r] = cmul(v[b][r], power);
        if constexpr (r + 1 < R) power = cmul(power, w);
      });
    }
    dft_in_registers<K, R>(v[b], tw);
  });
  __syncthreads();  // every point of this pass is read before any is overwritten
  unrolled<kButterflies>([&](auto bi) {
    constexpr int b = decltype(bi)::value;
    const int j = j0 + b * kThreadsPerRow;
    const int first = (j / NS) * NS * R + j % NS;
    unrolled<R>([&](auto si) {  // register s holds bin q = bit_reverse(s)
      constexpr int s = decltype(si)::value;
      constexpr int q = bit_reverse(s, log2_of(R));
      const float2 x = v[b][s];
      const int at = padded((first + q * NS) * rows_per_block + row);
      if constexpr (LAST) {
        re[at] = x.x * x.x + x.y * x.y;
      } else {
        re[at] = x.x;
        im[at] = x.y;
      }
    });
  });
  __syncthreads();
}

// Radix-kPoints passes while they fit, then one pass of the radix left over.
template <int K, int NS>
__device__ __forceinline__ void fft_passes(float* re, float* im, int rows_per_block, int row,
                                           int j0, const float2* __restrict__ tw) {
  constexpr int R = K / NS >= kPoints ? kPoints : K / NS;
  constexpr bool kLast = NS * R == K;
  fft_pass<K, R, NS, kLast>(re, im, rows_per_block, row, j0, tw);
  if constexpr (!kLast) fft_passes<K, NS * R>(re, im, rows_per_block, row, j0, tw);
}

template <int K>
__global__ void dechirp_power_kernel(const float4* __restrict__ x,
                                     const float4* __restrict__ down,
                                     const float2* __restrict__ tw, float* __restrict__ out,
                                     int rows, int rows_per_block) {
  extern __shared__ float smem[];
  const int n = rows_per_block * K;  // = blockDim.x * kPoints
  float* re = smem;
  float* im = smem + padded(n);

  const int first_row = blockIdx.x * rows_per_block;
  const int valid = min(rows_per_block, rows - first_row) * K;  // points of real rows
  const size_t base = static_cast<size_t>(first_row) * K;

  // Load two samples a thread per step, dechirp them, stage them.
#pragma unroll
  for (int i = 0; i < kPoints / 2; ++i) {
    const int p = 2 * (threadIdx.x + i * blockDim.x);
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < valid) {
      const float4 a = x[(base + p) / 2];
      const float4 d = down[(p % K) / 2];
      m = make_float4(a.x * d.x - a.y * d.y, a.x * d.y + a.y * d.x,
                      a.z * d.z - a.w * d.w, a.z * d.w + a.w * d.z);
    }
    const int at0 = padded((p % K) * rows_per_block + p / K);
    const int at1 = padded((p % K + 1) * rows_per_block + p / K);
    re[at0] = m.x;
    im[at0] = m.y;
    re[at1] = m.z;
    im[at1] = m.w;
  }
  __syncthreads();

  fft_passes<K, 1>(re, im, rows_per_block, threadIdx.x % rows_per_block,
                   threadIdx.x / rows_per_block, tw);

#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    if (p < valid) out[base + p] = re[padded((p % K) * rows_per_block + p / K)];
  }
}

template <int K>
cudaError_t launch(const float2* x, const float2* down, const float2* twiddle, float* out,
                   int rows, int rows_per_block, cudaStream_t stream) {
  const int threads = K / kPoints * rows_per_block;
  const int smem = 2 * static_cast<int>(sizeof(float)) * padded(rows_per_block * K);
  if (threads > kMaxThreads || threads % 32 != 0 || smem > kStaticSharedBytes) {
    return cudaErrorInvalidConfiguration;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  dechirp_power_kernel<K><<<blocks, threads, smem, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(down), twiddle, out,
      rows, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, k) complex64, down and twiddle: (k,) complex64, out: (rows, k)
// float32, all contiguous on the current device, x and down 16-byte aligned;
// k a power of two in [32, 4096]; rows_per_block >= 1, with k / 16 *
// rows_per_block threads a block, a multiple of 32 and at most 1024, and
// the block's points within 48 KB of shared memory.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success).
extern "C" int r4w_dechirp_power(const float2* x, const float2* down, const float2* twiddle,
                                 float* out, int rows, int k, int rows_per_block,
                                 cudaStream_t stream) {
  if (rows < 0 || rows_per_block < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(down) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  if (rows == 0) return cudaSuccess;
  switch (k) {
    case 32: return launch<32>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 64: return launch<64>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 128: return launch<128>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 256: return launch<256>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 512: return launch<512>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 1024: return launch<1024>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 2048: return launch<2048>(x, down, twiddle, out, rows, rows_per_block, stream);
    case 4096: return launch<4096>(x, down, twiddle, out, rows, rows_per_block, stream);
    default: return cudaErrorInvalidValue;
  }
}
