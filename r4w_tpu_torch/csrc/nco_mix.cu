// Oscillator mix (NCO rotate and gain) for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:nco_mix (kernel body
// _nco_kernel). For each row of n complex64 samples and index j < n:
//
//     out[j] = x[j] * gain * exp(i * ph[j]),   ph[j] = omega * float(j) + phase0
//
// with the carrier computed in the kernel and never stored.
//
// What bounds it: device-memory bytes, 8 bytes read and 8 written per
// sample. The carrier depends on the column j only, so a thread computes it
// once and applies it to a tile of kRowTile rows: one sincos per column and
// tile, not one per sample. The thread owns a column pair (j, j+1) and
// moves each row's pair with one 16-byte load and one 16-byte store; it
// issues the tile's loads before its first store, so they overlap, and the
// first tile's loads before the sincos, so the sincos overlaps them. When n
// is odd or a pointer is not 16-byte aligned, a thread owns one column and
// moves 8 bytes a row. The grid is (column blocks, row tiles), the row
// tiles walked with a stride of gridDim.y when there are more than the
// grid holds; the ragged last tile and the ragged last column block are
// masked. The host plans the launch (kernels/nco.py: nco_plan) and this
// entry point checks the plan.
//
// The phase repeats the reference's float32 roundings exactly: float(j)
// rounded to nearest from the 64-bit index, the product rounded, then the
// sum rounded. __fmul_rn/__fadd_rn keep nvcc from contracting them into one
// FMA, which would move ph by an ulp at some indices, and an ulp is already
// 0.06 rad at the phases a stream of 2^20 samples reaches. For the same
// reason sincosf is the accurate one (no --use_fast_math, no __sinf): the
// error of the fast versions grows with |ph|, which reaches 10^6 rad here.
// Past |ph| = 105615 that accurate argument reduction takes its slow path;
// shared by 8 rows it costs a few percent of the bytes' time. A one-row
// call has nothing to share and still pays one sincosf a sample.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;           // rows that share one carrier
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float2 carrier(long long j, float omega, float phase0) {
  const float ph = __fadd_rn(__fmul_rn(omega, __ll2float_rn(j)), phase0);
  float2 cs;
  sincosf(ph, &cs.y, &cs.x);
  return cs;  // (cos, sin)
}

__device__ __forceinline__ float2 rotate(float2 v, float2 cs, float gain) {
  return make_float2(gain * (v.x * cs.x - v.y * cs.y), gain * (v.x * cs.y + v.y * cs.x));
}

// Columns 2p and 2p + 1 of every row, n even: row r's pair is x[r * n/2 + p].
__global__ void __launch_bounds__(kThreads)
    nco_mix_pairs(const float4* __restrict__ x, float4* __restrict__ out, long long rows,
                  long long n, float omega, float phase0, float gain) {
  const long long half = n / 2;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= half) return;
  float2 c0, c1;
  bool first = true;
  for (long long r0 = static_cast<long long>(blockIdx.y) * kRowTile; r0 < rows;
       r0 += static_cast<long long>(gridDim.y) * kRowTile) {
    const float4* src = x + r0 * half + p;
    float4* dst = out + r0 * half + p;
    float4 v[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r0 + r < rows) v[r] = src[r * half];
    }
    if (first) {  // after the first tile's loads, so the sincos overlaps them
      c0 = carrier(2 * p, omega, phase0);
      c1 = carrier(2 * p + 1, omega, phase0);
      first = false;
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r0 + r < rows) {
        const float2 a = rotate(make_float2(v[r].x, v[r].y), c0, gain);
        const float2 b = rotate(make_float2(v[r].z, v[r].w), c1, gain);
        dst[r * half] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  }
}

// Column j of every row: row r's sample is x[r * n + j].
__global__ void __launch_bounds__(kThreads)
    nco_mix_single(const float2* __restrict__ x, float2* __restrict__ out, long long rows,
                   long long n, float omega, float phase0, float gain) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  float2 cs;
  bool first = true;
  for (long long r0 = static_cast<long long>(blockIdx.y) * kRowTile; r0 < rows;
       r0 += static_cast<long long>(gridDim.y) * kRowTile) {
    const float2* src = x + r0 * n + j;
    float2* dst = out + r0 * n + j;
    float2 v[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r0 + r < rows) v[r] = src[r * n];
    }
    if (first) {
      cs = carrier(j, omega, phase0);
      first = false;
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r0 + r < rows) dst[r * n] = rotate(v[r], cs, gain);
    }
  }
}

}  // namespace

// x, out: (rows, n) complex64, contiguous on the current device; omega,
// phase0 and gain already rounded to float32 by the caller. The launch
// plan comes from kernels/nco.py:nco_plan: pairs (column pairs, 16-byte
// accesses) only when n is even and both pointers are 16-byte aligned;
// blocks_x of 256 threads must cover the n/2 pairs (or n columns);
// blocks_y must cover the tiles of 8 rows, up to 65535. Launches on
// `stream` without synchronising and returns the launch's cudaError_t (0
// on success).
extern "C" int r4w_nco_mix(const float2* x, float2* out, long long rows, long long n,
                           float omega, float phase0, float gain, long long blocks_x,
                           long long blocks_y, int pairs, cudaStream_t stream) {
  if (rows < 0 || n < 0) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long items = pairs ? n / 2 : n;
  const long long tiles = (rows + kRowTile - 1) / kRowTile;
  if ((pairs && (n % 2 != 0 || !aligned)) || blocks_x < 1 || blocks_x > 0x7fffffffLL ||
      blocks_x * kThreads < items || blocks_y < (tiles < kMaxGridY ? tiles : kMaxGridY) ||
      blocks_y > kMaxGridY) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  if (pairs) {
    nco_mix_pairs<<<grid, kThreads, 0, stream>>>(reinterpret_cast<const float4*>(x),
                                                 reinterpret_cast<float4*>(out), rows, n,
                                                 omega, phase0, gain);
  } else {
    nco_mix_single<<<grid, kThreads, 0, stream>>>(x, out, rows, n, omega, phase0, gain);
  }
  return cudaGetLastError();
}
