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
// sample against a sincos and six flops. Each thread moves two samples with
// one 16-byte load and one 16-byte store (one sample a thread when a
// pointer is not 16-byte aligned).
//
// The phase repeats the reference's float32 roundings exactly: float(j)
// rounded to nearest from the 64-bit index, the product rounded, then the
// sum rounded. __fmul_rn/__fadd_rn keep nvcc from contracting them into one
// FMA, which would move ph by an ulp at some indices, and an ulp is already
// 0.06 rad at the phases a stream of 2^20 samples reaches. For the same
// reason sincosf is the accurate one (no --use_fast_math, no __sinf): the
// error of the fast versions grows with |ph|, which reaches 10^6 rad here.
// Past |ph| = 105615 that accurate argument reduction takes its slow path.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 mix(float2 v, long long j, float omega, float phase0,
                                      float gain) {
  const float ph = __fadd_rn(__fmul_rn(omega, __ll2float_rn(j)), phase0);
  float s;
  float c;
  sincosf(ph, &s, &c);
  return make_float2(gain * (v.x * c - v.y * s), gain * (v.x * s + v.y * c));
}

// Samples 2i and 2i + 1 of the flattened (rows, n) block.
__global__ void __launch_bounds__(kThreads)
    nco_mix_pairs(const float4* __restrict__ x, float4* __restrict__ out,
                  long long total, long long n, float omega, float phase0, float gain) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long s = 2 * i;
  if (s >= total) return;
  const long long j = s % n;
  if (s + 1 < total) {
    const float4 v = x[i];
    const long long j1 = j + 1 == n ? 0 : j + 1;
    const float2 a = mix(make_float2(v.x, v.y), j, omega, phase0, gain);
    const float2 b = mix(make_float2(v.z, v.w), j1, omega, phase0, gain);
    out[i] = make_float4(a.x, a.y, b.x, b.y);
  } else {
    const float2 v = reinterpret_cast<const float2*>(x)[s];
    reinterpret_cast<float2*>(out)[s] = mix(v, j, omega, phase0, gain);
  }
}

// Sample i of the flattened (rows, n) block.
__global__ void __launch_bounds__(kThreads)
    nco_mix_single(const float2* __restrict__ x, float2* __restrict__ out,
                   long long total, long long n, float omega, float phase0, float gain) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = mix(x[i], i % n, omega, phase0, gain);
}

}  // namespace

// x, out: (rows, n) complex64, contiguous on the current device; omega,
// phase0 and gain already rounded to float32 by the caller. Launches on
// `stream` without synchronising and returns the launch's cudaError_t (0 on
// success).
extern "C" int r4w_nco_mix(const float2* x, float2* out, long long rows, long long n,
                           float omega, float phase0, float gain, cudaStream_t stream) {
  if (rows < 0 || n < 0) return cudaErrorInvalidValue;
  const long long total = rows * n;
  if (total == 0) return cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long items = aligned ? (total + 1) / 2 : total;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (aligned) {
    nco_mix_pairs<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), total, n, omega,
        phase0, gain);
  } else {
    nco_mix_single<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, out, total, n, omega, phase0, gain);
  }
  return cudaGetLastError();
}
