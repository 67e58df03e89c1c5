// Fused LoRa dechirp + DFT power for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:dechirp_power_mxu (kernel body
// _dechirp_power_kernel). For each row r of K = 2^sf complex samples:
//
//     out[r, b] = | sum_n x[r, n] * d[n] * exp(-2*pi*i * n * b / K) |^2
//
// The TPU kernel multiplied by two (K, K) DFT matrices on the MXU; at
// K = 4096 those would be 2 x 64 MB. Here a (K,) twiddle table is staged in
// shared memory and read at the exact integer index (n * b) & (K - 1).
//
// Layout: one block per row; each thread owns BINS output bins
// (b = threadIdx.x + j * blockDim.x) and loops over n. The row is dechirped
// while it is loaded into shared memory, so the mixed signal never reaches
// device memory. Sums are FP32 FMAs on the CUDA cores: no TF32, no tensor
// cores, because the result must agree with an FP32 FFT to 1e-4 of the peak.
//
// The direct DFT does 8*K^2 flops per row against 12*K bytes of device
// memory traffic (complex row in, float power out), 2K/3 flop/byte: above
// the card's FP32 ridge for every K >= 32, so the kernel is bound by FP32
// issue and by the shared-memory twiddle read that feeds each four FMAs,
// never by device memory.

#include <cuda_runtime.h>

namespace {

template <int BINS>
__global__ void dechirp_power_kernel(const float2* __restrict__ x,
                                     const float2* __restrict__ down,
                                     const float2* __restrict__ twiddle,
                                     float* __restrict__ out, int k) {
  extern __shared__ float2 smem[];
  float2* row = smem;     // dechirped row m[n] = x[r, n] * d[n]
  float2* tw = smem + k;  // tw[i] = exp(-2*pi*i * i / k)

  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(k);
  for (int n = threadIdx.x; n < k; n += blockDim.x) {
    const float2 a = x[base + n];
    const float2 d = down[n];
    row[n] = make_float2(a.x * d.x - a.y * d.y, a.x * d.y + a.y * d.x);
    tw[n] = twiddle[n];
  }
  __syncthreads();

  const int mask = k - 1;
  float re[BINS];
  float im[BINS];
  int idx[BINS];  // (n * b) & mask, advanced by b for each n
#pragma unroll
  for (int j = 0; j < BINS; ++j) {
    re[j] = 0.0f;
    im[j] = 0.0f;
    idx[j] = 0;
  }
  for (int n = 0; n < k; ++n) {
    const float2 m = row[n];
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const float2 w = tw[idx[j]];
      re[j] = fmaf(m.x, w.x, fmaf(-m.y, w.y, re[j]));
      im[j] = fmaf(m.x, w.y, fmaf(m.y, w.x, im[j]));
      idx[j] = (idx[j] + threadIdx.x + j * blockDim.x) & mask;
    }
  }
#pragma unroll
  for (int j = 0; j < BINS; ++j) {
    out[base + threadIdx.x + j * blockDim.x] = re[j] * re[j] + im[j] * im[j];
  }
}

template <int BINS>
cudaError_t launch(const float2* x, const float2* down, const float2* twiddle,
                   float* out, int rows, int k, int threads,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float2);
  if (smem > 48 * 1024) {
    // Above 48 KB a block may use shared memory only as dynamic shared
    // memory, after raising this attribute (64 KB at K = 4096).
    const cudaError_t err = cudaFuncSetAttribute(
        dechirp_power_kernel<BINS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dechirp_power_kernel<BINS><<<rows, threads, smem, stream>>>(x, down, twiddle,
                                                             out, k);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, k) complex64, down and twiddle: (k,) complex64, out: (rows, k)
// float32, all contiguous on the current device; k a power of two in
// [32, 4096]. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success).
extern "C" int r4w_dechirp_power(const float2* x, const float2* down,
                                 const float2* twiddle, float* out, int rows,
                                 int k, cudaStream_t stream) {
  if (k < 32 || k > 4096 || (k & (k - 1)) != 0 || rows < 0) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  const int threads = k < 256 ? k : 256;
  switch (k / threads) {
    case 1:
      return launch<1>(x, down, twiddle, out, rows, k, threads, stream);
    case 2:
      return launch<2>(x, down, twiddle, out, rows, k, threads, stream);
    case 4:
      return launch<4>(x, down, twiddle, out, rows, k, threads, stream);
    case 8:
      return launch<8>(x, down, twiddle, out, rows, k, threads, stream);
    default:
      return launch<16>(x, down, twiddle, out, rows, k, threads, stream);
  }
}
