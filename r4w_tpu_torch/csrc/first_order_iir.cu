// First-order recursions for Hopper (sm_90a), generic over the step.
//
// Stands for the lax.scan loops of the reference's one-pole filters,
// probes, envelope followers and peak hold (r4w_tpu/ops/filters.py:
// single_pole_iir, dc_blocker; r4w_tpu/ops/filters2.py: de_emphasis,
// noise_gate, _env_follow; r4w_tpu/ops/stream_blocks.py: the probes,
// peak_hold, envelope_detector; r4w_tpu/ops/adaptive.py: comb_feedback),
// which no Pallas kernel computes. For each row of n steps and each of its
// `comps` interleaved float32 components (1 for float32 rows, 2 for
// complex64 rows: a complex row is two real recursions):
//
//     y[j] = step(y[j - 1], u[j]),   y[-1] = state (zero for a null state)
//
// with u laid out as u[(row * n + j) * comps + c] and the step one of five
// kinds (the ids of kernels/recurrence.py's KINDS), with coefficients c0, c1:
//
//     0 linear          y = fma(c0, y, u)
//     1 one_pole        y = fma(c0, u, c1 * y)
//     2 ema             y = fma(c0, u - y, y)
//     3 attack_release  y = fma(u > y ? c0 : c1, u - y, y)
//     4 peak_hold       y = max(u, c0 * y)
//
// Rounding: each step rounds as the reference's compiled scan body, which
// contracts a product and a sum into one fused multiply-add: __fmaf_rn,
// __fmul_rn and __fsub_rn, which nvcc neither contracts further nor
// splits. The plain step loop computes the same roundings; the kernel
// equals it bit for bit.
//
// What bounds it: the serial chain. A step is two or three dependent
// operations, so one row of 14.4 M samples takes tens of ms whatever the
// memory system does; the bytes (8 a sample) would take 0.034 ms. Rows
// and components run in parallel. `first_order_iir_chain_probe` below times
// each kind's bare chain, the floor this kernel is held to.
//
// Design: one warp a row, the step a functor the chain is templated on.
// Lane c < comps walks component c serially with y in a register. The whole
// warp keeps the chain fed: tiles of kTile floats of the row are staged into
// a ring of kStages shared-memory slots by cp.async (4-byte copies, so any
// row offset and alignment works), kStages - 1 tiles ahead of the chain; a
// lane reads its tile's u from shared memory in unrolled runs that do not
// depend on y, so the loads are off the chain. y overwrites u in the slot,
// and the warp stores the tile with coalesced 4-byte stores before the slot
// is staged again.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 1024;   // floats a slot holds: 1024 steps of a real row, 512 of a complex one
constexpr int kStages = 4;    // slots in the ring: kStages - 1 tiles in flight ahead of the chain
constexpr int kUnroll = 16;   // steps a lane unrolls, so that its shared loads run ahead

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The steps. Each takes y[j - 1] and u[j] and returns y[j].
struct Linear {
  float b;
  __device__ __forceinline__ float operator()(float y, float u) const { return __fmaf_rn(b, y, u); }
};
struct OnePole {
  float a, b;
  __device__ __forceinline__ float operator()(float y, float u) const {
    return __fmaf_rn(a, u, __fmul_rn(b, y));
  }
};
struct Ema {
  float a;
  __device__ __forceinline__ float operator()(float y, float u) const {
    return __fmaf_rn(a, __fsub_rn(u, y), y);
  }
};
struct AttackRelease {
  float attack, release;
  __device__ __forceinline__ float operator()(float y, float u) const {
    return __fmaf_rn(u > y ? attack : release, __fsub_rn(u, y), y);
  }
};
struct PeakHold {
  float decay;
  __device__ __forceinline__ float operator()(float y, float u) const {
    return fmaxf(u, __fmul_rn(decay, y));
  }
};

// Floats of the tile that starts at float `first` of a row of `total`.
__device__ __forceinline__ int tile_floats(long long total, long long first) {
  return static_cast<int>(total - first < kTile ? total - first : kTile);
}

// Stage floats [first, first + count) of the row into `slot`, lane by lane.
__device__ __forceinline__ void stage(float* slot, const float* row, long long first, int count) {
  for (int i = threadIdx.x; i < count; i += kWarp) copy_async(slot + i, row + first + i);
}

// The chain over `steps` steps of component c held in `slot` (stride comps).
template <int kComps, class Step>
__device__ __forceinline__ float walk(float* slot, int steps, Step step, float y) {
  float* v = slot + threadIdx.x;
  int j = 0;
  for (; j + kUnroll <= steps; j += kUnroll) {
    float u[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) u[q] = v[(j + q) * kComps];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      y = step(y, u[q]);
      v[(j + q) * kComps] = y;
    }
  }
  for (; j < steps; ++j) {
    y = step(y, v[j * kComps]);
    v[j * kComps] = y;
  }
  return y;
}

template <int kComps, class Step>
__global__ void __launch_bounds__(kWarp)
    first_order_iir_kernel(const float* __restrict__ u, const float* __restrict__ state,
                           float* __restrict__ out, long long n, Step step) {
  __shared__ float ring[kStages][kTile];
  const long long row = blockIdx.x;
  const long long total = n * kComps;  // floats of this row
  const float* src = u + row * total;
  float* dst = out + row * total;
  const long long tiles = (total + kTile - 1) / kTile;
  float y = 0.0f;
  if (state != nullptr && threadIdx.x < kComps) y = state[row * kComps + threadIdx.x];

  // Fill the ring: tiles 0 .. kStages - 2, one commit group each (empty past the end).
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      const long long first = s * static_cast<long long>(kTile);
      stage(ring[s], src, first, tile_floats(total, first));
    }
    commit();
  }
  for (long long t = 0; t < tiles; ++t) {
    // Stage tile t + kStages - 1 into the slot that tile t - 1 left.
    const long long ahead = t + kStages - 1;
    if (ahead < tiles) {
      const long long first = ahead * kTile;
      stage(ring[ahead % kStages], src, first, tile_floats(total, first));
    }
    commit();
    wait_pending<kStages - 1>();  // tile t has landed (this lane's copies)
    __syncwarp();                 // ... and every lane's
    const long long first = t * kTile;
    const int count = tile_floats(total, first);
    float* slot = ring[t % kStages];
    if (threadIdx.x < kComps) y = walk<kComps>(slot, count / kComps, step, y);
    __syncwarp();
    for (int i = threadIdx.x; i < count; i += kWarp) dst[first + i] = slot[i];
    __syncwarp();  // the slot is read out before a later stage() writes it
  }
  wait_pending<0>();
}

// The chain's floor: one thread runs `steps` (a multiple of kUnroll)
// dependent steps of one kind on values held in registers, and reads the
// SM's cycle counter and the global nanosecond timer around them. No path
// launches it; it measures the cycles a step of the bare chain and the SM
// clock while it runs.
template <class Step>
__global__ void __launch_bounds__(1)
    first_order_iir_chain_probe(long long steps, Step step, float u0, float u1, float* y_out,
                                long long* cycles, unsigned long long* ns) {
  const float u[4] = {u0, u1, -u0, -u1};
  float y = 0.0f;
  unsigned long long t0, t1;
  long long c0, c1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0));
  for (long long j = 0; j < steps; j += kUnroll) {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) y = step(y, u[q & 3]);
  }
  // y as an operand: the reads cannot move above the chain
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1) : "f"(y));
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "f"(y));
  *y_out = y;
  *cycles = c1 - c0;
  *ns = t1 - t0;
}

template <int kComps, class Step>
void launch(const float* u, const float* state, float* out, long long rows, long long n,
            Step step, cudaStream_t stream) {
  first_order_iir_kernel<kComps><<<dim3(static_cast<unsigned>(rows)), kWarp, 0, stream>>>(
      u, state, out, n, step);
}

template <class Step>
void launch_rows(const float* u, const float* state, float* out, long long rows, long long n,
                 int comps, Step step, cudaStream_t stream) {
  if (comps == 1) {
    launch<1>(u, state, out, rows, n, step, stream);
  } else {
    launch<2>(u, state, out, rows, n, step, stream);
  }
}

}  // namespace

// The chain probe of step kind `kind` (0-4, as above) with coefficients
// c0, c1: y_out, cycles, ns are one device value each.
extern "C" int r4w_first_order_iir_chain_probe(long long steps, int kind, float c0, float c1,
                                               float u0, float u1, float* y_out,
                                               long long* cycles, unsigned long long* ns,
                                               cudaStream_t stream) {
  if (steps < 0 || steps % kUnroll != 0) return cudaErrorInvalidValue;
  switch (kind) {
    case 0: first_order_iir_chain_probe<<<1, 1, 0, stream>>>(steps, Linear{c0}, u0, u1, y_out,
                                                             cycles, ns); break;
    case 1: first_order_iir_chain_probe<<<1, 1, 0, stream>>>(steps, OnePole{c0, c1}, u0, u1,
                                                             y_out, cycles, ns); break;
    case 2: first_order_iir_chain_probe<<<1, 1, 0, stream>>>(steps, Ema{c0}, u0, u1, y_out,
                                                             cycles, ns); break;
    case 3: first_order_iir_chain_probe<<<1, 1, 0, stream>>>(steps, AttackRelease{c0, c1}, u0,
                                                             u1, y_out, cycles, ns); break;
    case 4: first_order_iir_chain_probe<<<1, 1, 0, stream>>>(steps, PeakHold{c0}, u0, u1, y_out,
                                                             cycles, ns); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// u, out: rows * n * comps float32 (complex64 rows viewed as float pairs);
// state: rows * comps float32, or null for zeros. comps is 1 or 2; kind is
// 0-4 (as above), with coefficients c0, c1.
extern "C" int r4w_first_order_iir(const float* u, const float* state, float* out,
                                   long long rows, long long n, int comps, int kind, float c0,
                                   float c1, cudaStream_t stream) {
  if (rows < 0 || n < 0 || (comps != 1 && comps != 2)) return cudaErrorInvalidValue;
  if (kind < 0 || kind > 4) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  switch (kind) {
    case 0: launch_rows(u, state, out, rows, n, comps, Linear{c0}, stream); break;
    case 1: launch_rows(u, state, out, rows, n, comps, OnePole{c0, c1}, stream); break;
    case 2: launch_rows(u, state, out, rows, n, comps, Ema{c0}, stream); break;
    case 3: launch_rows(u, state, out, rows, n, comps, AttackRelease{c0, c1}, stream); break;
    default: launch_rows(u, state, out, rows, n, comps, PeakHold{c0}, stream); break;
  }
  return cudaGetLastError();
}
