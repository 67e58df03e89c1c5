// Viterbi forward add-compare-select and survivor traceback for Hopper (sm_90a).
//
// Replaces r4w_tpu/kernels/pallas_kernels.py:viterbi_forward (kernel body
// _viterbi_acs_kernel) and viterbi_traceback (_viterbi_tb_kernel) for a
// rate-1/R code of constraint length K: S = 2^(K-1) states, C = 2^R
// codewords, 3 <= K <= 8, R in {2, 3}.
//
// Forward, per lane l and step t, with metrics M starting at 0 for state 0
// and -1e9 elsewhere (never renormalised):
//
//     for target s' = b*S/2 + m (input bit b, butterfly m):
//         a = M[2m]   + bm[t, code(2m,   b), l]
//         o = M[2m+1] + bm[t, code(2m+1, b), l]
//         M'[s'] = o > a ? o : a          (ties keep the even predecessor)
//         bit s' % W of dec[t, s' / W, l] = (o > a)
//
// with W = 16 (or S when S < 16). Traceback walks back from a start state:
// bits[t, l] = st >> (K-2); st = 2*(st & (S/2-1)) + decision bit of st.
//
// Both functions are bound by device-memory bytes: the forward pass moves
// 4*C bytes of branch metrics in and 4*S/W bytes of decisions out per
// (step, lane) for 3*S FP32 adds and compares; the traceback reads one
// decision word and writes one bit per (step, lane). The design keeps the
// path metrics off device memory for the whole frame, as the TPU kernel
// kept them in VMEM:
//
// - One thread per lane, lanes on threadIdx.x, so each step's branch-
//   metric loads and decision stores are coalesced in the (T, C, L) and
//   (T, G, L) layouts. The thread loops over all T steps itself.
// - The S path metrics live in registers: the kernel is a template on S
//   and the butterfly loop is unrolled, so every metric index is a
//   constant. The TPU kernel's 0/1 selection matmuls existed only because
//   Mosaic has no gather; here the butterfly is plain indexing.
// - The trellis is runtime data (any generator polynomials), so the
//   codeword of each (state, bit) is not a constant. The (S, 2) code table
//   travels as a kernel argument, which sits in constant memory and is
//   read as an operand, holding the byte offset of each codeword in the
//   thread's column of a small shared-memory stage of the step's C branch
//   metrics. Each thread reads only its own column, so no barrier is
//   needed.
// - The next step's branch metrics are loaded before the current step's
//   ACS, so their latency hides behind it.
// - Decision words are built with shifts and ORs in registers.
// - FP32 adds and compares only, no fused multiply-add and no TF32, so the
//   result is bit-exact against the plain PyTorch version.
//
// The traceback is one thread per lane as well. The state chain is serial,
// but the decision words of a step do not depend on it: each thread loads
// all G words of P steps at once, so the loads overlap, then walks the P
// steps in registers, choosing its word with a select chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;      // lanes per block
constexpr int kMaxStates = 128;   // K <= 8
constexpr float kUnreached = -1e9f;

// Byte offset, within a thread's column of the staged branch metrics, of
// the codeword emitted from state st on input bit b.
struct CodeTable {
  int offset[kMaxStates][2];
};

template <int S>
struct Packing {
  static constexpr int kWidth = S < 16 ? S : 16;  // decisions per word
  static constexpr int kWords = S / kWidth;       // words per step, G
};

template <int S, int C>
__global__ void __launch_bounds__(kThreads)
viterbi_forward_kernel(const float* __restrict__ bm, const CodeTable table,
                       int* __restrict__ dec, float* __restrict__ final_metrics,
                       int steps, int lanes) {
  constexpr int kHalf = S / 2;
  constexpr int kWidth = Packing<S>::kWidth;
  constexpr int kWords = Packing<S>::kWords;
  __shared__ float staged[C * kThreads];  // staged[c * kThreads + threadIdx.x]

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n_lanes = static_cast<size_t>(lanes);
  const char* column = reinterpret_cast<const char*>(staged + threadIdx.x);

  float metric[S];
#pragma unroll
  for (int s = 0; s < S; ++s) metric[s] = s == 0 ? 0.0f : kUnreached;

  float next[C];
#pragma unroll
  for (int c = 0; c < C; ++c) next[c] = steps > 0 ? bm[c * n_lanes + lane] : 0.0f;

  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int c = 0; c < C; ++c) staged[c * kThreads + threadIdx.x] = next[c];
    if (t + 1 < steps) {
      const float* row = bm + static_cast<size_t>(t + 1) * C * n_lanes + lane;
#pragma unroll
      for (int c = 0; c < C; ++c) next[c] = row[c * n_lanes];
    }

    float updated[S];
    unsigned word[kWords];
#pragma unroll
    for (int g = 0; g < kWords; ++g) word[g] = 0u;
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float a = metric[2 * m] +
            *reinterpret_cast<const float*>(column + table.offset[2 * m][b]);
        const float o = metric[2 * m + 1] +
            *reinterpret_cast<const float*>(column + table.offset[2 * m + 1][b]);
        const int target = b * kHalf + m;
        const bool odd = o > a;
        updated[target] = odd ? o : a;
        word[target / kWidth] |= static_cast<unsigned>(odd) << (target % kWidth);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) metric[s] = updated[s];

    int* out = dec + static_cast<size_t>(t) * kWords * n_lanes + lane;
#pragma unroll
    for (int g = 0; g < kWords; ++g) out[g * n_lanes] = static_cast<int>(word[g]);
  }

#pragma unroll
  for (int s = 0; s < S; ++s) final_metrics[s * n_lanes + lane] = metric[s];
}

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbi_traceback_kernel(const int* __restrict__ dec,
                         const int* __restrict__ start_state,
                         int* __restrict__ bits, int steps, int lanes) {
  constexpr int kHalf = S / 2;
  constexpr int kWidth = Packing<S>::kWidth;
  constexpr int kWords = Packing<S>::kWords;
  constexpr int kBatch = 32 / kWords;  // steps whose words are loaded at once

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n_lanes = static_cast<size_t>(lanes);
  int state = start_state != nullptr ? start_state[lane] : 0;

  for (int top = steps - 1; top >= 0; top -= kBatch) {
    int words[kBatch][kWords];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int t = top - p;
#pragma unroll
      for (int g = 0; g < kWords; ++g) {
        words[p][g] = t >= 0 ? dec[(static_cast<size_t>(t) * kWords + g) * n_lanes + lane]
                             : 0;
      }
    }
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int t = top - p;
      if (t >= 0) {
        bits[static_cast<size_t>(t) * n_lanes + lane] = state / kHalf;
        int word = words[p][0];
#pragma unroll
        for (int g = 1; g < kWords; ++g) word = state / kWidth == g ? words[p][g] : word;
        state = 2 * (state % kHalf) + ((word >> (state % kWidth)) & 1);
      }
    }
  }
}

template <int S>
cudaError_t launch_forward(const float* bm, const CodeTable& table, int* dec,
                           float* final_metrics, int steps, int lanes, int n_codes,
                           cudaStream_t stream) {
  const int blocks = (lanes + kThreads - 1) / kThreads;
  if (n_codes == 4) {
    viterbi_forward_kernel<S, 4><<<blocks, kThreads, 0, stream>>>(
        bm, table, dec, final_metrics, steps, lanes);
  } else {
    viterbi_forward_kernel<S, 8><<<blocks, kThreads, 0, stream>>>(
        bm, table, dec, final_metrics, steps, lanes);
  }
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_traceback(const int* dec, const int* start_state, int* bits,
                             int steps, int lanes, cudaStream_t stream) {
  const int blocks = (lanes + kThreads - 1) / kThreads;
  viterbi_traceback_kernel<S><<<blocks, kThreads, 0, stream>>>(dec, start_state, bits,
                                                               steps, lanes);
  return cudaGetLastError();
}

}  // namespace

// bm: (steps, n_codes, lanes) float32 and dec: (steps, G, lanes) int32,
// final_metrics: (S, lanes) float32, all contiguous on the current device;
// code_idx: (S, 2) int32 in HOST memory, copied into the kernel's
// arguments. 3 <= constraint <= 8, n_codes 4 or 8. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success).
extern "C" int r4w_viterbi_forward(const float* bm, const int* code_idx, int* dec,
                                   float* final_metrics, int steps, int lanes,
                                   int constraint, int n_codes, cudaStream_t stream) {
  if (constraint < 3 || constraint > 8 || (n_codes != 4 && n_codes != 8) || steps < 0 ||
      lanes < 0) {
    return cudaErrorInvalidValue;
  }
  if (lanes == 0) return cudaSuccess;
  const int states = 1 << (constraint - 1);
  CodeTable table = {};
  for (int st = 0; st < states; ++st) {
    for (int b = 0; b < 2; ++b) {
      const int code = code_idx[2 * st + b];
      if (code < 0 || code >= n_codes) return cudaErrorInvalidValue;
      table.offset[st][b] = code * kThreads * static_cast<int>(sizeof(float));
    }
  }
  switch (states) {
    case 4:
      return launch_forward<4>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
    case 8:
      return launch_forward<8>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
    case 16:
      return launch_forward<16>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
    case 32:
      return launch_forward<32>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
    case 64:
      return launch_forward<64>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
    default:
      return launch_forward<128>(bm, table, dec, final_metrics, steps, lanes, n_codes, stream);
  }
}

// dec: (steps, G, lanes) int32 and bits: (steps, lanes) int32, contiguous
// on the current device; start_state: (lanes,) int32 states in [0, S) on
// the device, or NULL for state 0 in every lane. Launches on `stream`
// without synchronising and returns the launch's cudaError_t.
extern "C" int r4w_viterbi_traceback(const int* dec, const int* start_state, int* bits,
                                     int steps, int lanes, int constraint,
                                     cudaStream_t stream) {
  if (constraint < 3 || constraint > 8 || steps < 0 || lanes < 0) {
    return cudaErrorInvalidValue;
  }
  if (lanes == 0 || steps == 0) return cudaSuccess;
  switch (1 << (constraint - 1)) {
    case 4:
      return launch_traceback<4>(dec, start_state, bits, steps, lanes, stream);
    case 8:
      return launch_traceback<8>(dec, start_state, bits, steps, lanes, stream);
    case 16:
      return launch_traceback<16>(dec, start_state, bits, steps, lanes, stream);
    case 32:
      return launch_traceback<32>(dec, start_state, bits, steps, lanes, stream);
    case 64:
      return launch_traceback<64>(dec, start_state, bits, steps, lanes, stream);
    default:
      return launch_traceback<128>(dec, start_state, bits, steps, lanes, stream);
  }
}
