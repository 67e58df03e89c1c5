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
// Both functions are bound by device-memory bytes once latency is hidden:
// the forward pass moves 4*C bytes of branch metrics in and 4*S/W bytes of
// decisions out per (step, lane) for 3*S FP32 adds and compares (bound
// 0.0807 ms at the decode bench's bm (2054, 4, 4096) at 3.35 TB/s); the
// traceback reads one decision word and writes one bit per (step, lane).
// The path metrics stay off device memory for the whole frame, as the TPU
// kernel kept them in VMEM. The forward design:
//
// - A group of G = min(S/2, 32) threads per lane, one butterfly m each (two
//   at K = 8): a warp per lane at K = 7, several lanes a warp below, with
//   shuffles of width G. Thread g holds the metrics of states g + u*G, the
//   targets of its own butterflies. The sources 2m and 2m+1 of a butterfly
//   sit in one slot of threads 2g and 2g+1 (mod G), so a step is two
//   shuffles per slot pair, two add-compare-selects per butterfly and one
//   __ballot_sync per target slot; the ballots are staged as they are and
//   cut into decision words once per chunk. One lane's step is a short
//   serial chain; the card hides it behind the other lanes' warps (~31
//   warps an SM at 4096 lanes, against one warp an SM with a thread per
//   lane). What then holds the kernel is instruction issue, so a step does
//   only what must happen every step: cutting words waits for the chunk.
// - A block is one warp or 256 threads (at most 32 lanes), chosen by the
//   host (kernels/viterbi.py: forward_plan) and compiled in (LANES), so
//   every staged address of a step is a constant offset. The block walks
//   the frame in chunks of steps: branch metrics of the next chunk come in
//   with cp.async into the other half of a double buffer while this
//   chunk's steps run, and a chunk's decisions leave as rows of the
//   block's lanes. The ragged last chunk and the ragged last block of
//   lanes are masked.
// - The (S, 2) code table travels as a kernel argument; each thread turns
//   its four (eight at K = 8) codewords into shared-memory offsets once.
// - FP32 adds and compares only, no fused multiply-add and no TF32, so the
//   result is bit-exact against the plain PyTorch version.
//
// The traceback is one thread per lane and one warp of 32 lanes a block.
// What bounds it is each lane's serial chain of steps: at the decode
// bench's 4096 lanes there is one warp an SM, so no other warp hides a
// step's latency, and the design keeps global memory off the chain. In the
// (T, G, L) layout a (step, word) row of the block's lanes is 128
// contiguous bytes. Walking from the top of the frame down, the block
// brings chunks of steps (16 KB: 128/G steps of G words) into a ring of
// three stages in shared memory with cp.async (16 bytes a thread where the
// lanes allow it), two chunks in flight while the chain walks the third.
// The chunks are cut at multiples of the chunk from step 0, so the top one
// is the ragged one. A step reads its one word by address,
// stage[(t * G + state / W) * 32 + lane]: the bank is the lane, and there is
// no select chain and no register array indexed by the state. A step
// shifts the state left by one and brings the new bit in below the word
// index (W = 16 whenever G > 1), so the state at the top of four steps
// already names all four words: the group reads them together, and the
// serial chain is a few integer ops a step. Each step's bit goes straight
// to bits[t, lane], one coalesced 128-byte store a warp.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 32;      // lanes per block of the traceback
constexpr int kTracebackStages = 3;  // chunks of decisions in the traceback's ring
constexpr int kTracebackGroup = 4;   // steps whose words one state names
constexpr int kMaxStates = 128;   // K <= 8
constexpr int kStaticSharedBytes = 48 * 1024;  // a block's shared memory without opting in
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kUnreached = -1e9f;

// Codeword index emitted from state st on input bit b.
struct CodeTable {
  int code[kMaxStates][2];
};

template <int S>
struct Packing {
  static constexpr int kWidth = S < 16 ? S : 16;  // decisions per word
  static constexpr int kWords = S / kWidth;       // words per step, G
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the branch metrics of steps [t0, t0 + n_steps) of the block's lanes
// as dst[(t * C + c) * LANES + l]; lanes past the end read as 0.
template <int C, int LANES>
__device__ __forceinline__ void stage_branch_metrics(float* dst, const float* __restrict__ bm,
                                                     int t0, int n_steps, int lane0, int lanes) {
  const int n = n_steps * C * LANES;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i % LANES;
    const int row = i / LANES;  // t * C + c
    if (lane0 + l < lanes) {
      cp_async4(dst + i, bm + (static_cast<size_t>(t0) * C + row) * lanes + lane0 + l);
    } else {
      dst[i] = 0.0f;
    }
  }
}

template <int S, int C, int LANES>
__global__ void viterbi_forward_kernel(const float* __restrict__ bm, const CodeTable table,
                                       int* __restrict__ dec, float* __restrict__ final_metrics,
                                       int steps, int lanes, int chunk) {
  constexpr int kGroup = S / 2 < 32 ? S / 2 : 32;  // threads a lane
  constexpr int kSlots = S / kGroup;               // metrics a thread: 2, or 4 at K = 8
  constexpr int kPairs = kSlots / 2;               // butterflies a thread
  constexpr int kWords = Packing<S>::kWords;
  extern __shared__ __align__(16) float smem[];
  constexpr int warps = LANES * kGroup / 32;
  constexpr int step_floats = C * LANES;
  const int stage_floats = chunk * step_floats;
  float* bm_stage = smem;  // two halves of stage_floats
  // the step's ballots of each warp: ballot_stage[(t * warps + warp) * kSlots + u]
  unsigned* ballot_stage = reinterpret_cast<unsigned*>(smem + 2 * stage_floats);

  const int g = threadIdx.x % kGroup;
  const int slot = threadIdx.x / kGroup;  // this lane's place in the block
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + slot;

  // Thread g holds the metrics of states g + u*kGroup, u < kSlots: for its
  // butterflies m = g + q*kGroup the targets m (slot q) and m + S/2 (slot
  // q + kPairs). Butterfly m's sources 2m and 2m+1 sit in one slot pair
  // (2q, 2q+1) of threads 2g and 2g+1 (mod kGroup): the low slot 2q if
  // 2g < kGroup, else the high slot 2q+1. Each thread sends its low and
  // its high metric to two different threads, so two shuffles per pair
  // carry them all: in the first an even thread shows its low metric and an
  // odd thread its high one, in the second the other way round.
  const bool high = 2 * g >= kGroup;
  const bool odd_thread = g & 1;
  const int src_first = (high ? 2 * g + 1 : 2 * g) % kGroup;
  const int src_second = (high ? 2 * g : 2 * g + 1) % kGroup;

  // offset[q][b][0/1]: where, in a staged step, butterfly g + q*kGroup finds
  // the branch metric of its even / odd predecessor on input bit b
  int offset[kPairs][2][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int m = g + q * kGroup;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      offset[q][b][0] = table.code[2 * m][b] * LANES + slot;
      offset[q][b][1] = table.code[2 * m + 1][b] * LANES + slot;
    }
  }
  float metric[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) metric[u] = g + u * kGroup == 0 ? 0.0f : kUnreached;

  const int n_chunks = (steps + chunk - 1) / chunk;
  if (n_chunks > 0) {
    stage_branch_metrics<C, LANES>(bm_stage, bm, 0, min(chunk, steps), lane0, lanes);
  }
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * chunk;
    const int n_steps = min(chunk, steps - t0);
    if (ch + 1 < n_chunks) {
      stage_branch_metrics<C, LANES>(bm_stage + ((ch + 1) & 1) * stage_floats, bm, t0 + chunk,
                                     min(chunk, steps - t0 - chunk), lane0, lanes);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's group has landed; the next one may be in flight
    __syncthreads();
    // the branch metrics of butterfly q's even / odd predecessor on bit b,
    // advanced one staged step at a time
    const float* bm_at[kPairs][2][2];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bm_at[q][b][e] = bm_stage + (ch & 1) * stage_floats + offset[q][b][e];
        }
      }
    }
    unsigned* ballot_at = ballot_stage + threadIdx.x / 32 * kSlots;

    for (int t = 0; t < n_steps; ++t) {
      float first[kPairs], second[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float low = metric[2 * q], upper = metric[2 * q + 1];
        first[q] = __shfl_sync(kFullMask, odd_thread ? upper : low, src_first, kGroup);
        second[q] = __shfl_sync(kFullMask, odd_thread ? low : upper, src_second, kGroup);
      }
      unsigned ballot[kSlots];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float from_even = high ? second[q] : first[q];  // M[2m]
        const float from_odd = high ? first[q] : second[q];   // M[2m+1]
        const float bm_e0 = *bm_at[q][0][0];
        const float bm_o0 = *bm_at[q][0][1];
        const float bm_e1 = *bm_at[q][1][0];
        const float bm_o1 = *bm_at[q][1][1];
        // target b*S/2 + m = g + (q + b*kPairs)*kGroup
        const float a0 = from_even + bm_e0, o0 = from_odd + bm_o0;
        const float a1 = from_even + bm_e1, o1 = from_odd + bm_o1;
        metric[q] = o0 > a0 ? o0 : a0;
        metric[q + kPairs] = o1 > a1 ? o1 : a1;
        ballot[q] = __ballot_sync(kFullMask, o0 > a0);
        ballot[q + kPairs] = __ballot_sync(kFullMask, o1 > a1);
      }
      // The ballots are the step's decisions as they stand; the first thread
      // of each warp stages them, and the words are cut from them once per
      // chunk, below.
      if (threadIdx.x % 32 == 0) {
        if constexpr (kSlots == 4) {
          *reinterpret_cast<uint4*>(ballot_at) = make_uint4(ballot[0], ballot[1], ballot[2],
                                                            ballot[3]);
        } else {
          *reinterpret_cast<uint2*>(ballot_at) = make_uint2(ballot[0], ballot[1]);
        }
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          bm_at[q][b][0] += step_floats;
          bm_at[q][b][1] += step_floats;
        }
      }
      ballot_at += warps * kSlots;
    }
    __syncthreads();  // the chunk's decisions are staged; its branch metrics are spent

    // Word w of lane l: states w*W .. w*W + W-1. With a warp per lane, ballot
    // u of warp l holds states 32u .. 32u+31; with several lanes a warp, lane
    // l's bits of ballots 0 and 1 (states 0 .. S/2-1 and S/2 .. S-1) start at
    // bit (l*kGroup) % 32 of its warp's ballots.
    const int n = n_steps * kWords * LANES;
    int* out = dec + static_cast<size_t>(t0) * kWords * lanes + lane0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {  // i = ((t * kWords) + w) * LANES + l
      const int l = i % LANES;
      const int row = i / LANES;
      const int t = row / kWords, w = row % kWords;
      if (lane0 + l < lanes) {
        const unsigned* b = ballot_stage + (t * warps + l * kGroup / 32) * kSlots;
        unsigned word;
        if constexpr (kGroup == 32) {
          word = (b[w / 2] >> (16 * (w % 2))) & 0xffffu;
        } else {
          constexpr unsigned kMask = (1u << kGroup) - 1u;
          const int segment = l * kGroup % 32;
          const unsigned bits =
              ((b[0] >> segment) & kMask) | (((b[1] >> segment) & kMask) << kGroup);
          word = kWords == 1 ? bits : (bits >> (16 * w)) & 0xffffu;
        }
        out[static_cast<size_t>(row) * lanes + l] = static_cast<int>(word);
      }
    }
  }

  if (lane < lanes) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      final_metrics[static_cast<size_t>(g + u * kGroup) * lanes + lane] = metric[u];
    }
  }
}

// Stage rows [row0, row0 + n_rows) of the (steps * G, lanes) decisions, the
// block's lanes [lane0, lane0 + lb), as dst[row * 32 + l]. `vec`: lanes is a
// multiple of 4 and dec is 16-byte aligned, so a full block's row is eight
// 16-byte pieces.
__device__ __forceinline__ void stage_decisions(int* dst, const int* __restrict__ dec,
                                                int row0, int n_rows, int lanes, int lane0,
                                                int lb, bool vec) {
  const int* src = dec + static_cast<size_t>(row0) * lanes + lane0;
  if (lb == kThreads && vec) {
    const int piece = 4 * (threadIdx.x % 8);
    for (int row = threadIdx.x / 8; row < n_rows; row += kThreads / 8) {
      cp_async16(dst + row * kThreads + piece, src + static_cast<size_t>(row) * lanes + piece);
    }
  } else {
    // 4 bytes a copy: thread i takes pairs i, i + 32, ... of the row-major
    // (n_rows, lb) pairs, stepped with adds and a carry, no division a copy
    const int step_rows = kThreads / lb, step_lanes = kThreads % lb;
    int row = threadIdx.x / lb, l = threadIdx.x % lb;
    while (row < n_rows) {
      cp_async4(dst + row * kThreads + l, src + static_cast<size_t>(row) * lanes + l);
      row += step_rows;
      l += step_lanes;
      if (l >= lb) {
        l -= lb;
        ++row;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbi_traceback_kernel(const int* __restrict__ dec,
                         const int* __restrict__ start_state,
                         int* __restrict__ bits, int steps, int lanes, int chunk, bool vec) {
  constexpr int kHalf = S / 2;
  constexpr int kWidth = Packing<S>::kWidth;
  constexpr int kWords = Packing<S>::kWords;
  // a group's words follow from the state at its top only while the bits
  // brought in stay below the word index
  static_assert(kWords == 1 || (1 << (kTracebackGroup - 1)) <= kWidth, "group too long");
  extern __shared__ __align__(16) int tb_stage[];  // kTracebackStages chunks

  const int stage_ints = chunk * kWords * kThreads;
  const int lane0 = blockIdx.x * kThreads;
  const int lb = min(kThreads, lanes - lane0);
  const bool active = static_cast<int>(threadIdx.x) < lb;
  const size_t n_lanes = static_cast<size_t>(lanes);
  unsigned state = 0;
  if (active && start_state != nullptr) state = start_state[lane0 + threadIdx.x] & (S - 1);

  // walk k covers chunk n_chunks - 1 - k, steps [c * chunk, min((c + 1) * chunk, steps))
  const int n_chunks = (steps + chunk - 1) / chunk;
  auto stage_walk = [&](int k) {
    const int c = n_chunks - 1 - k;
    stage_decisions(tb_stage + (k % kTracebackStages) * stage_ints, dec, c * chunk * kWords,
                    min(chunk, steps - c * chunk) * kWords, lanes, lane0, lb, vec);
  };
#pragma unroll
  for (int k = 0; k < kTracebackStages - 1; ++k) {
    if (k < n_chunks) stage_walk(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    __syncwarp();  // the stage refilled next, walk k - 1's, is spent
    if (k + kTracebackStages - 1 < n_chunks) stage_walk(k + kTracebackStages - 1);
    cp_async_commit();
    cp_async_wait<kTracebackStages - 1>();  // walk k's chunk has landed
    __syncwarp();                           // in every thread's copies

    const int t0 = (n_chunks - 1 - k) * chunk;
    const int n = min(chunk, steps - t0);
    const int* words = tb_stage + (k % kTracebackStages) * stage_ints + threadIdx.x;
    int* out = bits + static_cast<size_t>(t0 + n - 1) * n_lanes + lane0 + threadIdx.x;
    auto step = [&](unsigned word) {
      if (active) *out = static_cast<int>(state / kHalf);
      out -= n_lanes;
      state = ((state << 1) & (S - 2)) | ((word >> (state % kWidth)) & 1u);
    };
    // whole groups with no guard on any step, then the chunk's last few steps
    int top = n - 1;
    for (; top >= kTracebackGroup - 1; top -= kTracebackGroup) {
      unsigned word[kTracebackGroup];
#pragma unroll
      for (int p = 0; p < kTracebackGroup; ++p) {
        const unsigned row = ((state << p) & (S - 1)) / kWidth;  // the word of step top - p
        word[p] = words[((top - p) * kWords + row) * kThreads];
      }
#pragma unroll
      for (int p = 0; p < kTracebackGroup; ++p) step(word[p]);
    }
    for (; top >= 0; --top) step(words[(top * kWords + state / kWidth) * kThreads]);
  }
}

template <int S, int C, int LANES>
cudaError_t launch_forward_lanes(const float* bm, const CodeTable& table, int* dec,
                                 float* final_metrics, int steps, int lanes, int chunk,
                                 cudaStream_t stream) {
  constexpr int kGroup = S / 2 < 32 ? S / 2 : 32;
  constexpr int kBlockThreads = kGroup * LANES;
  static_assert(kBlockThreads % 32 == 0 && kBlockThreads <= 1024, "whole warps");
  // two chunks of branch metrics, and a chunk of each warp's S/kGroup ballots
  const long long smem = 4LL * chunk * (2LL * C * LANES + kBlockThreads / 32 * (S / kGroup));
  if (smem > kStaticSharedBytes) return cudaErrorInvalidConfiguration;
  const int blocks = (lanes + LANES - 1) / LANES;
  viterbi_forward_kernel<S, C, LANES><<<blocks, kBlockThreads, static_cast<size_t>(smem),
                                        stream>>>(bm, table, dec, final_metrics, steps, lanes,
                                                  chunk);
  return cudaGetLastError();
}

// The two block shapes of a code: one warp, or 256 threads (at most 32 lanes).
template <int S, int C>
cudaError_t launch_forward_kernel(const float* bm, const CodeTable& table, int* dec,
                                  float* final_metrics, int steps, int lanes,
                                  int lanes_per_block, int chunk, cudaStream_t stream) {
  constexpr int kGroup = S / 2 < 32 ? S / 2 : 32;
  constexpr int kOneWarp = 32 / kGroup;
  constexpr int kFull = 256 / kGroup < 32 ? 256 / kGroup : 32;
  if (lanes_per_block == kFull) {
    return launch_forward_lanes<S, C, kFull>(bm, table, dec, final_metrics, steps, lanes, chunk,
                                             stream);
  }
  if (lanes_per_block == kOneWarp) {
    return launch_forward_lanes<S, C, kOneWarp>(bm, table, dec, final_metrics, steps, lanes,
                                                chunk, stream);
  }
  return cudaErrorInvalidConfiguration;
}

template <int S>
cudaError_t launch_forward(const float* bm, const CodeTable& table, int* dec,
                           float* final_metrics, int steps, int lanes, int n_codes,
                           int lanes_per_block, int chunk, cudaStream_t stream) {
  if (n_codes == 4) {
    return launch_forward_kernel<S, 4>(bm, table, dec, final_metrics, steps, lanes,
                                       lanes_per_block, chunk, stream);
  }
  return launch_forward_kernel<S, 8>(bm, table, dec, final_metrics, steps, lanes,
                                     lanes_per_block, chunk, stream);
}

template <int S>
cudaError_t launch_traceback(const int* dec, const int* start_state, int* bits, int steps,
                             int lanes, int chunk, int blocks, cudaStream_t stream) {
  const long long smem = 4LL * kTracebackStages * chunk * Packing<S>::kWords * kThreads;
  if (smem > kStaticSharedBytes || static_cast<long long>(blocks) * kThreads < lanes) {
    return cudaErrorInvalidConfiguration;
  }
  const bool vec = lanes % 4 == 0 && (reinterpret_cast<uintptr_t>(dec) & 15) == 0;
  viterbi_traceback_kernel<S><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      dec, start_state, bits, steps, lanes, chunk, vec);
  return cudaGetLastError();
}

}  // namespace

// bm: (steps, n_codes, lanes) float32 and dec: (steps, G, lanes) int32,
// final_metrics: (S, lanes) float32, all contiguous on the current device;
// code_idx: (S, 2) int32 in HOST memory, copied into the kernel's
// arguments. 3 <= constraint <= 8, n_codes 4 or 8; min(S/2, 32) *
// lanes_per_block threads a block, one warp or 256 threads (at most 32 lanes); chunk
// >= 1 steps staged at a time, within 48 KB of shared memory. Launches on `stream` without synchronising
// and returns the launch's cudaError_t (0 on success).
extern "C" int r4w_viterbi_forward(const float* bm, const int* code_idx, int* dec,
                                   float* final_metrics, int steps, int lanes,
                                   int constraint, int n_codes, int lanes_per_block,
                                   int chunk, cudaStream_t stream) {
  if (constraint < 3 || constraint > 8 || (n_codes != 4 && n_codes != 8) || steps < 0 ||
      lanes < 0 || lanes_per_block < 1 || chunk < 1) {
    return cudaErrorInvalidValue;
  }
  if (lanes == 0) return cudaSuccess;
  const int states = 1 << (constraint - 1);
  CodeTable table = {};
  for (int st = 0; st < states; ++st) {
    for (int b = 0; b < 2; ++b) {
      const int code = code_idx[2 * st + b];
      if (code < 0 || code >= n_codes) return cudaErrorInvalidValue;
      table.code[st][b] = code;
    }
  }
  switch (states) {
    case 4:
      return launch_forward<4>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                               lanes_per_block, chunk, stream);
    case 8:
      return launch_forward<8>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                               lanes_per_block, chunk, stream);
    case 16:
      return launch_forward<16>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                                lanes_per_block, chunk, stream);
    case 32:
      return launch_forward<32>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                                lanes_per_block, chunk, stream);
    case 64:
      return launch_forward<64>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                                lanes_per_block, chunk, stream);
    default:
      return launch_forward<128>(bm, table, dec, final_metrics, steps, lanes, n_codes,
                                 lanes_per_block, chunk, stream);
  }
}

// dec: (steps, G, lanes) int32 and bits: (steps, lanes) int32, contiguous
// on the current device; start_state: (lanes,) int32 states in [0, S) on
// the device, or NULL for state 0 in every lane. The plan comes from
// kernels/viterbi.py:traceback_plan: chunk >= 1 steps staged at a time,
// three chunks within 48 KB of shared memory; blocks of 32 lanes covering
// the lanes. Launches on `stream` without synchronising and returns the
// launch's cudaError_t.
extern "C" int r4w_viterbi_traceback(const int* dec, const int* start_state, int* bits,
                                     int steps, int lanes, int constraint, int chunk,
                                     int blocks, cudaStream_t stream) {
  if (constraint < 3 || constraint > 8 || steps < 0 || lanes < 0 || chunk < 1 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  if (lanes == 0 || steps == 0) return cudaSuccess;
  switch (1 << (constraint - 1)) {
    case 4:
      return launch_traceback<4>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                 stream);
    case 8:
      return launch_traceback<8>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                 stream);
    case 16:
      return launch_traceback<16>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                  stream);
    case 32:
      return launch_traceback<32>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                  stream);
    case 64:
      return launch_traceback<64>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                  stream);
    default:
      return launch_traceback<128>(dec, start_state, bits, steps, lanes, chunk, blocks,
                                   stream);
  }
}
