// Live-adaptive row fetch: out[b, k, :] = table[state[b, k], :] for
// k < live[b] only.
//
// Replaces five TPU kernels, all one flat row gather with an optional
// dynamic count:
//   * asr_decoder_tpu/ops/fetch.py:_dma_fetch (body kern) — DMAs each live
//     beam token's packed state record (emitting arcs + epsilon-closure
//     entries) out of HBM, twice a search frame: once in the emit stage and
//     once in the closure stage (32-128 lanes, B = batch, K = beam);
//   * tools/perf/bench_row_gather.py:make_dma_gather and
//     tools/perf/bench_dma_variants.py:make_dma — the row-gather
//     microbenches, one DMA per row (128-512 lanes, B = 1, K = NIDX,
//     live = [NIDX]);
//   * tools/perf/bench_dma_variants.py:make_dma_dyn — the same gather for
//     rows i < nlive only, nlive a scalar-prefetch operand (B = 1,
//     live = [nlive] on the device, so no host sync).
//
// What bounds it on Hopper: random row reads, one 128-2048 byte row per
//   live token.  At the search's 200k-state graph (32 lanes x 4 B = 25.6
//   MB) the whole table fits in the 50 MB L2, so after the first frames
//   the fetch is L2-latency bound.  At the 2M-2.5M state tables of the
//   production graph and the microbenches (0.25-4.1 GB) every row is an
//   HBM access, and the kernel is bound by HBM latency x rows in flight.
//
// Design: the TPU page layout is dropped.  Its [S_pages, 128] pages and the
//   lane-group select exist only because TPU HBM rows are 128-lane tiles;
//   here the narrow [S, lanes] table is read directly.  One warp per token:
//   the 32 threads read the row as 32 x N coalesced words (int, int2 or
//   int4 each; N = 1, or 2 and 4 int4 words a thread at 256 and 512 lanes,
//   all loads issued before the first store) and write them to the
//   token's output row.  Each block loads its own live[b] and tokens
//   k >= live[b] return before reading anything, so dead beam slots cost
//   no memory traffic — the analogue of the TPU kernels' dynamic DMA trip
//   count.  Output rows from live[b] on are left unwritten (the wrapper
//   allocates with torch.empty), matching the TPU contract that they are
//   unspecified.  The TPU's DMA pipeline knobs (nsem semaphores in flight,
//   block_rows, loop unroll) have no counterpart: the warps resident on
//   each SM keep the row reads in flight.  Out-of-range states are clamped
//   into the table (negative ones read row 0, the TPU path's max(state, 0)).
//
// Plain counterpart: table[state.clamp(0, S - 1)]
//   (asr_decoder_tpu_torch/ops/fetch.py:fetch_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // tokens per block

// Vec: int (32 lanes), int2 (64 lanes) or int4 (128, 256, 512 lanes); a
// row is 32 * N Vec words, N per thread of the warp.
template <typename Vec, int N>
__global__ void fetch_kernel(const Vec* __restrict__ table,
                             const int32_t* __restrict__ state,
                             const int32_t* __restrict__ live,
                             Vec* __restrict__ out, int S, int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int n = min(__ldg(live + b), K);
  if (k >= n) return;
  const int64_t tok = static_cast<int64_t>(b) * K + k;
  int s = __ldg(state + tok);
  s = min(max(s, 0), S - 1);
  const Vec* src = table + static_cast<int64_t>(s) * (32 * N) + lane;
  Vec* dst = out + tok * (32 * N) + lane;
  Vec v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __ldg(src + 32 * j);
#pragma unroll
  for (int j = 0; j < N; ++j) dst[32 * j] = v[j];
}

template <typename Vec, int N>
int launch(const void* table, const void* state, const void* live, void* out,
           int S, int B, int K, cudaStream_t stream) {
  dim3 grid((K + kWarps - 1) / kWarps, B);
  fetch_kernel<Vec, N><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const Vec*>(table), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(live), static_cast<Vec*>(out), S, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table i32[S, L] with L in {32, 64, 128, 256, 512}, state i32[B, K],
// live i32[B], out i32[B, K, L]; all contiguous on the current device,
// table and out 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported L.
extern "C" int fetch_records_i32(const void* table, const void* state,
                                 const void* live, void* out, int S, int L,
                                 int B, int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 32: return launch<int, 1>(table, state, live, out, S, B, K, st);
    case 64: return launch<int2, 1>(table, state, live, out, S, B, K, st);
    case 128: return launch<int4, 1>(table, state, live, out, S, B, K, st);
    case 256: return launch<int4, 2>(table, state, live, out, S, B, K, st);
    case 512: return launch<int4, 4>(table, state, live, out, S, B, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
