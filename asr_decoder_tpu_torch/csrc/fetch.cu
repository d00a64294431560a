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
//   live token; the bound is the bytes (each live row read once and written
//   once, plus the states).  At the search's 200k-state graph (32 lanes x
//   4 B = 25.6 MB) the table fits in the 50 MB L2; at the 2M-2.5M state
//   tables of the production graph and the microbenches (0.25-4.1 GB) every
//   row is an HBM access, and the kernel is bound by HBM latency x bytes in
//   flight: feeding 3.35 TB/s at ~700 ns takes ~18 KB in flight an SM
//   (Little's law).
//
// Design: the TPU page layout is dropped.  Its [S_pages, 128] pages and the
//   lane-group select exist only because TPU HBM rows are 128-lane tiles;
//   here the narrow [S, lanes] table is read directly.  Each block loads its
//   own live[b]; tokens k >= live[b] read no table row, so dead beam slots
//   cost no memory traffic — the analogue of the TPU kernels' dynamic DMA
//   trip count.  Output rows from live[b] on are left unwritten (the
//   wrapper allocates with torch.empty), matching the TPU contract that
//   they are unspecified.  Out-of-range states are clamped into the table
//   (negative ones read row 0, the TPU path's max(state, 0)).
//   * Narrow records (32 and 64 lanes, the search's widths): 16-byte
//     vectors, L/4 threads a row, so one warp reads 4 (or 2) rows at a
//     step; each thread owns 4 consecutive tokens, loads their states as
//     one int4 and issues its 4 row reads before the first store — 64
//     bytes in flight a thread where a warp-per-token layout at 32 lanes
//     had 4 (at most 8 KB an SM, under half the bound once the table is
//     past the L2).  A TMA design (one cp.async.bulk a live row into a
//     shared-memory ring under an mbarrier, one bulk store of the block's
//     output run) was built and measured no faster at the search's large
//     shapes and 1.6x slower at its small ones (one TMA issue a 128-byte
//     row, then a serial store).
//   * Wide rows (128, 256, 512 lanes, the row-gather microbenches): one warp
//     a token, the row read as 32 x N coalesced int4 words (N = 1, 2, 4,
//     all loads issued before the first store), which reaches 83-87% of the
//     HBM rate there.
//   The TPU's DMA pipeline knobs (nsem semaphores in flight, block_rows,
//   loop unroll) have no counterpart: the threads resident on each SM keep
//   the row reads in flight.
//
// Plain counterpart: table[state.clamp(0, S - 1)]
//   (asr_decoder_tpu_torch/ops/fetch.py:fetch_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- narrow records: 16-byte vectors, 4 tokens a thread ------------------

constexpr int kNarrowThreads = 128;
constexpr int kTokensPerThread = 4;

// L in {32, 64}: L/4 threads a row (one int4 each), 32/(L/4) rows a warp
// step; a block covers kNarrowThreads / (L/4) * 4 tokens of row b.
template <int L>
__global__ void __launch_bounds__(kNarrowThreads)
fetch_narrow_kernel(const int4* __restrict__ table,
                    const int32_t* __restrict__ state,
                    const int32_t* __restrict__ live, int4* __restrict__ out,
                    int S, int K, bool vec_state) {
  constexpr int kTpr = L / 4;                       // threads a row
  constexpr int kRowsPerBlock = kNarrowThreads / kTpr;
  constexpr int kTokens = kRowsPerBlock * kTokensPerThread;
  const int b = blockIdx.y;
  const int n = min(__ldg(live + b), K);
  const int r = threadIdx.x / kTpr;
  const int c = threadIdx.x % kTpr;
  const int k0 = blockIdx.x * kTokens + r * kTokensPerThread;
  if (k0 >= n) return;
  const int64_t tok = static_cast<int64_t>(b) * K + k0;
  int s[kTokensPerThread];
  if (vec_state && k0 + kTokensPerThread <= n) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(state + tok));
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < kTokensPerThread; ++u)
      s[u] = k0 + u < n ? __ldg(state + tok + u) : 0;
  }
  int4 v[kTokensPerThread];
#pragma unroll
  for (int u = 0; u < kTokensPerThread; ++u) {
    if (k0 + u < n) {
      const int64_t row = min(max(s[u], 0), S - 1);
      v[u] = __ldg(table + row * kTpr + c);
    }
  }
#pragma unroll
  for (int u = 0; u < kTokensPerThread; ++u)
    if (k0 + u < n) out[(tok + u) * kTpr + c] = v[u];
}

template <int L>
int launch_narrow(const void* table, const void* state, const void* live,
                  void* out, int S, int B, int K, cudaStream_t stream) {
  constexpr int kTokens = kNarrowThreads / (L / 4) * kTokensPerThread;
  const bool vec_state =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(state) & 15) == 0;
  dim3 grid((K + kTokens - 1) / kTokens, B);
  fetch_narrow_kernel<L><<<grid, kNarrowThreads, 0, stream>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(live), static_cast<int4*>(out), S, K,
      vec_state);
  return static_cast<int>(cudaGetLastError());
}

// ---- wide rows: one warp a token ---------------------------------------

constexpr int kWarps = 8;  // tokens per block

// Vec: int4; a row is 32 * N Vec words, N per thread of the warp.
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
    case 32: return launch_narrow<32>(table, state, live, out, S, B, K, st);
    case 64: return launch_narrow<64>(table, state, live, out, S, B, K, st);
    case 128: return launch<int4, 1>(table, state, live, out, S, B, K, st);
    case 256: return launch<int4, 2>(table, state, live, out, S, B, K, st);
    case 512: return launch<int4, 4>(table, state, live, out, S, B, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
