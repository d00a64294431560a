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
// What bounds it on Hopper: bytes — each live row read once and written
//   once, plus the states.  Only the search's 200k-state graph at 32 lanes
//   (25.6 MB) sits in the 50 MB L2.  Everything else is an HBM read a row:
//   the 2.5M-state production tables (320 MB at 32 lanes, 640 MB at 64,
//   1.28 GB at 128) and the microbenches' 2M-row tables (1, 2 and 4 GB at
//   128, 256 and 512 lanes), at 512 B, 1 KB and 2 KB a row.  Reads are
//   random and writes sequential, so the card's ceiling is that of a copy
//   with one side scattered, not the 3.35 TB/s peak.  From HBM a contiguous
//   device-to-device copy of the same bytes reaches 86.8-90.0% of that
//   peak at 64-256 MB a side, 76.4% at 16 MB and 52.5% at 4 MB (H100
//   80GB HBM3 at 700 W, chip_smoke.py phase 3, which prints it beside each
//   microbench row).  A timing loop must cycle several index sets: with
//   one, a live count of 32,768 keeps its 16 MB of rows and 16 MB of
//   output in the L2, and the copy beats the HBM bound.
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
//   * Wide rows (128, 256 and 512 lanes: the search's 128-lane record and
//     the row-gather microbenches): one warp a row, read as 32 x N
//     coalesced int4 words (N = L / 128).  A warp owns 8 consecutive
//     tokens: their states come as two int4 loads, and all 8 N row loads
//     are issued before the first store — 128 to 512 bytes in flight a
//     thread.  A block of 8 warps covers 64 tokens of row b, so a dead
//     stretch costs one live[b] read a 64 tokens: at make_dma_dyn's live
//     32,768 of 131,072, 1,536 of 2,048 blocks read it and exit (the
//     warp-per-token grid this replaces started 12,288 such blocks of
//     16,384).  At 128 lanes the loads stream past the L1
//     (ld.global.nc.L1::no_allocate) and the stores are evict-first
//     (st.global.cs); at 256 and 512 lanes both are plain.
//   Built, measured against this design in alternating turns on an H100
//   80GB HBM3 at 700 W (tools/perf/bench_kernels_ab.py, medians of 6
//   turns a side), and not kept; the sources of the first two were not
//   kept either, and their runs reused one index set, so their
//   dynamic-count rows were read from the L2:
//   * a persistent grid (as many blocks as the SMs hold, from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor, each block walking
//     only the live units grid-stride over (b, k), 4 tokens a warp): with
//     every row live 49.59 / 97.18 / 189.94 us at 128 / 256 / 512 lanes
//     against 48.28 / 94.01 / 184.12 here, 2.7-3.4% slower; 13.76 and
//     3.97 us at make_dma_dyn's live 32,768 and 8,192 against 12.53 and
//     3.79.  A static split ends when the slowest SM ends; many short
//     blocks let the block scheduler balance the SMs, and at 64 tokens a
//     block the dead ones it saves cost little;
//   * at 256 and 512 lanes, a Hopper bulk-copy ring in that persistent
//     grid (a block of one warp, 4 stages in dynamic shared memory; one
//     lane a row issues a cp.async.bulk into the stage under its mbarrier,
//     lane 0 writes the stage's consecutive output rows with one bulk
//     store, then commit_group and wait_group.read before the stage is
//     refilled): 101.72 / 195.72 us with 32 KB stages against 93.98 /
//     184.01 here, 98.33 / 190.20 with 16 KB stages against 93.97 /
//     184.08 (3.3-8.2% slower).  The rows cost no registers, but the
//     32 KB bulk stores were no faster than coalesced 512-byte warp
//     stores, and a ring per block kept fewer independent row reads in
//     flight than eight warps of 8 tokens;
//   * the streaming hints at every width, rows from HBM (16 index sets
//     cycled): 94.93 / 185.95 us at 256 / 512 lanes against 94.21 /
//     184.06 with plain loads and stores;
//   * plain loads and stores at 128 lanes too (on another card of the same
//     kind): every row live, 48.97 us against 49.29 with the hints, and
//     the search's [2.5M,128] at B=256 K=512 and B=32 K=4096 49.14 and
//     48.91 against 49.71 and 49.61 (0.7-1.4% faster); but B=16 K=512
//     5.61 against 5.27, and make_dma_dyn's live 32,768 and 8,192 14.14
//     and 5.69 against 13.63 and 5.32 (4-7% slower).  The hints stay at
//     128 lanes, where the search's live counts are mostly partial.
//   The TPU's DMA pipeline knobs (nsem semaphores in flight, block_rows,
//   loop unroll) have no counterpart: the threads resident on each SM keep
//   the row reads in flight.
//
// Plain counterpart: table[state.clamp(0, S - 1)]
//   (asr_decoder_tpu_torch/ops/fetch.py:fetch_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Every row of state[B, K] starts on a 16-byte boundary, so a thread may
// read 4 consecutive tokens' states as one int4.
bool states_vectorizable(const void* state, int K) {
  return K % 4 == 0 && (reinterpret_cast<uintptr_t>(state) & 15) == 0;
}

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
  const bool vec_state = states_vectorizable(state, K);
  dim3 grid((K + kTokens - 1) / kTokens, B);
  fetch_narrow_kernel<L><<<grid, kNarrowThreads, 0, stream>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(live), static_cast<int4*>(out), S, K,
      vec_state);
  return static_cast<int>(cudaGetLastError());
}


// ---- wide rows: a warp moves 8 consecutive tokens' rows at a time -------

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideTokens = 8;                     // tokens a warp
// Streaming loads (ld.global.nc.L1::no_allocate) and evict-first stores
// at 128 lanes, where they are 4-7% faster at partial and small live
// counts (and 0.7-1.4% slower with every row live); plain loads and
// stores at 256 and 512 lanes, where the microbenches' full-live rows
// read 0.8-1.0% faster without them.
template <int N>
constexpr bool kStreamingHints = N == 1;

__device__ __forceinline__ int4 load_streaming(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// L = 128 N lanes: a warp reads a row as 32 x N coalesced int4 words.  A
// warp owns kWideTokens consecutive tokens of row b: their states come as
// int4 loads where aligned, and all its row loads are issued before the
// first store; a block covers kWideWarps * kWideTokens tokens of row b.
template <int N>
__global__ void __launch_bounds__(kWideThreads)
fetch_wide_kernel(const int4* __restrict__ table,
                  const int32_t* __restrict__ state,
                  const int32_t* __restrict__ live, int4* __restrict__ out,
                  int S, int K, bool vec_state) {
  constexpr int T = kWideTokens;
  static_assert(T % 4 == 0, "states are read as int4");
  constexpr int kRow = 32 * N;                      // int4 words a row
  const int b = blockIdx.y;
  const int n = min(__ldg(live + b), K);
  const int k0 = (blockIdx.x * kWideWarps + (threadIdx.x >> 5)) * T;
  if (k0 >= n) return;
  const int lane = threadIdx.x & 31;
  const int64_t tok = static_cast<int64_t>(b) * K + k0;
  int s[T];
  if (vec_state && k0 + T <= n) {
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(state + tok) + q);
      s[4 * q] = v.x; s[4 * q + 1] = v.y; s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < T; ++u) s[u] = k0 + u < n ? __ldg(state + tok + u) : 0;
  }
  int4 v[T][N];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (k0 + u < n) {
      const int4* src =
          table + static_cast<int64_t>(min(max(s[u], 0), S - 1)) * kRow +
          lane;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (kStreamingHints<N>)
          v[u][j] = load_streaming(src + 32 * j);
        else
          v[u][j] = __ldg(src + 32 * j);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (k0 + u < n) {
      int4* dst = out + (tok + u) * kRow + lane;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (kStreamingHints<N>)
          __stcs(dst + 32 * j, v[u][j]);
        else
          dst[32 * j] = v[u][j];
      }
    }
  }
}

template <int N>
int launch_wide(const void* table, const void* state, const void* live,
                void* out, int S, int B, int K, cudaStream_t stream) {
  constexpr int kTokens = kWideWarps * kWideTokens;
  const bool vec_state = states_vectorizable(state, K);
  dim3 grid((K + kTokens - 1) / kTokens, B);
  fetch_wide_kernel<N><<<grid, kWideThreads, 0, stream>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(live), static_cast<int4*>(out), S, K,
      vec_state);
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
    case 128: return launch_wide<1>(table, state, live, out, S, B, K, st);
    case 256: return launch_wide<2>(table, state, live, out, S, B, K, st);
    case 512: return launch_wide<4>(table, state, live, out, S, B, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
