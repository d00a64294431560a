// Batched small-table gather, one index for up to 8 tables:
//   out_p[b, n] = table_p[b, idx[b, n]]   for p < P <= 8.
//
// Replaces: asr_decoder_tpu/ops/gather.py:_pallas_gather (body _llg_kernel),
//   the TPU kernel behind every batched_table_gather of the beam search —
//   the acoustic-score lookup (one log-likelihood per arc candidate) and the
//   re-ordering gathers inside the relax stages, where one winner index often
//   re-orders several tables at once (cost, state and candidate index; the
//   BigLM compaction's seven operands).
//
// What bounds it on Hopper: bytes, at a size where latency dominates.  The
//   work moves B*(V*P + N + N*P) words (each table row read once, the index
//   read once, each output written once): at the search's shapes 0.1-10 MB,
//   0.03-3.1 us at 3.35 TB/s, against an empty kernel's ~1.1 us.  Every
//   table the search gathers from is at most a few MB, so it sits in the
//   50 MB L2: what costs time is the chain of two dependent round trips
//   (index, then table word) and, per SM, the sectors a warp's random
//   4-byte reads touch (up to 32 for 128 bytes used).
//
// Design:
//   * One launch serves P tables that share the index, so the index is
//     read once and P launches become one (the wrapper views f32 tables as
//     i32: the kernel moves 32-bit words, so both types are bit-exact).
//   * A thread owns 4 consecutive outputs of a row: one int4 index load,
//     then all 4*P table reads (__ldg) issued before the first store, then
//     one int4 store a table.  int4 needs N % 4 == 0 and 16-byte aligned
//     idx and outputs; otherwise the same layout runs with scalar loads and
//     stores (template kVecIO).
//   * The table count is a template parameter: a launch carries only its
//     P pointer pairs, and the loops over tables unroll.
//   Staging the rows in shared memory (one TMA bulk copy a row, then
//   shared-memory reads) was built and measured slower at every search
//   shape: the copy adds a round trip before the first read, and random
//   reads of an L2-resident row are cheap.  The TPU kernel's 128-lane chunk
//   select exists only because a TPU vreg gathers within 128 lanes; a GPU
//   thread reads any address.  An index outside [0, V) is clamped into the
//   row, so a bad index cannot read another row or outside the table.
//
// Plain counterpart: torch.gather(table_p, 1, idx.long()) for each p
//   (asr_decoder_tpu_torch/ops/gather.py:gather_plain_many).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 8;
constexpr int kThreads = 256;
constexpr int kVec = 4;                      // outputs a thread

// the P table and output pointers, passed by value: 16 bytes a table, so a
// one-table launch carries no more parameters than a plain gather's
template <int kP>
struct Tables {
  const int32_t* t[kP];
  int32_t* o[kP];
};

// grid (ceil(N / 1024), B) of 256 threads, kVec outputs each
template <int kP, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
gather_kernel(Tables<kP> tabs, const int32_t* __restrict__ idx, int V,
              int N) {
  const int b = blockIdx.y;
  const int n = kVec * (blockIdx.x * kThreads + threadIdx.x);
  if (n >= N) return;
  const int64_t o = static_cast<int64_t>(b) * N + n;
  int i[kVec];
  if (kVecIO) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + o));
    i[0] = v.x; i[1] = v.y; i[2] = v.z; i[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) i[j] = n + j < N ? __ldg(idx + o + j) : 0;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) i[j] = min(max(i[j], 0), V - 1);
  const int64_t row = static_cast<int64_t>(b) * V;
  int v[kP][kVec];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[p][j] = __ldg(tabs.t[p] + row + i[j]);
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (kVecIO) {
      *reinterpret_cast<int4*>(tabs.o[p] + o) =
          make_int4(v[p][0], v[p][1], v[p][2], v[p][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (n + j < N) tabs.o[p][o + j] = v[p][j];
    }
  }
}

template <int kP>
int launch(const void* const* tables, void* const* outs, const void* idx,
           int B, int V, int N, cudaStream_t stream) {
  Tables<kP> tabs;
  bool aligned = N % kVec == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  for (int p = 0; p < kP; ++p) {
    tabs.t[p] = static_cast<const int32_t*>(tables[p]);
    tabs.o[p] = static_cast<int32_t*>(outs[p]);
    aligned = aligned && (reinterpret_cast<uintptr_t>(outs[p]) & 15) == 0;
  }
  const dim3 grid((N + kThreads * kVec - 1) / (kThreads * kVec), B);
  const auto* ix = static_cast<const int32_t*>(idx);
  if (aligned)
    gather_kernel<kP, true><<<grid, kThreads, 0, stream>>>(tabs, ix, V, N);
  else
    gather_kernel<kP, false><<<grid, kThreads, 0, stream>>>(tabs, ix, V, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: P pointers to i32[B, V]; outs: P pointers to i32[B, N]; idx
// i32[B, N]; all contiguous on the current device, 1 <= P <= 8.  Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a P
// or V out of range.
extern "C" int batched_table_gather_many_i32(const void* const* tables,
                                             void* const* outs, int P,
                                             const void* idx, int B, int V,
                                             int N, void* stream) {
  if (P < 1 || P > kMaxTables || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch<1>(tables, outs, idx, B, V, N, st);
    case 2: return launch<2>(tables, outs, idx, B, V, N, st);
    case 3: return launch<3>(tables, outs, idx, B, V, N, st);
    case 4: return launch<4>(tables, outs, idx, B, V, N, st);
    case 5: return launch<5>(tables, outs, idx, B, V, N, st);
    case 6: return launch<6>(tables, outs, idx, B, V, N, st);
    case 7: return launch<7>(tables, outs, idx, B, V, N, st);
    default: return launch<8>(tables, outs, idx, B, V, N, st);
  }
}
