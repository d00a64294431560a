// Best-path traceback of the v3 search on the card: for each batch row,
// the final slot, then the backward walk over the device-resident search
// logs, writing only the path out.
//
// Replaces no TPU kernel.  The JAX package walks the best path on the host
// (asr_decoder_tpu/ops/beamsearch.py:TpuBeamSearch._traceback_v3, and the
// port's TorchBeamSearch._walk_v3 after it): it copies the whole
// [T, S, B, K] prev_slot and arc_id logs and the [T, B, K] token snapshots
// to the host and walks one slot a frame a row in Python.  At the offline
// batches (B = 256, K = 512, S = 2, ~267 frames; B = 32, K = 4,096) that is
// a 0.4-0.7 GB device-to-host copy a batch of which the walk reads under
// 0.1%.  This kernel walks where the logs lie and returns
//   out[b] = [length, cost bits, reached_final, arc ids...]
// with the original arc ids in backward order (the host reverses them).
//
// What bounds it on Hopper: latency.  The walk is a pointer chase: the
//   slot a frame comes from is known only after that frame's log words
//   are read.  Its bytes are negligible (a few words a frame a row: ~1 MB
//   for the largest batch, 0.3 us at 3.35 TB/s).  Any walk has S dependent
//   log reads a frame on its chain, and a few table reads at its ends:
//   S * T + 9 a row (543 at S = 2, T = 267), every row in flight at once.
//   The bound is that many L2 round trips (chip_smoke.py times a round
//   trip with the chase kernel at the end of this file).  This walk, the
//   host's, also waits each frame on its arc lookups (the prior snapshot,
//   em_offset, em_arcid; for a closure step em_dst, clo_offset,
//   clo_path_off): ~8 dependent reads a frame, with the logs far past the
//   50 MB L2.  At 0.2-0.6 us each that is ~0.4-1.3 ms a batch, under 0.5%
//   of an offline batch's ~0.2-0.3 s, so the walk is left serial.
//
// Design: one block a row.
//   1. The final slot, block-wide: each thread scans K / 256 slots, then a
//      shared-memory tree reduction.  Tokens on the final state win; then
//      the least cost, a NaN before any number and -0.0 equal to +0.0;
//      then the lowest slot (np.argmin's order, which the host walk uses).
//   2. The walk, thread 0, frame T - 1 down to 0, as _walk_v3 walks: the
//      closure stage (its entry clo_offset[em_dst[em_offset[prior[fi / A]]
//      + fi % A]] + fi1 % C, the entry's path from clo_path_off /
//      clo_path_arcs, already backward-ordered), then the emit stage
//      (em_arcid[em_offset[prior[fi / A]] + fi % A]); the prior snapshot
//      is the previous frame's, or the init log's at t = 0; then the init
//      closure stage.  Arcs are written as they are found.
//   Every index read from the logs or the tables is checked before use; a
//   row whose walk leaves a table, or finds a closure entry above a
//   carried token, gets length -1.
//
// Two entries share the row walk (walk_row): traceback_best_paths_i32, the
// offline batch (every row over all T frames of dense [T, S, B, K] logs),
// and traceback_rows_i32, the server's round.  serving/logstore.py keeps
// each channel's logs on the card in a pool of pages of P frames, a row's
// pages listed in its page table, so a row holds only the frames it has
// decoded; block i walks row rows[i] over its own first lengths[i] frames,
// so a round of ~124 replies is one launch and one copy of the paths, in
// place of a host walk of each reply over logs copied out every tick.
// store_frames_i32 writes a tick's frames into the pages at each row's own
// offset and packs the advanced rows' loglikes, in one launch.  The page
// tables come from the host, which checks every page a launch reads or
// writes against the pool.
//
// Plain counterparts: asr_decoder_tpu_torch/ops/traceback.py:
//   best_paths_plain (the walk, vectorised over the rows, each over its own
//   length) and store_frames_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHead = 3;             // length, cost bits, reached_final

struct Args {
  const int32_t* tok_state;          // [B, K] final beam
  const float* tok_cost;             // [B, K]
  const int32_t* prev;               // [T, S, B, K]
  const int32_t* aid;                // [T, S, B, K]
  const int32_t* snap;               // [T, B, K] post-frame token states
  const int32_t* iaid;               // [Si, B, K] init closure stage
  const int32_t* isnap;              // [B, K] post-init token states
  const int32_t* em_offset;          // [N]
  const int32_t* em_dst;             // [E]
  const int32_t* em_arcid;           // [E]
  const int32_t* clo_offset;         // [N]
  const int64_t* clo_path_off;       // [Nclo + 1]
  const int32_t* clo_path_arcs;      // [P]
  int32_t* out;                      // [B, kHead + cap]
  int T, S, Si, B, K, A, C, N, E, Nclo, start, final_state, cap;
};

// (final, cost, slot) a is a better final slot than b
__device__ __forceinline__ bool better(bool fa, float ca, int ia, bool fb,
                                       float cb, int ib) {
  if (fa != fb) return fa;
  const bool na = isnan(ca), nb = isnan(cb);
  if (na != nb) return na;
  if (!na && ca != cb) return ca < cb;
  return ia < ib;
}

__device__ __forceinline__ bool in(int64_t x, int64_t n) {
  return x >= 0 && x < n;
}

// closure entry `e`'s path onto arcs[n...]; false where it leaves the row
__device__ __forceinline__ bool put_path(const Args& a, int64_t e,
                                         int32_t* arcs, int64_t& n) {
  const int64_t lo = a.clo_path_off[e], hi = a.clo_path_off[e + 1];
  if (n + hi - lo > a.cap) return false;
  for (int64_t j = lo; j < hi; ++j) arcs[n++] = __ldg(a.clo_path_arcs + j);
  return true;
}

// Where frame t's log words lie.  DenseFrames: the offline [T, S, B, K]
// logs and [T, B, K] snapshots, at beam row offset `row`.  PagedFrames: the
// served store's pool, [NP, P, S, K] logs and [NP, P, K] snapshots, frame t
// of a row in page pages[t / P] at t % P.  log(t) is the offset of stage 0
// of frame t's words (stage s at + s * stage), snap(t) that of its
// snapshot's.
struct DenseFrames {
  int64_t BK, row;
  int S;
  __device__ __forceinline__ int64_t log(int t) const {
    return t * S * BK + row;
  }
  __device__ __forceinline__ int64_t snap(int t) const {
    return t * BK + row;
  }
  __device__ __forceinline__ int64_t stage() const { return BK; }
};

struct PagedFrames {
  const int32_t* pages;              // the row's page table
  int P, S, K;
  __device__ __forceinline__ int64_t at(int t) const {
    return static_cast<int64_t>(__ldg(pages + t / P)) * P + t % P;
  }
  __device__ __forceinline__ int64_t log(int t) const {
    return at(t) * S * K;
  }
  __device__ __forceinline__ int64_t snap(int t) const { return at(t) * K; }
  __device__ __forceinline__ int64_t stage() const { return K; }
};

// One row's walk, called by every thread of the block (the final slot is a
// block-wide reduction; thread 0 walks): the final slot over the beam row at
// `row`, then frames T - 1 down to 0 of the logs where `fr` places them,
// with the prior snapshot of frame 0 and the init closure stage at `init`
// of the init log; writes out[0, kHead + n).
template <class Frames>
__device__ __forceinline__ void walk_row(const Args& a, const Frames& fr,
                                         int T, int64_t row, int64_t init,
                                         int32_t* out) {
  __shared__ bool s_fin[kThreads];
  __shared__ float s_cost[kThreads];
  __shared__ int s_idx[kThreads];
  const int tid = threadIdx.x;
  const int K = a.K;

  // ---- 1. the final slot ------------------------------------------------
  bool fin = false;
  float cost = 0.f;
  int idx = K;                                    // none yet
  for (int k = tid; k < K; k += kThreads) {
    const bool f = __ldg(a.tok_state + row + k) == a.final_state;
    const float c = __ldg(a.tok_cost + row + k);
    if (idx == K || better(f, c, k, fin, cost, idx)) {
      fin = f; cost = c; idx = k;
    }
  }
  s_fin[tid] = fin; s_cost[tid] = cost; s_idx[tid] = idx;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w && s_idx[tid + w] < K &&
        (s_idx[tid] == K || better(s_fin[tid + w], s_cost[tid + w],
                                   s_idx[tid + w], s_fin[tid], s_cost[tid],
                                   s_idx[tid]))) {
      s_fin[tid] = s_fin[tid + w]; s_cost[tid] = s_cost[tid + w];
      s_idx[tid] = s_idx[tid + w];
    }
    __syncthreads();
  }
  if (tid) return;

  // ---- 2. the walk --------------------------------------------------------
  int32_t* arcs = out + kHead;
  out[1] = __float_as_int(s_cost[0]);
  out[2] = s_fin[0];
  int slot = s_idx[0];
  int64_t n = 0;
  bool ok = true;
  for (int t = T - 1; t >= 0 && ok; --t) {
    const int64_t frame = fr.log(t), BK = fr.stage();
    const int32_t* prior = t ? a.snap + fr.snap(t - 1) : a.isnap + init;
    int fi1 = -1;
    if (a.S == 2) {
      fi1 = __ldg(a.aid + frame + BK + slot);
      slot = __ldg(a.prev + frame + BK + slot);
      if (!in(slot, K)) { ok = false; break; }
    }
    const int fi = __ldg(a.aid + frame + slot);
    slot = __ldg(a.prev + frame + slot);
    if (fi < 0) {
      ok = fi1 < 0 && in(slot, K);
      continue;
    }
    slot = fi / a.A;
    if (!in(slot, K)) { ok = false; break; }
    const int ps = __ldg(prior + slot);
    const int64_t ai = in(ps, a.N)
        ? static_cast<int64_t>(__ldg(a.em_offset + ps)) + fi % a.A : -1;
    if (!in(ai, a.E)) { ok = false; break; }
    if (fi1 >= 0) {
      const int sd = __ldg(a.em_dst + ai);
      const int64_t e = in(sd, a.N)
          ? static_cast<int64_t>(__ldg(a.clo_offset + sd)) + fi1 % a.C : -1;
      ok = in(e, a.Nclo) && put_path(a, e, arcs, n);
    }
    if (ok && n < a.cap) arcs[n++] = __ldg(a.em_arcid + ai);
    else ok = false;
  }
  // the init closure stage: pre-closure beam = [start] at slot 0
  if (ok && a.Si) {
    const int fi1 = __ldg(a.iaid + init + slot);
    if (fi1 >= 0) {
      const int64_t e = static_cast<int64_t>(a.clo_offset[a.start]) +
                        fi1 % a.C;
      ok = in(e, a.Nclo) && put_path(a, e, arcs, n);
    }
  }
  out[0] = ok ? static_cast<int32_t>(n) : -1;
}

// The offline batch: row b of the beam, the logs and the init log.
__global__ void __launch_bounds__(kThreads) traceback_kernel(Args a) {
  const int b = blockIdx.x;
  const int64_t row = b * int64_t{a.K};
  walk_row(a, DenseFrames{static_cast<int64_t>(a.B) * a.K, row, a.S}, a.T,
           row, row, a.out + static_cast<int64_t>(b) * (kHead + a.cap));
}

// The served store (serving/logstore.py): block i walks row idx[i][0] of
// the beam over its first idx[i][1] frames, in the pages idx[i][2...] of
// the pool, from the one init row every row shares.  idx is i32[n, 2 + M].
__global__ void __launch_bounds__(kThreads) traceback_rows_kernel(
    Args a, const int32_t* __restrict__ idx, int M, int P) {
  const int i = blockIdx.x;
  const int32_t* ri = idx + static_cast<int64_t>(i) * (2 + M);
  const int r = __ldg(ri), T = __ldg(ri + 1);
  int32_t* out = a.out + static_cast<int64_t>(i) * (kHead + a.cap);
  walk_row(a, PagedFrames{ri + 2, P, a.S, a.K}, T, r * int64_t{a.K}, 0,
           out);
}

// The served store's write, one block a (row, frame) of the tick: frame f <
// valid of block row r of the tick's logs into the row's pages at frame
// off + f, and the row's loglikes of that frame into row i of a packed
// copy (the only part of the tick the host reads); (r, off, valid, pages)
// = idx[i] (i32[n, 3 + M]).  32-bit words; the bytes are the copy's, ~6 K
// + V words a (row, frame), so it is bandwidth- and launch-sized (~13 MB
// at 21 rows x 32 frames, K 512, V 2048).
struct StoreArgs {
  const int32_t* prev;               // [F, S, B, K] the tick's logs
  const int32_t* aid;                // [F, S, B, K]
  const int32_t* snap;               // [F, B, K]
  const int32_t* snap_cost;          // [F, B, K] (f32 bits)
  int32_t* store_prev;               // [NP, P, S, K] the pool
  int32_t* store_aid;                // [NP, P, S, K]
  int32_t* store_snap;               // [NP, P, K]
  int32_t* store_cost;               // [NP, P, K]
  const int32_t* ll;                 // [B, F, V] the tick's loglikes
  int32_t* packed;                   // [n, F, V]
  const int32_t* idx;                // [n, 3 + M]
  int F, S, B, K, V, P, M;
};

__global__ void __launch_bounds__(kThreads) store_frames_kernel(
    StoreArgs a) {
  const int i = blockIdx.x / a.F, f = blockIdx.x % a.F;
  const int32_t* ri = a.idx + static_cast<int64_t>(i) * (3 + a.M);
  const int r = __ldg(ri);
  if (f >= __ldg(ri + 2)) return;
  const int t = __ldg(ri + 1) + f;
  const int64_t g = static_cast<int64_t>(__ldg(ri + 3 + t / a.P)) * a.P +
                    t % a.P;
  const int64_t K = a.K, BK = a.B * K;
  for (int s = 0; s < a.S; ++s) {
    const int64_t src = (int64_t{f} * a.S + s) * BK + r * K;
    const int64_t dst = (g * a.S + s) * K;
    for (int k = threadIdx.x; k < a.K; k += kThreads) {
      a.store_prev[dst + k] = __ldg(a.prev + src + k);
      a.store_aid[dst + k] = __ldg(a.aid + src + k);
    }
  }
  const int64_t src = f * BK + r * K, dst = g * K;
  for (int k = threadIdx.x; k < a.K; k += kThreads) {
    a.store_snap[dst + k] = __ldg(a.snap + src + k);
    a.store_cost[dst + k] = __ldg(a.snap_cost + src + k);
  }
  const int64_t lsrc = (static_cast<int64_t>(r) * a.F + f) * a.V;
  const int64_t ldst = (static_cast<int64_t>(i) * a.F + f) * a.V;
  for (int k = threadIdx.x; k < a.V; k += kThreads)
    a.packed[ldst + k] = __ldg(a.ll + lsrc + k);
}

}  // namespace

// One launch of B blocks on `stream`; every pointer on the current device,
// contiguous.  S is 1 or 2 (emit, then closure), Si 0 or 1 (the init
// closure stage); C > 0 wherever S == 2 or Si == 1.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int traceback_best_paths_i32(
    const void* tok_state, const void* tok_cost, const void* prev,
    const void* aid, const void* snap, const void* iaid, const void* isnap,
    const void* em_offset, const void* em_dst, const void* em_arcid,
    const void* clo_offset, const void* clo_path_off,
    const void* clo_path_arcs, void* out, int T, int S, int Si, int B, int K,
    int A, int C, int N, int E, int Nclo, int start, int final_state,
    int cap, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || A <= 0 || S < 1 || S > 2 || Si < 0 || Si > 1 ||
      ((S == 2 || Si == 1) && C <= 0) || T < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int32_t*>(tok_state),
         static_cast<const float*>(tok_cost),
         static_cast<const int32_t*>(prev),
         static_cast<const int32_t*>(aid),
         static_cast<const int32_t*>(snap),
         static_cast<const int32_t*>(iaid),
         static_cast<const int32_t*>(isnap),
         static_cast<const int32_t*>(em_offset),
         static_cast<const int32_t*>(em_dst),
         static_cast<const int32_t*>(em_arcid),
         static_cast<const int32_t*>(clo_offset),
         static_cast<const int64_t*>(clo_path_off),
         static_cast<const int32_t*>(clo_path_arcs),
         static_cast<int32_t*>(out),
         T, S, Si, B, K, A, C, N, E, Nclo, start, final_state, cap};
  traceback_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The served store's walk: one launch of n blocks on `stream`, block i
// walking row idx[i][0] of the beam ([B, K]) over its first idx[i][1]
// frames, in its pages idx[i][2...] of a pool of [NP, P, S, K] logs and
// [NP, P, K] snapshots; the init log is one row ([Si, 1, K], [1, K]) every
// row shares.  idx is i32[n, 2 + M] on the device, every page it names for
// a row's frames inside the pool (the caller checks); out is
// i32[n, kHead + cap].  The same shapes as traceback_best_paths_i32
// otherwise.
extern "C" int traceback_rows_i32(
    const void* tok_state, const void* tok_cost, const void* prev,
    const void* aid, const void* snap, const void* iaid, const void* isnap,
    const void* em_offset, const void* em_dst, const void* em_arcid,
    const void* clo_offset, const void* clo_path_off,
    const void* clo_path_arcs, void* out, const void* idx, int n, int M,
    int P, int S, int Si, int B, int K, int A, int C, int N, int E, int Nclo,
    int start, int final_state, int cap, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || M < 0 || P <= 0 || B <= 0 || K <= 0 || A <= 0 || S < 1 ||
      S > 2 || Si < 0 || Si > 1 || ((S == 2 || Si == 1) && C <= 0) ||
      cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int32_t*>(tok_state),
         static_cast<const float*>(tok_cost),
         static_cast<const int32_t*>(prev),
         static_cast<const int32_t*>(aid),
         static_cast<const int32_t*>(snap),
         static_cast<const int32_t*>(iaid),
         static_cast<const int32_t*>(isnap),
         static_cast<const int32_t*>(em_offset),
         static_cast<const int32_t*>(em_dst),
         static_cast<const int32_t*>(em_arcid),
         static_cast<const int32_t*>(clo_offset),
         static_cast<const int64_t*>(clo_path_off),
         static_cast<const int32_t*>(clo_path_arcs),
         static_cast<int32_t*>(out),
         0, S, Si, B, K, A, C, N, E, Nclo, start, final_state, cap};
  traceback_rows_kernel<<<n, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(idx), M, P);
  return static_cast<int>(cudaGetLastError());
}

// The served store's write: one launch of n * F blocks on `stream`; every
// pointer on the current device, contiguous, 32-bit words (StoreArgs);
// idx is i32[n, 3 + M] on the device, every page it names for a row's
// frames inside the pool (the caller checks).
extern "C" int store_frames_i32(
    const void* prev, const void* aid, const void* snap,
    const void* snap_cost, void* store_prev, void* store_aid,
    void* store_snap, void* store_cost, const void* ll, void* packed,
    const void* idx, int n, int F, int S, int B, int K, int V, int P, int M,
    void* stream) {
  if (n == 0 || F == 0) return 0;
  if (n < 0 || F < 0 || S < 1 || B <= 0 || K <= 0 || V < 0 || P <= 0 ||
      M < 0 || static_cast<int64_t>(n) * F > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  StoreArgs a{static_cast<const int32_t*>(prev),
              static_cast<const int32_t*>(aid),
              static_cast<const int32_t*>(snap),
              static_cast<const int32_t*>(snap_cost),
              static_cast<int32_t*>(store_prev),
              static_cast<int32_t*>(store_aid),
              static_cast<int32_t*>(store_snap),
              static_cast<int32_t*>(store_cost),
              static_cast<const int32_t*>(ll),
              static_cast<int32_t*>(packed),
              static_cast<const int32_t*>(idx),
              F, S, B, K, V, P, M};
  store_frames_kernel<<<n * F, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The yardstick of the walk's bound (chip_smoke.py): one thread follows
// next[] `steps` times from 0, each read waiting on the last, as the slot
// chain does, and stores where it ends.  Over a cycle through a buffer
// past the L2 it times a device-memory round trip; over one inside the L2,
// an L2 round trip.
namespace {
__global__ void chase_kernel(const int32_t* __restrict__ next, int steps,
                             int32_t* __restrict__ out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldg(next + i);
  *out = i;
}
}  // namespace

extern "C" int traceback_chase_i32(const void* next, int steps, void* out,
                                   void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
