"""Device-resident decode graph: degree-bounded split CSR for TPU search.

TPU-first re-design of the reference's arc iteration
(ref: src/newfst/arc-iter.h:10-43, src/my-decoder/online-decoder-base-inl.h:247-352):
instead of per-token pointer walks, the search gathers fixed ``arc_lanes``
arc slots per active token.  To make that exact for states whose out-degree
exceeds the lane count, the graph is rewritten at load time: oversized arc
lists are split across a chain of continuation states linked by weight-0
ε-arcs (an equivalence-preserving WFST transformation).  Emitting and ε arcs
are kept in two separate CSR blocks so ProcessEmitting / ProcessNonemitting
(ref: online-decoder-base-inl.h:247,354) become two masked gather stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from asr_decoder_tpu_torch.fst.fst import EPSILON, StdFst


def _segment_arange(src_sorted: np.ndarray, n: int) -> np.ndarray:
    """Position of each element within its (sorted) src segment."""
    cnt = np.bincount(src_sorted, minlength=n)
    off = np.zeros(n, np.int64)
    np.cumsum(cnt[:-1], out=off[1:])
    return np.arange(len(src_sorted), dtype=np.int64) - off[src_sorted]


@dataclass
class DeviceFst:
    """Numpy (host) mirror of the device graph; ``to_device()`` uploads.

    Arc ids in the emitting/eps blocks index the *original* ``StdFst`` arc
    array where the arc came from (split-chain ε-arcs get id -1), so lattice
    links recorded on device can be mapped back to source-graph arcs.
    """

    start: int
    final_state: int
    num_states: int
    eps_depth: int
    # maps each (possibly split) device state to the original StdFst state
    # it represents — continuation states inherit their source state's id,
    # so host-side lattice reconstruction can fold them back
    orig_state: np.ndarray   # i32[num_states]
    # emitting block
    em_offset: np.ndarray    # i32[num_states]
    em_count: np.ndarray     # i32[num_states]
    em_ilabel: np.ndarray    # i32[num_em_arcs]
    em_olabel: np.ndarray    # i32[num_em_arcs]
    em_weight: np.ndarray    # f32[num_em_arcs]
    em_dst: np.ndarray       # i32[num_em_arcs]
    em_arcid: np.ndarray     # i32[num_em_arcs]
    # epsilon block
    eps_offset: np.ndarray
    eps_count: np.ndarray
    eps_olabel: np.ndarray
    eps_weight: np.ndarray
    eps_dst: np.ndarray
    eps_arcid: np.ndarray
    # ε-closure block (lazily built by ``build_closure``): for each state s,
    # entries are the *proper* ε-reachable states (s itself is implicit) with
    # their best ε-path weight; ``clo_paths(i)`` yields entry i's best
    # ε-path original arc ids BACKWARD-ordered (v→s), stored ragged
    # (``clo_path_arcs``/``clo_path_off`` CSR; split-chain bookkeeping
    # links dropped — a dense [num_clo, max_depth] matrix padded to the
    # deepest split chain multiplied host memory on production HCLGs).
    # This turns the reference's per-frame ε worklist
    # (ProcessNonemitting,
    # ref: src/my-decoder/online-decoder-base-inl.h:354-437) into a single
    # precomputed relaxation stage on device.
    clo_offset: np.ndarray | None = None   # i32[num_states]
    clo_count: np.ndarray | None = None    # i32[num_states]
    clo_dst: np.ndarray | None = None      # i32[num_clo]
    clo_weight: np.ndarray | None = None   # f32[num_clo]
    clo_path_arcs: np.ndarray | None = None  # i32[total_path_arcs]
    clo_path_off: np.ndarray | None = None    # i64[num_clo+1]

    @property
    def max_em_degree(self) -> int:
        return int(self.em_count.max()) if len(self.em_count) else 0

    @property
    def max_eps_degree(self) -> int:
        return int(self.eps_count.max()) if len(self.eps_count) else 0

    @staticmethod
    def build(fst: StdFst, arc_lanes: int = 16) -> "DeviceFst":
        """Split states so no state has more than ``arc_lanes`` emitting arcs
        or more than ``arc_lanes`` ε-arcs (counting the continuation link).

        Fully vectorized (no per-arc Python): each oversized state becomes a
        chain of nodes — node i holds emitting-arc group i (``arc_lanes`` per
        group) and ε-arc group i (``arc_lanes-1`` per non-last group, the
        spare lane holds the weight-0 ε continuation link) — an
        equivalence-preserving WFST rewrite.  Original states keep their ids
        (node 0), so start/final ids survive.
        """
        assert arc_lanes >= 2
        if fst.max_out_degree() <= arc_lanes:
            # fast path: no splitting needed — vectorized CSR pack
            return DeviceFst._build_nosplit(fst)
        n = fst.num_states
        A = arc_lanes
        src_all = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(fst.state_offset))
        is_eps = fst.arc_ilabel == EPSILON
        arc_ids = np.arange(fst.num_arcs, dtype=np.int32)

        em_d = np.bincount(src_all[~is_eps], minlength=n)
        eps_d = np.bincount(src_all[is_eps], minlength=n)
        # nodes per state: enough groups for both blocks (non-last nodes
        # donate one ε lane to the chain link)
        k_em = np.maximum((em_d + A - 1) // A, 1)
        k_eps = np.where(eps_d <= A, 1, (eps_d - 2) // (A - 1) + 1)
        k = np.maximum(k_em, k_eps)
        cont = k - 1
        cont_base = np.zeros(n, np.int64)
        np.cumsum(cont[:-1], out=cont_base[1:])
        nn = int(n + cont.sum())

        def node_id(s, i):
            return np.where(i == 0, s, n + cont_base[s] + i - 1)

        em_src0 = src_all[~is_eps]
        em_node = _segment_arange(em_src0, n) // A
        em_srcN = node_id(em_src0, em_node)

        ep_src0 = src_all[is_eps]
        ep_node = np.minimum(_segment_arange(ep_src0, n) // (A - 1),
                             k[ep_src0] - 1)
        ep_srcN = node_id(ep_src0, ep_node)

        link_s = np.repeat(np.arange(n, dtype=np.int64), cont)
        link_i = _segment_arange(link_s, n)
        link_src = node_id(link_s, link_i)
        link_dst = node_id(link_s, link_i + 1)

        def pack(src, *fields):
            order = np.argsort(src, kind="stable")
            counts = np.bincount(src, minlength=nn).astype(np.int32)
            offsets = np.zeros(nn, np.int32)
            np.cumsum(counts[:-1], out=offsets[1:])
            return (offsets, counts) + tuple(f[order] for f in fields)

        em_off, em_cnt, em_il, em_ol, em_w, em_dst2, em_id = pack(
            em_srcN, fst.arc_ilabel[~is_eps], fst.arc_olabel[~is_eps],
            fst.arc_weight[~is_eps], fst.arc_dst[~is_eps], arc_ids[~is_eps])
        eps_src = np.concatenate([ep_srcN, link_src])
        eps_off, eps_cnt, eps_ol, eps_w, eps_dst2, eps_id = pack(
            eps_src,
            np.concatenate([fst.arc_olabel[is_eps],
                            np.zeros(len(link_src), np.int32)]),
            np.concatenate([fst.arc_weight[is_eps],
                            np.zeros(len(link_src), np.float32)]),
            np.concatenate([fst.arc_dst[is_eps].astype(np.int64), link_dst]),
            np.concatenate([arc_ids[is_eps],
                            np.full(len(link_src), -1, np.int32)]))
        origin = np.concatenate([np.arange(n, dtype=np.int32),
                                 np.repeat(np.arange(n, dtype=np.int32),
                                           cont)])
        dev = DeviceFst(
            start=fst.start, final_state=fst.final_state, num_states=nn,
            eps_depth=0, orig_state=origin,
            em_offset=em_off, em_count=em_cnt,
            em_ilabel=em_il.astype(np.int32),
            em_olabel=em_ol.astype(np.int32),
            em_weight=em_w.astype(np.float32),
            em_dst=em_dst2.astype(np.int32), em_arcid=em_id,
            eps_offset=eps_off, eps_count=eps_cnt,
            eps_olabel=eps_ol.astype(np.int32),
            eps_weight=eps_w.astype(np.float32),
            eps_dst=eps_dst2.astype(np.int32), eps_arcid=eps_id)
        dev.eps_depth = dev._compute_eps_depth()
        return dev

    @staticmethod
    def _build_nosplit(fst: StdFst) -> "DeviceFst":
        """Vectorized pack when every state's total out-degree fits the
        lanes (per-block degrees are then ≤ total, so both blocks fit)."""
        n = fst.num_states
        src_all = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(fst.state_offset))
        is_eps = fst.arc_ilabel == EPSILON
        arc_ids = np.arange(fst.num_arcs, dtype=np.int32)

        def pack(mask):
            src = src_all[mask]
            counts = np.bincount(src, minlength=n).astype(np.int32)
            offsets = np.zeros(n, np.int32)
            np.cumsum(counts[:-1], out=offsets[1:])
            return (offsets, counts, fst.arc_ilabel[mask],
                    fst.arc_olabel[mask], fst.arc_weight[mask],
                    fst.arc_dst[mask], arc_ids[mask])

        # arcs are already grouped by src (CSR) so masking preserves order
        em_off, em_cnt, em_il, em_ol, em_w, em_d, em_id = pack(~is_eps)
        eps_off, eps_cnt, _, eps_ol, eps_w, eps_d, eps_id = pack(is_eps)
        dev = DeviceFst(
            start=fst.start, final_state=fst.final_state, num_states=n,
            eps_depth=0, orig_state=np.arange(n, dtype=np.int32),
            em_offset=em_off, em_count=em_cnt, em_ilabel=em_il,
            em_olabel=em_ol, em_weight=em_w, em_dst=em_d, em_arcid=em_id,
            eps_offset=eps_off, eps_count=eps_cnt, eps_olabel=eps_ol,
            eps_weight=eps_w, eps_dst=eps_d, eps_arcid=eps_id)
        dev.eps_depth = dev._compute_eps_depth()
        return dev

    def _compute_eps_depth(self, max_iters: int = 256) -> int:
        """Longest ε-chain in the (possibly split) graph — the number of
        bounded relaxation sweeps ProcessNonemitting needs per frame.
        Returns -1 if the ε-subgraph is cyclic (sweeps mode then cannot be
        used; the ε-closure table tolerates non-negative ε-cycles)."""
        if len(self.eps_dst) == 0:
            return 0
        esrc = np.repeat(np.arange(self.num_states, dtype=np.int64),
                         self.eps_count)
        edst = self.eps_dst.astype(np.int64)
        depth = np.zeros(self.num_states, np.int64)
        for _ in range(max_iters):
            nd = depth.copy()
            np.maximum.at(nd, edst, depth[esrc] + 1)
            if np.array_equal(nd, depth):
                return int(depth.max())
            depth = nd
        return -1

    @property
    def max_closure_size(self) -> int:
        """Max *proper* closure entries of any state (build_closure first)."""
        assert self.clo_count is not None
        return int(self.clo_count.max()) if len(self.clo_count) else 0

    def build_closure(self) -> None:
        """Precompute per-state ε-closures (Dijkstra over the ε-subgraph).

        closure(s) = every state ε-reachable from s with the Viterbi (min
        total weight) ε-path and that path's original arc ids.  Replaces the
        per-frame ε worklist with one device relaxation stage; exact for any
        ε-subgraph with non-negative weights (ε-cycles allowed — unlike the
        depth-bounded sweep mode).  Idempotent.
        """
        if self.clo_offset is not None:
            return
        n = self.num_states
        if len(self.eps_dst) and float(self.eps_weight.min()) < 0.0:
            raise ValueError("negative epsilon weights: closure unsupported")
        if len(self.eps_dst) == 0:
            self.clo_offset = np.zeros(n, np.int32)
            self.clo_count = np.zeros(n, np.int32)
            self.clo_dst = np.zeros(0, np.int32)
            self.clo_weight = np.zeros(0, np.float32)
            self.clo_path_arcs = np.zeros(0, np.int32)
            self.clo_path_off = np.zeros(1, np.int64)
            return
        # vectorized all-sources Bellman-Ford over the ε-subgraph: the
        # relation R = {(s, v) → (dist, last_edge)} starts as the identity
        # and is repeatedly expanded through ε arcs with a lexsort min-merge
        # until fixpoint; the per-state-Dijkstra this replaces was
        # hours-scale on production HCLGs
        E_w = self.eps_weight.astype(np.float64)
        E_dst = self.eps_dst.astype(np.int64)
        e_off = np.zeros(n, np.int64)
        np.cumsum(self.eps_count[:-1].astype(np.int64), out=e_off[1:])
        e_cnt = self.eps_count.astype(np.int64)
        # seed only states that can reach ε arcs (keeps R small)
        has_eps = e_cnt > 0
        R_s = np.where(has_eps)[0].astype(np.int64)
        R_v = R_s.copy()
        R_d = np.zeros(len(R_s), np.float64)
        R_e = np.full(len(R_s), -1, np.int64)          # last edge of path
        prev_key = None
        for _ in range(nn_cap := 4 * n + 8):
            # expand every entry (s, u) through u's ε arcs
            cnt_u = e_cnt[R_v]
            tot = int(cnt_u.sum())
            if tot == 0:
                break
            ent = np.repeat(np.arange(len(R_s), dtype=np.int64), cnt_u)
            base = np.repeat(e_off[R_v], cnt_u)
            boff = np.zeros(len(R_s), np.int64)
            np.cumsum(cnt_u[:-1], out=boff[1:])
            ei = base + (np.arange(tot, dtype=np.int64)
                         - np.repeat(boff, cnt_u))
            c_s = np.concatenate([R_s, R_s[ent]])
            c_v = np.concatenate([R_v, E_dst[ei]])
            c_d = np.concatenate([R_d, R_d[ent] + E_w[ei]])
            c_e = np.concatenate([R_e, ei])
            key = c_s * n + c_v
            order = np.lexsort((c_d, key))
            ks = key[order]
            first = np.concatenate([[True], ks[1:] != ks[:-1]])
            sel = order[first]
            R_s, R_v, R_d, R_e = c_s[sel], c_v[sel], c_d[sel], c_e[sel]
            new_key = (ks[first], R_d)
            if prev_key is not None and len(prev_key[0]) == len(new_key[0]) \
                    and np.array_equal(prev_key[0], new_key[0]) \
                    and np.array_equal(prev_key[1], new_key[1]):
                break
            prev_key = new_key
        else:
            raise ValueError("epsilon closure did not converge")
        # drop identity entries; final arrays sorted by (s, v)
        proper = R_v != R_s
        C_s, C_v = R_s[proper], R_v[proper]
        C_d, C_e = R_d[proper], R_e[proper]
        count = np.bincount(C_s, minlength=n).astype(np.int32)
        offset = np.zeros(n, np.int32)
        np.cumsum(count[:-1], out=offset[1:])
        # best-ε-path arc ids per entry: follow last-edge predecessors
        # through the (s, u) table — vectorized across ALL entries at once,
        # one searchsorted batch per chain depth level (the per-entry
        # Python walk this replaces reintroduced hours-scale preprocessing
        # on production HCLGs with wide closures).  Pred chains are
        # consistent at fixpoint.
        keys = R_s * n + R_v
        esrc = np.repeat(np.arange(n, dtype=np.int64), e_cnt)
        eps_arcid = self.eps_arcid.astype(np.int64)
        m = len(C_s)
        cur_e = C_e.astype(np.int64).copy()
        active = np.ones(m, bool)
        cols: list[np.ndarray] = []    # arc id per entry per depth, -1=none
        for _ in range(n + 1):
            if not active.any():
                break
            safe = np.where(active, cur_e, 0)
            # -1 marks both inactive entries and split-chain bookkeeping
            # links (eps_arcid == -1); consumers drop them identically
            aid = np.where(active, eps_arcid[safe], -1)
            cols.append(aid)
            u = esrc[safe]
            cont = active & (u != C_s)
            if cont.any():
                j = np.searchsorted(keys, C_s[cont] * n + u[cont])
                cur_e[cont] = R_e[j]
            active = cont
        else:
            if active.any():
                raise ValueError("epsilon closure path cycle")
        # rows are BACKWARD-ordered (v→s): level 0 is the path's last edge
        mat = (np.stack(cols, axis=1) if cols
               else np.zeros((m, 0), np.int64))
        keep = mat >= 0
        self.clo_path_arcs = mat[keep].astype(np.int32)
        cnt = keep.sum(axis=1)
        self.clo_path_off = np.concatenate(
            [[0], np.cumsum(cnt)]).astype(np.int64)
        self.clo_offset = offset
        self.clo_count = count
        self.clo_dst = C_v.astype(np.int32)
        self.clo_weight = C_d.astype(np.float32)


    def clo_paths(self, entry: int) -> np.ndarray:
        """Closure entry's best ε-path original arc ids, backward-ordered
        (last edge first); split-chain bookkeeping links already dropped."""
        return self.clo_path_arcs[self.clo_path_off[entry]:
                                  self.clo_path_off[entry + 1]]

    # -- prebuilt-graph persistence (role of the reference's converted
    #    binary graph files: build once offline, load in seconds at serving
    #    startup — ref: src/fst_format_convert_tool/README.txt) -----------
    _SCALARS = ("start", "final_state", "num_states", "eps_depth")

    def save(self, path: str) -> None:
        """Persist the split CSR + (if built) ε-closure to one .npz."""
        arrays = {k: v for k, v in self.__dict__.items()
                  if isinstance(v, np.ndarray)}
        scalars = np.array([getattr(self, k) for k in self._SCALARS],
                           np.int64)
        np.savez_compressed(path, __scalars__=scalars, **arrays)

    @staticmethod
    def load(path: str) -> "DeviceFst":
        z = np.load(path, allow_pickle=False)
        sc = z["__scalars__"]
        kw = dict(zip(DeviceFst._SCALARS, (int(x) for x in sc)))
        for k in z.files:
            if k != "__scalars__":
                kw[k] = z[k]
        return DeviceFst(**kw)
