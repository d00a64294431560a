"""BigLM in-search decoding: batched (fst_state, lm_state) pair beam search.

Port of ``asr_decoder_tpu/ops/beamsearch_biglm.py``, the reference's
flagship decoder variant ``OnlineLatticeDecoderMempoolBaseBiglm`` (ref:
src/my-decoder/online-decoder-mempool-base-biglm.h:12-574): every
word-olabel arc also advances a difference LM (lm2·G₂ − lm1·G₁,
``lm/device_lm.py``) and folds its score into the graph cost, so the big
LM shapes pruning.  Where the reference keys tokens by ``PairId =
fst_state | (lm_state << 32)`` (ref :77-90), the beam carries both LM
states as lanes (``tok_lm1``/``tok_lm2`` i32[B,K]) and the v2 relax merges
on (dst, lm1, lm2) through ``_relax_and_prune(extra_keys=...)``.

Word olabels are sparse, so with ``lm_lanes`` < N the word candidates are
compacted first: one stable sort by has-word (``torch.sort(stable=True)``,
then one ``batched_table_gather_many`` of all operands) brings them to the
front, the LMs are probed on the first ``lm_lanes`` lanes only, and the
relax consumes the permuted arrays (relaxation is order-free).  Word candidates
past the lanes are dropped (cost → INF) and the frame's ``overflow`` flag
is set — surfaced per utterance as ``overflowed``.  ε arcs can carry words
too (ref ProcessNonemitting :405-469), so the search always runs bounded ε
sweeps; ``relax_impl`` and ``eps_mode`` are ignored, as in JAX.  Final
costs add the difference LM's sentence-end cost in ``traceback`` (ref
ComputeFinalCosts :161-216).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
from asr_decoder_tpu_torch.lm.device_lm import DeviceDiffLm
from asr_decoder_tpu_torch.ops.beamsearch import (ARC_STAY, INF, NO_STATE,
                                                  _lane_iota, _np,
                                                  _pack_records,
                                                  _relax_and_prune, _rows,
                                                  run_frames)
from asr_decoder_tpu_torch.ops.gather import (batched_table_gather,
                                              batched_table_gather_many)
from asr_decoder_tpu_torch.utils.profiling import scope

LOG = logging.getLogger(__name__)


class BigLmGraphArrays(NamedTuple):
    em_rec: torch.Tensor    # i32[S, 5·A] flat field-major rows:
                            #   dst | pdf | w-bits | arcid | olabel
    eps_rec: torch.Tensor   # i32[S, 4·Ae]: dst | w-bits | eps-idx | olabel
    start: int
    final_state: int


class BigLmBeamState(NamedTuple):
    tok_state: torch.Tensor   # i32[B,K]
    tok_cost: torch.Tensor    # f32[B,K]
    tok_lm1: torch.Tensor     # i32[B,K]
    tok_lm2: torch.Tensor     # i32[B,K]


class BigLmFrameLog(NamedTuple):
    prev_slot: torch.Tensor   # i32[stages,B,K]  (advance: [T,stages,B,K])
    arc_id: torch.Tensor      # i32[stages,B,K]
    overflow: torch.Tensor    # bool[B] (advance: [T,B]) — word cands dropped
    # post-frame pair-token snapshots (zero-width with log_snapshots off)
    tok_state: torch.Tensor   # i32[B,K]  (advance: [T,B,K])
    tok_cost: torch.Tensor    # f32[B,K]
    tok_lm1: torch.Tensor     # i32[B,K]
    tok_lm2: torch.Tensor     # i32[B,K]


def make_biglm_graph_arrays(dev: DeviceFst, ilabel2pdf: np.ndarray,
                            device: torch.device | str) -> BigLmGraphArrays:
    """Padded record tables with the olabel field the pair search needs."""
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    A = max(dev.max_em_degree, 1)
    em_rec = _pack_records(dev.em_offset, dev.em_count, A, dev.em_dst,
                           ilabel2pdf[dev.em_ilabel], dev.em_weight,
                           np.arange(len(dev.em_dst), dtype=np.int32),
                           dev.em_olabel)
    if len(dev.eps_dst):
        eps_rec = _pack_records(
            dev.eps_offset, dev.eps_count, max(dev.max_eps_degree, 1),
            dev.eps_dst, dev.eps_weight,
            np.arange(len(dev.eps_dst), dtype=np.int32), dev.eps_olabel)
    else:
        eps_rec = np.zeros((dev.num_states, 0), np.int32)
    return BigLmGraphArrays(
        em_rec=torch.from_numpy(em_rec).to(device),
        eps_rec=torch.from_numpy(eps_rec).to(device),
        start=int(dev.start), final_state=int(dev.final_state))


def _apply_lm(difflm: DeviceDiffLm, ol, l1, l2, dst, cand, src, aid, *,
              lm_lanes: int):
    """Advance the diff LM (``DeviceDiffLm.advance``, the JAX
    ``_diff_advance``) on word candidates; returns (dst, cand, l1, l2, src,
    aid, overflow bool[B]) — permuted (word candidates first) when
    compaction is on (``lm_lanes`` < N).  ``overflow[b]``: some word
    candidate fell past the LM lanes and was dropped (cand → INF)."""
    B, N = ol.shape
    M = min(lm_lanes, N)
    is_word = (ol > 0) & torch.isfinite(cand)
    if M >= N:
        n1, n2, dc = difflm.advance(l1, l2, torch.where(is_word, ol, 0))
        cand = cand + torch.where(is_word, dc, 0.0)
        return (dst, cand, n1, n2, src, aid,
                torch.zeros((B,), dtype=torch.bool, device=ol.device))
    # the JAX one-key stable lax.sort over eight operands: a stable sort of
    # the key, then one gather of the seven other operands by its order
    key, order = torch.sort((~is_word).to(torch.int32), dim=1, stable=True)
    ol, l1, l2, dst, cand, src, aid = batched_table_gather_many(
        (ol, l1, l2, dst, cand, src, aid), order.to(torch.int32))
    overflow = key[:, M] == 0
    is_word_m = key[:, :M] == 0
    n1m, n2m, dcm = difflm.advance(l1[:, :M], l2[:, :M],
                                   torch.where(is_word_m, ol[:, :M], 0))
    l1 = torch.cat([n1m, l1[:, M:]], dim=1)
    l2 = torch.cat([n2m, l2[:, M:]], dim=1)
    dc = torch.cat([torch.where(is_word_m, dcm, 0.0),
                    torch.zeros((B, N - M), dtype=torch.float32,
                                device=ol.device)], dim=1)
    cand = cand + dc
    # drop the word candidates beyond the LM lanes
    dropped = (key == 0) & (_lane_iota(N, ol.device) >= M)
    cand = torch.where(dropped, INF, cand)
    return dst, cand, l1, l2, src, aid, overflow


def _relax_pair(dst, cand, l1, l2, src, aid, *, cfg):
    """Shared tail of both stages: min-merge on (dst, lm1, lm2), prune,
    gather the winners' backpointers."""
    state, cost, win, keep, l1k, l2k = _relax_and_prune(
        dst, cand, K=cfg["K"], beam=cfg["beam"],
        min_active=cfg["min_active"], extra_keys=(l1, l2))
    prev, aidk = batched_table_gather_many((src, aid), win)
    prev = torch.where(keep, prev, 0)
    aidk = torch.where(keep, aidk, ARC_STAY)
    return state, cost, l1k, l2k, prev, aidk


def _emit_stage(g: BigLmGraphArrays, difflm, state, cost, l1, l2, ll, *,
                cfg):
    """ProcessEmitting with per-word-arc LM advance
    (ref online-decoder-mempool-base-biglm.h:316-402)."""
    with scope("search/emit"):
        A = cfg["A"]
        B, K = state.shape
        valid = state != NO_STATE
        dstN, pdf, wbits, aidN, olN = _rows(g.em_rec, state, 5)  # [B,K·A]
        amask = valid.repeat_interleave(A, dim=1) & (dstN >= 0)
        am = batched_table_gather(ll, torch.where(amask, pdf, 0))
        candN = torch.where(amask, cost.repeat_interleave(A, dim=1)
                            + wbits.view(torch.float32)
                            - cfg["acoustic_scale"] * am, INF)
        srcN = _lane_iota(K * A, state.device).expand(B, K * A) // A
        dstN, candN, l1N, l2N, srcN, aidN, ovf = _apply_lm(
            difflm, torch.where(amask, olN, 0),
            l1.repeat_interleave(A, dim=1), l2.repeat_interleave(A, dim=1),
            torch.where(amask, dstN, 0), candN, srcN, aidN,
            lm_lanes=cfg["lm_lanes"])
        return (*_relax_pair(dstN, candN, l1N, l2N, srcN, aidN, cfg=cfg),
                ovf)


def _eps_stage(g: BigLmGraphArrays, difflm, state, cost, l1, l2, *, cfg):
    """One bounded ε sweep with LM advance on word-olabel ε arcs (ref
    ProcessNonemitting :405-469), plus a stay block."""
    B, K = state.shape
    L = g.eps_rec.shape[1] // 4
    dev = state.device
    valid = state != NO_STATE
    d, wbits, eidxN, olN = _rows(g.eps_rec, state, 4)        # [B,K·L]
    emask = valid.repeat_interleave(L, dim=1) & (d >= 0)
    candN = torch.where(emask, cost.repeat_interleave(L, dim=1)
                        + wbits.view(torch.float32), INF)
    srcN = _lane_iota(K * L, dev).expand(B, K * L) // L
    dN, candN, l1N, l2N, srcN, eidxN, ovf = _apply_lm(
        difflm, torch.where(emask, olN, 0), l1.repeat_interleave(L, dim=1),
        l2.repeat_interleave(L, dim=1), torch.where(emask, d, 0), candN,
        srcN, eidxN, lm_lanes=cfg["lm_lanes"])
    # stay block: each token unchanged (state, cost, LM lanes)
    slot = _lane_iota(K, dev).expand(B, K)
    return (*_relax_pair(
        torch.cat([dN, torch.where(valid, state, 0)], dim=1),
        torch.cat([candN, torch.where(valid, cost, INF)], dim=1),
        torch.cat([l1N, l1], dim=1), torch.cat([l2N, l2], dim=1),
        torch.cat([srcN, slot], dim=1),
        torch.cat([eidxN, torch.full((B, K), ARC_STAY, dtype=torch.int32,
                                     device=dev)], dim=1), cfg=cfg), ovf)


def _eps_stages(g, difflm, state, cost, l1, l2, *, cfg):
    """E ε sweeps; logs (prev, aid) i32[E,B,K] and the OR of their
    overflow flags."""
    with scope("search/eps"):
        B, K = state.shape
        prevs, aids = [], []
        ovf = torch.zeros((B,), dtype=torch.bool, device=state.device)
        for _ in range(cfg["E"]):
            state, cost, l1, l2, prev, aid, o = _eps_stage(
                g, difflm, state, cost, l1, l2, cfg=cfg)
            prevs.append(prev)
            aids.append(aid)
            ovf = ovf | o
        if prevs:
            log = (torch.stack(prevs), torch.stack(aids))
        else:
            empty = torch.zeros((0, B, K), dtype=torch.int32,
                                device=state.device)
            log = (empty, empty)
        return state, cost, l1, l2, log, ovf


class TorchBigLmBeamSearch:
    """Batched pair (fst × diff-LM) beam search on one device: the surface
    of the JAX ``TpuBigLmBeamSearch`` (ref decoder selection
    ``biglm-hclg``, src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:
    250-284).

    ``lm_lanes`` (DecoderConfig): compacted word-candidate lanes probed
    against the LMs per stage; ≥ K·A disables compaction (exact).
    """

    def __init__(self, dev: DeviceFst, ilabel2pdf: np.ndarray,
                 difflm: DeviceDiffLm, config: DecoderConfig | None = None,
                 *, device: torch.device | str):
        self.config = cfg = config or DecoderConfig()
        self._graphs: dict = {}   # frame runners by static key (run_frames)
        cfg.check()
        if cfg.gather_impl or cfg.fetch_impl:
            raise ValueError(
                "gather_impl/fetch_impl name TPU paths; in the PyTorch port "
                "the tensor's device picks the kernel — leave them empty")
        if dev.max_em_degree > cfg.arc_lanes:
            raise ValueError("graph not degree-bounded: rebuild DeviceFst "
                             "with arc_lanes")
        eps_iters = cfg.eps_iters or dev.eps_depth
        if eps_iters < 0:
            raise ValueError("epsilon-cyclic graph: BigLM search needs "
                             "bounded sweeps")
        self.dev = dev
        self.difflm = difflm
        self.device = torch.device(device)
        if difflm.lm1.table.device.type != self.device.type:
            raise ValueError(f"difflm tables on {difflm.lm1.table.device}, "
                             f"search on {self.device}")
        self.graph = make_biglm_graph_arrays(dev, ilabel2pdf, self.device)
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
        self._pdf_max = int(self._ilabel2pdf[dev.em_ilabel].max()) \
            if len(dev.em_ilabel) else -1
        K = min(cfg.beam_width, cfg.max_active)
        A = int(self.graph.em_rec.shape[1]) // 5
        # The LM compaction width against a graph-derived worst case: a
        # stage has at most K tokens × (max per-state word-arc out-degree)
        # word candidates; lm_lanes at or above that bound never drops one
        # (the reference never drops, ref :316-402).  Undersized lanes stay
        # legal (a speed/exactness trade) but are loud here, and per-
        # utterance drops surface as ``overflowed`` in traceback results.
        wdeg = 0
        for count, olabel in ((dev.em_count, dev.em_olabel),
                              (dev.eps_count, dev.eps_olabel)):
            src = np.repeat(np.arange(dev.num_states), count)
            if len(src) and (olabel > 0).any():
                wdeg = max(wdeg, int(np.bincount(src[olabel > 0]).max()))
        self.lm_lanes_bound = min(K * max(wdeg, 1), K * A)
        if cfg.lm_lanes < self.lm_lanes_bound:
            LOG.warning(
                "biglm: lm_lanes=%d < worst-case word candidates %d "
                "(K=%d × max word out-degree %d): overflowing word "
                "candidates will be DROPPED from the search; raise "
                "DecoderConfig.lm_lanes to ≥%d for exactness",
                cfg.lm_lanes, self.lm_lanes_bound, K, max(wdeg, 1),
                self.lm_lanes_bound)
        self._cfg = dict(K=K, A=A, E=eps_iters, beam=float(cfg.beam),
                         min_active=int(cfg.min_active),
                         acoustic_scale=float(cfg.acoustic_scale),
                         lm_lanes=int(cfg.lm_lanes))
        self.beam_width = K
        self.num_stages = 1 + eps_iters

    @torch.inference_mode()
    def init_state(self, batch: int) -> tuple[BigLmBeamState, BigLmFrameLog]:
        K = self.beam_width
        d = self.device
        state = torch.full((batch, K), NO_STATE, dtype=torch.int32, device=d)
        cost = torch.full((batch, K), INF, dtype=torch.float32, device=d)
        l1 = torch.zeros((batch, K), dtype=torch.int32, device=d)
        l2 = torch.zeros((batch, K), dtype=torch.int32, device=d)
        state[:, 0] = self.graph.start
        cost[:, 0] = 0.0
        l1[:, 0] = self.difflm.lm1.start
        l2[:, 0] = self.difflm.lm2.start
        state, cost, l1, l2, (prev, aid), ovf = _eps_stages(
            self.graph, self.difflm, state, cost, l1, l2, cfg=self._cfg)
        return (BigLmBeamState(state, cost, l1, l2),
                BigLmFrameLog(prev, aid, ovf, state, cost, l1, l2))

    @torch.inference_mode()
    def advance(self, state: BigLmBeamState, loglikes, frame_mask=None
                ) -> tuple[BigLmBeamState, BigLmFrameLog]:
        """loglikes f32[B,T,V], frame_mask bool[B,T]; logs prev/aid
        [T,S,B,K], overflow [T,B], snapshots [T,B,K] ([T,B,0] with
        log_snapshots off)."""
        g, lm, cfg = self.graph, self.difflm, self._cfg

        def step(carry, ll):
            *new, prev0, aid0, ovf0 = _emit_stage(g, lm, *carry, ll,
                                                  cfg=cfg)
            *new, (eprev, eaid), ovfe = _eps_stages(g, lm, *new, cfg=cfg)
            return (tuple(new), torch.cat([prev0[None], eprev]),
                    torch.cat([aid0[None], eaid]), ovf0 | ovfe)

        carry, prevs, aids, (ovf,), snaps = run_frames(
            step, tuple(state), loglikes, frame_mask, device=self.device,
            stages=self.num_stages, snapshots=self.config.log_snapshots,
            pdf_max=self._pdf_max, graphs=self._graphs, flags=1)
        return (BigLmBeamState(*carry),
                BigLmFrameLog(prevs, aids, ovf, *snaps))

    def decode(self, loglikes, frame_mask=None):
        state, init_log = self.init_state(len(loglikes))
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    def token_sets(self, init_log: BigLmFrameLog, logs: BigLmFrameLog,
                   b: int, num_frames: int | None = None) -> list[dict]:
        """Per-frame surviving pair-token sets {(orig_fst_state, lm1, lm2):
        cost} for utterance ``b`` (index 0 = post-init ε-closure); split
        continuation states fold back to their source state."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        orig = self.dev.orig_state
        lanes = [_np(x) for x in (logs.tok_state, logs.tok_cost,
                                  logs.tok_lm1, logs.tok_lm2)]
        if num_frames is None:
            num_frames = lanes[0].shape[0]
        snaps = [tuple(_np(x)[b] for x in (init_log.tok_state,
                                           init_log.tok_cost,
                                           init_log.tok_lm1,
                                           init_log.tok_lm2))]
        snaps += [tuple(x[t, b] for x in lanes) for t in range(num_frames)]
        out = []
        for st, co, l1, l2 in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict = {}
            for s, c, a, bb in zip(orig[st[ok]], co[ok], l1[ok], l2[ok]):
                key = (int(s), int(a), int(bb))
                c = float(c)
                if c < toks.get(key, np.inf):
                    toks[key] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log: BigLmFrameLog, logs: BigLmFrameLog,
                     loglikes, fst, frame_mask=None):
        """Raw lattices over the pair automaton: HCLG arcs with the
        difference-LM score folded into graph costs, the LM sentence-end
        cost as final weights (ref GetRawLattice inherited by the biglm
        decoder, online-decoder-mempool-base-biglm.h + base-inl.h:869)."""
        from asr_decoder_tpu_torch.decoder.raw_lattice import (
            BigLmExpander, lattice_from_token_sets_generic)
        lm1, lm2 = self.difflm.lm1.fsa, self.difflm.lm2.fsa
        s1, s2 = self.difflm.lm1_scale, self.difflm.lm2_scale

        def lm_advance(l1_, l2_, w):
            n1, c1 = lm1.get_arc(l1_, w)
            n2, c2 = lm2.get_arc(l2_, w)
            return n1, n2, s2 * c2 - s1 * c1

        exp = BigLmExpander(fst, lm_advance, self.difflm.final_host)
        loglikes = _np(loglikes)
        B, T = loglikes.shape[:2]
        lens = (_np(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets_generic(
                    exp, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    def _decode_stage_arcs(self, stage: int, a: int) -> list[int]:
        if a < 0:
            return []
        if stage == 0:
            return [int(self.dev.em_arcid[a])]
        aid = int(self.dev.eps_arcid[a])
        return [aid] if aid >= 0 else []

    def traceback(self, state: BigLmBeamState, init_log: BigLmFrameLog,
                  logs, fst_arcs=None) -> list[dict]:
        """Best path per utterance; the final-token choice includes the
        diff LM's sentence-end cost (ref ComputeFinalCosts,
        online-decoder-mempool-base-biglm.h:161-216).  ``logs``: one
        BigLmFrameLog or a list of per-chunk logs.  ``fst_arcs``: the
        source StdFst for words/ilabels (None: arc ids and cost only)."""
        tok_state, tok_cost, tok_l1, tok_l2 = (_np(x) for x in state)
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(_np(c.prev_slot), _np(c.arc_id), _np(c.overflow))
                  for c in chunks]
        iprev, iaid = _np(init_log.prev_slot), _np(init_log.arc_id)
        final_id = int(self.dev.final_state)
        results = []
        for b in range(tok_state.shape[0]):
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                fc = np.array([
                    tok_cost[b, k] + self.difflm.final_host(
                        int(tok_l1[b, k]), int(tok_l2[b, k]))
                    for k in finals])
                slot = int(finals[np.argmin(fc)])
                total = float(fc.min())
            else:
                slot = int(np.argmin(tok_cost[b]))
                total = float(tok_cost[b, slot])
            arcs_rev: list[int] = []
            for prevs, aids, _ in reversed(chunks):
                for t in range(prevs.shape[0] - 1, -1, -1):
                    for s in range(prevs.shape[1] - 1, -1, -1):
                        arcs_rev.extend(self._decode_stage_arcs(
                            s, int(aids[t, s, b, slot])))
                        slot = int(prevs[t, s, b, slot])
            for s in range(iprev.shape[0] - 1, -1, -1):
                arcs_rev.extend(self._decode_stage_arcs(
                    s + 1, int(iaid[s, b, slot])))
                slot = int(iprev[s, b, slot])
            arc_ids = arcs_rev[::-1]
            res = dict(arc_ids=arc_ids, cost=total,
                       reached_final=bool(len(finals)),
                       overflowed=any(bool(ov[:, b].any())
                                      for _, _, ov in chunks))
            if fst_arcs is not None:
                ol = fst_arcs.arc_olabel[arc_ids]
                il = fst_arcs.arc_ilabel[arc_ids]
                res["words"] = [int(x) for x in ol[ol != 0]]
                res["ilabels"] = [int(x) for x in il[il != 0]]
            results.append(res)
        return results
