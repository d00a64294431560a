"""CLG-on-the-fly batched beam search: decode CLG ⊗ HMM without HCLG.

Port of ``asr_decoder_tpu/ops/beamsearch_clg.py`` (ref: src/my-decoder/
online-clg-decoder-mempool-base.h:31-206 + clg-fst.h:9-189).  The composite
is walked as the uniform virtual automaton of the shared ``fst/clg.py``
(HMM entry and exit as ε hops), so each stage is the v2 shape: a padded
record-row read per token, flat ``[B, N]`` candidates, and the v2 relax
``_relax_and_prune`` of ``ops/beamsearch.py``:

  * emitting stage: only HMM virtual states expand; the arc row is found
    by table indirection, ``row = hmm_row_base[arcid] + hmmstate``, and
    destinations are arithmetic: self-loop → v, forward → v + offset
    (ref MapClgTokenStateId, clg-fst.h:146-151);
  * ε stage (E bounded sweeps, E = ``eps_iters`` or the composite's ε
    depth): CLG-resident tokens expand CLG ε arcs + HMM entry hops from one
    padded per-CLG-state record table; HMM-resident tokens get one exit
    lane (``dst = clg_dst[arcid]``, ref :140-144); plus the stay block.

Virtual ids stay in int32 (``offset·(H+2) < 2³¹`` is checked by
``ClgFst``); ``%`` and ``//`` only see ids ≥ 0, because ``_split_tokens``
substitutes ``offset`` for dead slots.  The acoustic-score lookup and every
backpointer gather go through ``batched_table_gather`` (the CUDA kernel of
``csrc/gather.cu`` on a GPU).  ``relax_impl`` and ``eps_mode`` are ignored,
as in the JAX class: the search always runs sweeps with the sort relax.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.clg import ClgFst
from asr_decoder_tpu_torch.fst.fst import EPSILON
from asr_decoder_tpu_torch.ops.beamsearch import (ARC_STAY, INF, NO_STATE,
                                                  BeamState, FrameLog,
                                                  _lane_iota, _np,
                                                  _relax_and_prune,
                                                  _split_fields, run_frames)
from asr_decoder_tpu_torch.ops.gather import (batched_table_gather,
                                              batched_table_gather_many)
from asr_decoder_tpu_torch.utils.profiling import scope

ARC_EXIT = -3   # log sentinel: HMM exit hop (no arc table entry)


class ClgGraphArrays(NamedTuple):
    clg_eps_rec: torch.Tensor  # i32[S_clg, 3·Ae] flat field-major rows:
                               #   dst_virtual | w-bits | eidx
    arc_tab: torch.Tensor      # i32[num_arcs+1, 2]: hmm_row_base | clg_dst
    hmm_em_rec: torch.Tensor   # i32[R, 3·Ah]: delta | pdf | w-bits
    hmm_exit: torch.Tensor     # i32[R, 2]: has_exit | w-bits
    start: int
    final_state: int


def make_clg_graph_arrays(g: ClgFst, ilabel2pdf: np.ndarray,
                          device: torch.device | str):
    """(device arrays on ``device``, host ``hmm_il[R, Ah]``: emitting lane
    → HMM ilabel): the JAX ``make_clg_graph_arrays`` tables."""
    clg = g.clg
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    S = clg.num_states
    offset = g.offset

    # --- per-CLG-state ε record rows (real ε + entry hops) ---------------
    # arc i of state s lands on lane (i - state_offset[s]); dst is the CLG
    # ε destination for real ε arcs, the virtual HMM-entry id otherwise
    deg = np.diff(clg.state_offset)
    Ae = max(int(deg.max()) if S else 0, 1)
    eps_rec = np.zeros((S, 3, Ae), np.int32)
    eps_rec[:, 0, :] = -1
    if clg.num_arcs:
        arc_i = np.arange(clg.num_arcs, dtype=np.int64)
        src = np.repeat(np.arange(S, dtype=np.int64), deg)
        lane = arc_i - clg.state_offset[:-1][src]
        is_real_eps = arc_i < clg.state_eps_end[src]
        dst = np.where(is_real_eps, clg.arc_dst.astype(np.int64),
                       arc_i + offset)
        eps_rec[src, 0, lane] = dst.astype(np.int32)
        eps_rec[src, 1, lane] = clg.arc_weight.astype(np.float32) \
            .view(np.int32)
        eps_rec[src, 2, lane] = arc_i.astype(np.int32)

    # --- HMM row block: the used HMMs concatenated -----------------------
    used = sorted(set(int(x) for x in clg.arc_ilabel[clg.arc_ilabel !=
                                                     EPSILON]))
    row_start = {}
    R = 0
    Ah = 1
    for il in used:
        row_start[il] = R
        h = g.hmms[il]
        R += h.num_states
        em_deg = (np.diff(h.state_offset) -
                  (h.state_eps_end - h.state_offset[:-1]))
        if len(em_deg):
            Ah = max(Ah, int(em_deg.max()))
    R = max(R, 1)
    hmm_em = np.zeros((R, 3, Ah), np.int32)
    hmm_em[:, 0, :] = -1
    hmm_il = np.zeros((R, Ah), np.int32)
    hmm_exit = np.zeros((R, 2), np.int32)
    for il in used:
        h = g.hmms[il]
        base = row_start[il]
        for s in range(h.num_states):
            r = base + s
            lo, hi = h.arc_range(s)
            lane = 0
            exit_w = np.inf
            for i in range(lo, hi):
                if int(h.arc_ilabel[i]) == EPSILON:
                    exit_w = min(exit_w, float(h.arc_weight[i]))
                    continue
                d = int(h.arc_dst[i])
                hmm_em[r, 0, lane] = 0 if d == s else 1
                hmm_em[r, 1, lane] = ilabel2pdf[int(h.arc_ilabel[i])]
                hmm_em[r, 2, lane] = np.float32(h.arc_weight[i]) \
                    .view(np.int32)
                hmm_il[r, lane] = h.arc_ilabel[i]
                lane += 1
            if np.isfinite(exit_w):
                hmm_exit[r, 0] = 1
                hmm_exit[r, 1] = np.float32(exit_w).view(np.int32)

    arc_tab = np.zeros((clg.num_arcs + 1, 2), np.int32)
    if clg.num_arcs:
        row_lut = np.zeros(int(clg.arc_ilabel.max()) + 1, np.int32)
        for il, r in row_start.items():
            row_lut[il] = r
        arc_tab[:-1, 0] = row_lut[clg.arc_ilabel]
        arc_tab[:-1, 1] = clg.arc_dst

    arrays = ClgGraphArrays(
        *(torch.from_numpy(a).to(device) for a in (
            eps_rec.reshape(S, 3 * Ae), arc_tab, hmm_em.reshape(R, 3 * Ah),
            hmm_exit)),
        start=int(clg.start), final_state=int(clg.final_state))
    return arrays, hmm_il


def _split_tokens(state, *, offset: int):
    """(valid, in_hmm bool[B,K], arcid i32[B,K], row-local hmm state
    i32[B,K])."""
    valid = state != NO_STATE
    in_hmm = valid & (state >= offset)
    v_safe = torch.where(in_hmm, state, offset)
    return valid, in_hmm, v_safe % offset, v_safe // offset - 1


def _emit_stage(g: ClgGraphArrays, state, cost, ll, *, cfg):
    """Emitting expansion from HMM virtual states: two-level indirection
    (arc → hmm row → arc lanes) replaces the reference's nested loops
    (ref online-clg-decoder-mempool-base.h:120-204)."""
    with scope("search/emit"):
        Ah, offset = cfg["Ah"], cfg["offset"]
        _, in_hmm, arcid, hs = _split_tokens(state, offset=offset)
        atab = g.arc_tab[arcid]                               # [B,K,2]
        row = torch.where(in_hmm, atab[:, :, 0] + hs, 0)
        delta, pdf, wbits = _split_fields(g.hmm_em_rec[row], 3)  # [B,K·Ah]
        amask = in_hmm.repeat_interleave(Ah, dim=1) & (delta >= 0)
        dstN = torch.where(amask, state.repeat_interleave(Ah, dim=1)
                           + delta * offset, 0)
        am = batched_table_gather(ll, torch.where(amask, pdf, 0))
        candN = torch.where(amask, cost.repeat_interleave(Ah, dim=1)
                            + wbits.view(torch.float32)
                            - cfg["acoustic_scale"] * am, INF)
        state, cost, win, keep = _relax_and_prune(
            dstN, candN, K=cfg["K"], beam=cfg["beam"],
            min_active=cfg["min_active"])
        prev = torch.where(keep, win // Ah, 0)
        rowN = row.repeat_interleave(Ah, dim=1)
        aid = torch.where(keep, batched_table_gather(rowN, win) * Ah
                          + win % Ah, ARC_STAY)
        return state, cost, prev, aid


def _eps_stage(g: ClgGraphArrays, state, cost, *, cfg):
    """One bounded ε sweep: CLG ε arcs + entry hops (CLG tokens), exit
    hops (HMM tokens), stay block."""
    K, Ae, offset = cfg["K"], cfg["Ae"], cfg["offset"]
    B = state.shape[0]
    dev = state.device
    valid, in_hmm, arcid, hs = _split_tokens(state, offset=offset)
    in_clg = valid & ~in_hmm
    dstE, wE, eidx = _split_fields(
        g.clg_eps_rec[torch.where(in_clg, state, 0)], 3)      # [B,K·Ae]
    emask = in_clg.repeat_interleave(Ae, dim=1) & (dstE >= 0)
    candE = torch.where(emask, cost.repeat_interleave(Ae, dim=1)
                        + wE.view(torch.float32), INF)
    dstE = torch.where(emask, dstE, 0)

    # exit lane per token
    atab = g.arc_tab[arcid]
    ex = g.hmm_exit[torch.where(in_hmm, atab[:, :, 0] + hs, 0)]  # [B,K,2]
    xmask = in_hmm & (ex[:, :, 0] > 0)
    dstX = torch.where(xmask, atab[:, :, 1], 0)
    candX = torch.where(xmask, cost + ex[:, :, 1].view(torch.float32), INF)

    slot = _lane_iota(K, dev).expand(B, K)
    srcE = _lane_iota(K * Ae, dev).expand(B, K * Ae) // Ae
    dst_all = torch.cat([dstE, dstX, torch.where(valid, state, 0)], dim=1)
    cand_all = torch.cat([candE, candX, torch.where(valid, cost, INF)],
                         dim=1)
    src_all = torch.cat([srcE, slot, slot], dim=1)
    aid_all = torch.cat(
        [eidx, torch.full((B, K), ARC_EXIT, dtype=torch.int32, device=dev),
         torch.full((B, K), ARC_STAY, dtype=torch.int32, device=dev)], dim=1)
    state, cost, win, keep = _relax_and_prune(
        dst_all, cand_all, K=K, beam=cfg["beam"],
        min_active=cfg["min_active"])
    prev, aid = batched_table_gather_many((src_all, aid_all), win)
    prev = torch.where(keep, prev, 0)
    aid = torch.where(keep, aid, ARC_STAY)
    return state, cost, prev, aid


def _eps_stages(g: ClgGraphArrays, state, cost, *, cfg):
    """E ε sweeps; logs (prev, aid) i32[E,B,K]."""
    with scope("search/eps"):
        prevs, aids = [], []
        for _ in range(cfg["E"]):
            state, cost, prev, aid = _eps_stage(g, state, cost, cfg=cfg)
            prevs.append(prev)
            aids.append(aid)
        if not prevs:
            B, K = state.shape
            empty = torch.zeros((0, B, K), dtype=torch.int32,
                                device=state.device)
            return state, cost, (empty, empty)
        return state, cost, (torch.stack(prevs), torch.stack(aids))


class TorchClgBeamSearch:
    """Batched CLG-composite beam search on one device — the ``clg`` graph
    type of the session layer (ref decoder selection,
    src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:250-284).  The surface
    of the JAX ``TpuClgBeamSearch``; the state is a ``BeamState`` and the
    logs are ``FrameLog``s (the JAX class's plain tuples, same leaves)."""

    def __init__(self, g: ClgFst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None, *,
                 device: torch.device | str):
        self.config = config or DecoderConfig()
        self.config.check()
        self._graphs: dict = {}   # frame runners by static key (run_frames)
        if self.config.gather_impl or self.config.fetch_impl:
            raise ValueError(
                "gather_impl/fetch_impl name TPU paths; in the PyTorch port "
                "the tensor's device picks the kernel — leave them empty")
        self.g = g
        self.device = torch.device(device)
        self.graph, self._hmm_il = make_clg_graph_arrays(g, ilabel2pdf,
                                                         self.device)
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
        Ah = int(self.graph.hmm_em_rec.shape[1]) // 3
        pdfs = _np(self.graph.hmm_em_rec[:, Ah:2 * Ah])
        self._pdf_max = int(pdfs.max()) if pdfs.size else -1
        eps_iters = self.config.eps_iters or g.eps_depth()
        K = min(self.config.beam_width, self.config.max_active)
        self._cfg = dict(
            K=K, Ah=Ah, Ae=int(self.graph.clg_eps_rec.shape[1]) // 3,
            E=eps_iters, offset=g.offset, beam=float(self.config.beam),
            min_active=int(self.config.min_active),
            acoustic_scale=float(self.config.acoustic_scale))
        self.beam_width = K
        self.num_stages = 1 + eps_iters

    @torch.inference_mode()
    def init_state(self, batch: int) -> tuple[BeamState, FrameLog]:
        K = self.beam_width
        state = torch.full((batch, K), NO_STATE, dtype=torch.int32,
                           device=self.device)
        cost = torch.full((batch, K), INF, dtype=torch.float32,
                          device=self.device)
        state[:, 0] = self.graph.start
        cost[:, 0] = 0.0
        state, cost, (prev, aid) = _eps_stages(self.graph, state, cost,
                                               cfg=self._cfg)
        return BeamState(state, cost), FrameLog(prev, aid, state, cost)

    @torch.inference_mode()
    def advance(self, state: BeamState, loglikes, frame_mask=None
                ) -> tuple[BeamState, FrameLog]:
        """loglikes f32[B,T,V], frame_mask bool[B,T]; logs prev/aid
        [T,S,B,K] and snapshots [T,B,K] ([T,B,0] with log_snapshots off)."""
        g, cfg = self.graph, self._cfg     # the cached runner keeps these

        def step(carry, ll):
            ns, nc, prev0, aid0 = _emit_stage(g, *carry, ll, cfg=cfg)
            ns, nc, (eprev, eaid) = _eps_stages(g, ns, nc, cfg=cfg)
            return ((ns, nc), torch.cat([prev0[None], eprev]),
                    torch.cat([aid0[None], eaid]))

        carry, prevs, aids, _, snaps = run_frames(
            step, tuple(state), loglikes, frame_mask, device=self.device,
            stages=self.num_stages, snapshots=self.config.log_snapshots,
            pdf_max=self._pdf_max, graphs=self._graphs)
        return BeamState(*carry), FrameLog(prevs, aids, *snaps)

    def decode(self, loglikes, frame_mask=None):
        state, init_log = self.init_state(len(loglikes))
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    def token_sets(self, init_log, logs, b: int,
                   num_frames: int | None = None) -> list[dict[int, float]]:
        """Per-frame surviving-token sets {virtual_state: cost} for
        utterance ``b`` (index 0 = post-init ε-closure)."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        toks_t, costs_t = _np(logs[2]), _np(logs[3])
        if num_frames is None:
            num_frames = toks_t.shape[0]
        snaps = [(_np(init_log[2])[b], _np(init_log[3])[b])]
        snaps += [(toks_t[t, b], costs_t[t, b]) for t in range(num_frames)]
        out = []
        for st, co in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict[int, float] = {}
            for s, c in zip(st[ok], co[ok]):
                s, c = int(s), float(c)
                if c < toks.get(s, np.inf):
                    toks[s] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log, logs, loglikes, frame_mask=None):
        """Raw lattices over the virtual composite (ilabels = HMM arc
        inputs, olabels = CLG words), reconstructed on the host by the
        shared ``decoder/raw_lattice.py`` (ref GetRawLattice,
        online-decoder-base-inl.h:869-977, inherited by the CLG decoder)."""
        from asr_decoder_tpu_torch.decoder.raw_lattice import (
            ClgExpander, lattice_from_token_sets_generic)
        loglikes = _np(loglikes)
        B, T = loglikes.shape[:2]
        lens = (_np(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        exp = ClgExpander(self.g)
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets_generic(
                    exp, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    def traceback(self, state, init_log, logs) -> list[dict]:
        """Best path per utterance: words from CLG arc olabels (ε/entry
        hops), ilabels from the emitting HMM arcs; no arc ids (the
        composite has no StdFst arcs).  ``logs``: one log or a list of
        per-chunk logs (walked without concatenation)."""
        tok_state, tok_cost = _np(state[0]), _np(state[1])
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(_np(c[0]), _np(c[1])) for c in chunks]
        iprev, iaid = _np(init_log[0]), _np(init_log[1])
        clg = self.g.clg
        final_id = int(clg.final_state)
        Ah = self._cfg["Ah"]
        results = []
        for b in range(tok_state.shape[0]):
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                slot = int(finals[np.argmin(tok_cost[b, finals])])
            else:
                slot = int(np.argmin(tok_cost[b]))
            total = float(tok_cost[b, slot])
            words_rev, il_rev = [], []

            def eat(stage: int, a: int):
                if a < 0:
                    return
                if stage == 0:      # emitting: a = hmm_row*Ah + lane
                    il = int(self._hmm_il[a // Ah, a % Ah])
                    if il:
                        il_rev.append(il)
                else:               # ε stage: a = CLG arc id
                    ol = int(clg.arc_olabel[a])
                    if ol:
                        words_rev.append(ol)

            for prevs, aids in reversed(chunks):
                for t in range(prevs.shape[0] - 1, -1, -1):
                    for s in range(prevs.shape[1] - 1, -1, -1):
                        eat(s, int(aids[t, s, b, slot]))
                        slot = int(prevs[t, s, b, slot])
            for s in range(iprev.shape[0] - 1, -1, -1):
                eat(s + 1, int(iaid[s, b, slot]))
                slot = int(iprev[s, b, slot])
            results.append(dict(words=words_rev[::-1], ilabels=il_rev[::-1],
                                cost=total, reached_final=bool(len(finals))))
        return results
