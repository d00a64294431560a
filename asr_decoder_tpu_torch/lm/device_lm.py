"""Device-resident ARPA n-gram LM for in-search (BigLM) rescoring.

Port of ``asr_decoder_tpu/lm/device_lm.py`` (ref: the per-arc LM queries of
``ProcessEmitting``, src/my-decoder/online-decoder-mempool-base-biglm.h:
316-402, calling ``DiffArpaLm::GetArc`` → ``Fsa::GetArc``).  The host
``Fsa`` (shared ``asr_decoder_tpu/lm/arpa.py``) becomes the same three
dense tables as in JAX, built by the same numpy code and then moved to an
explicit device:

  * an open-addressing hash over all non-root arcs, rows
    ``i32[H, 4] = (key_state | key_word | dst | weight-bits)``, linear
    probing bounded by the longest cluster found at build time;
  * a dense unigram row ``i32[Vmax+2, 2] = (dst | weight-bits)``;
  * backoff rows ``i32[S, 2] = (dst | weight-bits)``.

``lm_get_arc_tables`` answers any batch of (state, word) queries with a
static number of row gathers — ``levels`` backoff iterations, each with
``max_probes`` hash probes — unrolled to those Python-int bounds and never
cut short on a hit (deciding that would need a device→host sync).  The
hash relies on int32 wraparound, which torch's int32 ``*`` and ``>>``
(arithmetic) give on the CPU and on CUDA as XLA does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.lm.arpa import Fsa

UNSEEN_PENALTY = 100.0   # host Fsa.get_arc parity (lm/arpa.py)

# Knuth multiplicative hashing constants (i32 wraparound is intended)
_H1 = -1640531527        # 2654435761 as signed i32
_H2 = 40503


def _hash2(s, w, mask):
    """The JAX ``_hash2`` on int32 tensors or (for the table build) numpy
    int32 arrays: the same bits, overflow wrapping."""
    h = (s * _H1) ^ (w * _H2)
    h = h ^ (h >> 15)
    return (h * _H1 >> 8) & mask


@dataclass
class DeviceNgramLm:
    """Device tables for one ARPA Fsa + the static probe/level bounds."""

    table: torch.Tensor      # i32[H, 4]: key_state | key_word | dst | w_bits
    uni: torch.Tensor        # i32[Vmax+2, 2]: dst | w_bits (root arcs, dense)
    backoff: torch.Tensor    # i32[S, 2]: dst | w_bits
    start: int
    root: int                # the unigram (empty-context) state
    levels: int              # backoff chase iterations (max chain length + 1)
    max_probes: int          # longest linear-probe cluster
    mask: int                # hash size - 1
    fsa: Fsa                 # host copy (final costs, tests)

    @staticmethod
    def build(fsa: Fsa, device: torch.device | str) -> "DeviceNgramLm":
        """The JAX ``DeviceNgramLm.build`` tables, on ``device``."""
        S = fsa.num_states
        root = fsa.unigram
        counts = np.diff(fsa.offset)

        # --- dense unigram row ------------------------------------------
        lo, hi = int(fsa.offset[root]), int(fsa.offset[root + 1])
        vmax = int(fsa.arc_word.max()) if fsa.num_arcs else 0
        uni = np.empty((vmax + 2, 2), np.int32)
        uni[:, 0] = root
        uni[:, 1] = np.float32(UNSEEN_PENALTY).view(np.int32)
        uw = fsa.arc_word[lo:hi]
        uni[uw, 0] = fsa.arc_dst[lo:hi]
        uni[uw, 1] = fsa.arc_weight[lo:hi].view(np.int32)

        # --- hash over all non-root arcs ---------------------------------
        nr_states = np.repeat(np.arange(S, dtype=np.int32),
                              counts.astype(np.int64))
        keep = nr_states != root
        ks = nr_states[keep]
        kw = fsa.arc_word[keep].astype(np.int32)
        kd = fsa.arc_dst[keep].astype(np.int32)
        kv = fsa.arc_weight[keep].view(np.int32)
        n = len(ks)
        H = 1 << max(int(np.ceil(np.log2(max(2 * n, 16)))), 4)
        mask = H - 1
        table = np.full((H, 4), -1, np.int32)
        with np.errstate(over="ignore"):
            h = _hash2(ks, kw, np.int32(mask)).astype(np.int64)
        # vectorized linear-probe insertion in rounds: each round places
        # the first pending entry of every free slot, the rest step +1
        pend = np.arange(n)
        probes = 0
        while len(pend):
            probes += 1
            hp = h[pend]
            order = np.argsort(hp, kind="stable")
            hp_s = hp[order]
            first = np.ones(len(order), bool)
            first[1:] = hp_s[1:] != hp_s[:-1]
            cand = pend[order[first]]
            placed = cand[table[h[cand], 0] == -1]
            table[h[placed]] = np.stack(
                [ks[placed], kw[placed], kd[placed], kv[placed]], axis=1)
            placed_set = np.zeros(n, bool)
            placed_set[placed] = True
            pend = pend[~placed_set[pend]]
            h[pend] = (h[pend] + 1) & mask
        # an entry placed in round r is found in r lookup probes
        max_probes = probes

        # --- backoff rows --------------------------------------------------
        backoff = np.empty((S, 2), np.int32)
        backoff[:, 0] = fsa.backoff_dst
        backoff[:, 1] = fsa.backoff_w.view(np.int32)

        # levels = longest backoff chain + 1 (root gets resolved in-level)
        depth = np.zeros(S, np.int64)
        bd = fsa.backoff_dst.astype(np.int64)
        cur = bd.copy()
        lvl = 1
        while True:
            live = cur >= 0
            if not live.any():
                break
            depth[live] = lvl
            cur[live] = bd[cur[live]]
            lvl += 1
            if lvl > S + 2:
                raise ValueError("backoff cycle in Fsa")
        levels = int(depth.max()) + 1

        def dev(a):
            return torch.from_numpy(a).to(device)
        return DeviceNgramLm(
            table=dev(table), uni=dev(uni), backoff=dev(backoff),
            start=int(fsa.start), root=int(root), levels=levels,
            max_probes=int(max_probes), mask=mask, fsa=fsa)

    def final_host(self, s: int) -> float:
        return self.fsa.final(s)


def lm_get_arc_tables(table, uni, backoff, s, w, *, mask: int, levels: int,
                      max_probes: int):
    """Vectorized ``Fsa.get_arc``: (next_state i32, cost f32) of emitting
    word ``w`` from context state ``s`` (i32 tensors of one shape, on the
    tables' device); ``w <= 0`` (ε / backoff label) keeps the state at zero
    cost — ``NextLmState``'s olabel==0 short-circuit
    (ref online-decoder-mempool-base-biglm.h:55-62).  ``levels ×
    max_probes`` row probes, unrolled."""
    shape = s.shape
    s = s.reshape(-1)
    w = w.reshape(-1)
    cost = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    done = w <= 0
    dst = s
    # the unigram row depends on w alone: read it once for every level
    urow = uni[w.clamp(0, uni.shape[0] - 1)]                     # [Q,2]
    for _ in range(levels):
        # root: direct unigram lookup (covers the unseen +100 stay case)
        root_hit = (backoff[s, 0] < 0) & ~done
        dst = torch.where(root_hit, urow[:, 0], dst)
        cost = cost + torch.where(root_hit, urow[:, 1].view(torch.float32),
                                  0.0)
        done = done | root_hit
        # non-root: bounded linear hash probe
        h = _hash2(s, w, mask)
        found = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        hdst = torch.zeros_like(s)
        hw = torch.zeros_like(cost)
        for _p in range(max_probes):
            row = table[h]                                        # [Q,4]
            m = (row[:, 0] == s) & (row[:, 1] == w) & ~found
            hdst = torch.where(m, row[:, 2], hdst)
            hw = torch.where(m, row[:, 3].view(torch.float32), hw)
            found = found | m
            h = (h + 1) & mask
        ok = found & ~done
        dst = torch.where(ok, hdst, dst)
        cost = cost + torch.where(ok, hw, 0.0)
        done = done | ok
        # miss: chase the backoff arc
        miss = ~done
        brow = backoff[s]
        cost = cost + torch.where(miss, brow[:, 1].view(torch.float32), 0.0)
        s = torch.where(miss, brow[:, 0], s)
    return dst.reshape(shape), cost.reshape(shape)


def lm_get_arc(lm: DeviceNgramLm, s, w):
    """``lm_get_arc_tables`` with the bounds taken from a DeviceNgramLm."""
    return lm_get_arc_tables(lm.table, lm.uni, lm.backoff, s, w,
                             mask=lm.mask, levels=lm.levels,
                             max_probes=lm.max_probes)


@dataclass
class DeviceDiffLm:
    """Difference LM (lm2·G₂ − lm1·G₁) over two device n-gram LMs — the
    in-search analogue of ``DiffArpaLm`` (ref: src/newlm/diff-lm.h:13-122).
    The search carries both component states as beam lanes and merges on
    the (fst, lm1, lm2) key."""

    lm1: DeviceNgramLm
    lm2: DeviceNgramLm
    lm1_scale: float = 1.0
    lm2_scale: float = 1.0

    @staticmethod
    def build(fsa1: Fsa, fsa2: Fsa, lm1_scale: float = 1.0,
              lm2_scale: float = 1.0, *,
              device: torch.device | str) -> "DeviceDiffLm":
        return DeviceDiffLm(DeviceNgramLm.build(fsa1, device),
                            DeviceNgramLm.build(fsa2, device),
                            lm1_scale, lm2_scale)

    @property
    def start(self) -> tuple[int, int]:
        return self.lm1.start, self.lm2.start

    def advance(self, s1, s2, w):
        """(next1, next2, cost) for word batch ``w`` (≤0 ⇒ no-op)."""
        n1, c1 = lm_get_arc(self.lm1, s1, w)
        n2, c2 = lm_get_arc(self.lm2, s2, w)
        return n1, n2, self.lm2_scale * c2 - self.lm1_scale * c1

    def final_host(self, s1: int, s2: int) -> float:
        """Sentence-final cost (ref ComputeFinalCosts adding
        ``_diff_lm.Final``, online-decoder-mempool-base-biglm.h:161-216)."""
        return (self.lm2_scale * self.lm2.final_host(s2)
                - self.lm1_scale * self.lm1.final_host(s1))
