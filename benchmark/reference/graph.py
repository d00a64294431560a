"""The graph side of the reference: an arc index over the raw arcs with
the super-final rewrite (each final state gets an epsilon arc carrying its
final weight into one added state, id ``num_states``), the judge of a
decoded path, an exact Viterbi search (no beam, no width cut) that
stands in for the program in the control, and the gap by which an
answered path lies above the exact best cost.

A path is judged from what the program reports, as arc tuples (src, dst,
ilabel, olabel, weight): it must leave the start state, be connected,
use only arcs of the graph, take one emitting arc a decoded frame, end in
the super-final state when the program says it reached it, and carry the
words the program answered.  Its cost is summed again in float64: the
graph weights plus, for the emitting arc of frame t, minus the reference's
own log-likelihood of the arc's AM row at t.  That sum is then held
against the least cost of any path of the graph over the same frames
(``best_costs``): a search that prunes the best path away answers a valid
path and a true cost, and only this gap shows it."""

from __future__ import annotations

import numpy as np
import torch


class ArcIndex:
    def __init__(self, g):
        S = g.num_states
        fs = np.array(sorted(g.finals), np.int64)
        fw = np.array([g.finals[s] for s in fs], np.float32)
        src = np.concatenate([g.src, fs])
        self.dst = np.concatenate([g.dst, np.full(len(fs), S, np.int64)])
        self.il = np.concatenate([g.ilabel, np.zeros(len(fs), np.int32)])
        self.ol = np.concatenate([g.olabel, np.zeros(len(fs), np.int32)])
        self.w = np.concatenate([g.weight, fw])
        order = np.argsort(src, kind="stable")
        self.src = src[order]
        self.dst, self.il, self.ol, self.w = (a[order] for a in (
            self.dst, self.il, self.ol, self.w))
        self.off = np.searchsorted(self.src, np.arange(S + 2))
        self.num_states = S + 1
        self.start = g.start
        self.superfinal = S
        self.i2p = np.asarray(g.ilabel2pdf, np.int64)

    def find(self, s: int, d: int, i: int, o: int, w: float) -> int:
        """Index of the arc (s, d, i, o) of weight w, or -1."""
        if not 0 <= s < self.num_states:
            return -1
        lo, hi = self.off[s], self.off[s + 1]
        hit = np.flatnonzero((self.dst[lo:hi] == d) & (self.il[lo:hi] == i)
                             & (self.ol[lo:hi] == o)
                             & (self.w[lo:hi] == np.float32(w)))
        return int(lo + hit[0]) if len(hit) else -1


def judge_path(idx: ArcIndex, arcs, frames: int, loglikes: np.ndarray,
               words, cost: float, reached_final: bool
               ) -> tuple[list, float, float]:
    """(faults, cost gap, the path's cost) of one decoded path.  ``arcs`` [(src, dst,
    ilabel, olabel, weight)]; ``frames`` the frames the search consumed;
    ``loglikes`` the reference's f32[>= frames, V]; ``words`` the answered
    word ids; ``cost`` the program's.  The gap is |cost - the reference's
    sum| over max(1, |the sum|); faults name what is wrong; the path's
    cost is the reference's sum."""
    faults = []
    total = 0.0
    t = 0
    prev = idx.start
    for k, (s, d, i, o, w) in enumerate(arcs):
        if s != prev:
            faults.append(f"arc {k} leaves {s}, the path is at {prev}")
            break
        a = idx.find(s, d, i, o, w)
        if a < 0:
            faults.append(f"arc {k} {(s, d, i, o, w)} is not in the graph")
            break
        total += float(idx.w[a])
        if i != 0:
            if t >= frames:
                faults.append(f"more emitting arcs than {frames} frames")
                break
            total -= float(loglikes[t, idx.i2p[i]])
            t += 1
        prev = d
    else:
        if t != frames:
            faults.append(f"{t} emitting arcs for {frames} frames")
        if reached_final and prev != idx.superfinal:
            faults.append(f"said to reach the final state, ends in {prev}")
    olabels = [int(a[3]) for a in arcs if a[3] != 0]
    if list(words) != olabels:
        faults.append(f"answered words {list(words)[:8]}... are not the "
                      f"path's {olabels[:8]}...")
    gap = abs(float(cost) - total) / max(1.0, abs(total))
    return faults, (gap if not faults else float("inf")), total


@torch.no_grad()
def best_costs(idx: ArcIndex, rows: list, device, block: int = 16,
               eps_rounds: int = 64, prune: tuple | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """The exact least costs over whole utterances, ``block`` rows at a
    time on ``device``: every state, every arc, every frame, float32
    costs.  ``rows``: f32/f64[T_r, V] log-likelihoods.  Returns, a row,
    the least cost of a path that ends in the super-final state (inf
    where none does) and the least cost of one that ends in any other
    state after the last frame.  With ``prune`` (beam, K, min_active) it
    is a plain beam search instead: after the emitting arcs of a frame
    and again after their epsilon arcs only the states within ``beam`` of
    the best survive, the best K at most and the best ``min_active``
    always."""
    src = torch.from_numpy(idx.src).to(device)
    dst = torch.from_numpy(idx.dst).to(device)
    w = torch.from_numpy(idx.w.astype(np.float32)).to(device)
    il = torch.from_numpy(idx.il.astype(np.int64)).to(device)
    em = il != 0
    e_src, e_dst, e_w = src[em], dst[em], w[em]
    e_row = torch.from_numpy(idx.i2p).to(device)[il[em]]
    x_src, x_dst, x_w = src[~em], dst[~em], w[~em]
    S = idx.num_states
    to_final, elsewhere = [], []
    for lo in range(0, len(rows), block):
        part = rows[lo:lo + block]
        R, T = len(part), max(len(r) for r in part)
        ll = torch.zeros((R, T, part[0].shape[1]), dtype=torch.float32)
        for r, x in enumerate(part):
            ll[r, :len(x)] = torch.from_numpy(np.asarray(x, np.float32))
        ll = ll.to(device)
        lens = torch.tensor([len(x) for x in part], device=device)
        xi, ei = x_dst.expand(R, -1), e_dst.expand(R, -1)

        def cut(cost):
            if prune is None:
                return cost
            beam, K, least = prune
            ranked = cost.topk(min(K, S), dim=1, largest=False).values
            lim = torch.minimum(ranked[:, :1] + beam, ranked[:, -1:])
            lim = torch.maximum(lim, ranked[:, min(least, K) - 1:][:, :1])
            return torch.where(cost <= lim, cost, float("inf"))

        def closure(cost):
            for _ in range(eps_rounds):
                new = cost.scatter_reduce(1, xi, cost[:, x_src] + x_w, "amin")
                if not bool((new < cost).any()):
                    return cut(cost)
                cost = new
            raise RuntimeError("epsilon closure did not converge")

        cost = torch.full((R, S), float("inf"), device=device)
        cost[:, idx.start] = 0.0
        cost = closure(cost)
        for t in range(T):
            cand = cost[:, e_src] + e_w - ll[:, t, e_row]
            new = torch.full_like(cost, float("inf")).scatter_reduce(
                1, ei, cand, "amin")
            cost = torch.where((t < lens)[:, None], closure(cut(new)), cost)
        to_final.append(cost[:, idx.superfinal].cpu())
        elsewhere.append(cost[:, :idx.superfinal].amin(1).cpu())
    if not rows:
        return np.zeros(0), np.zeros(0)
    return (torch.cat(to_final).double().numpy(),
            torch.cat(elsewhere).double().numpy())


def search_gap(idx: ArcIndex, answered: list, device,
               prune: tuple | None = None) -> float:
    """How far the answered paths lie above the best ones, over all of
    ``answered`` [(log-likelihoods [T, V], the answered path's cost by
    ``judge_path``, whether it reached the final state)]: the sum of each
    answered cost less the least cost of a path that ends as it does (in
    the super-final state, or anywhere else), over the sum of those least
    costs' magnitudes.  The least costs are the exact ones, or with
    ``prune`` (beam, K, min_active) those of a plain beam search of that
    beam and width (``best_costs``).  A search that keeps the best path
    (the one its beam and width keep) reads about 0; one that prunes it
    away more often, or further, reads more.  0 where nothing was
    answered; inf where no path that ends as an answered one does is
    found."""
    if not answered:
        return 0.0
    fin, other = best_costs(idx, [a[0] for a in answered], device,
                            prune=prune)
    excess = scale = 0.0
    for (_, total, reached), f, o in zip(answered, fin, other):
        least = f if reached else o
        if not np.isfinite(least):
            return float("inf")
        excess += total - least
        scale += abs(least)
    return excess / max(1.0, scale)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


@torch.no_grad()
def viterbi(idx: ArcIndex, loglikes: torch.Tensor, precision: str = "fp32",
            eps_rounds: int = 32) -> tuple[list, float, bool]:
    """Exact best path over the whole graph for one utterance's
    log-likelihoods f32[T, V]: every state, every arc, every frame, on
    the log-likelihoods' device.  Returns (arc tuples, cost, reached the
    super-final state).  ``precision`` "bf16" rounds every cost it forms
    to bfloat16 (the control of a search whose costs are float32)."""
    dev = loglikes.device
    S = idx.num_states
    src = torch.from_numpy(idx.src).to(dev)
    dst = torch.from_numpy(idx.dst).to(dev)
    w = torch.from_numpy(idx.w.astype(np.float32)).to(dev)
    il = torch.from_numpy(idx.il.astype(np.int64)).to(dev)
    em = il != 0
    e_src, e_dst, e_w = src[em], dst[em], w[em]
    e_row = torch.from_numpy(idx.i2p).to(dev)[il[em]]
    e_id = torch.nonzero(em).squeeze(1)
    x_src, x_dst, x_w = src[~em], dst[~em], w[~em]
    x_id = torch.nonzero(~em).squeeze(1)
    T = loglikes.shape[0]
    ll = _round(loglikes.float(), precision)
    back_em = torch.full((T, S), -1, dtype=torch.int64, device=dev)
    back_eps = []

    def closure(cost):
        """Relax the epsilon arcs until nothing improves; returns the cost
        and, per state, the epsilon arc that last improved it (-1 none)."""
        bp = torch.full((S,), -1, dtype=torch.int64, device=dev)
        for _ in range(eps_rounds):
            cand = _round(cost[x_src] + x_w, precision)
            new = cost.scatter_reduce(0, x_dst, cand, "amin")
            better = new < cost
            if not bool(better.any()):
                return cost, bp
            win = better[x_dst] & (cand == new[x_dst])
            bp[x_dst[win]] = x_id[win]
            cost = new
        raise RuntimeError("epsilon closure did not converge")

    cost = torch.full((S,), float("inf"), device=dev)
    cost[idx.start] = 0.0
    cost, bp = closure(cost)
    back_eps.append(bp)
    for t in range(T):
        cand = _round(cost[e_src] + e_w - ll[t, e_row], precision)
        new = torch.full((S,), float("inf"), device=dev).scatter_reduce(
            0, e_dst, cand, "amin")
        win = torch.isfinite(cand) & (cand == new[e_dst])
        back_em[t, e_dst[win]] = e_id[win]
        cost, bp = closure(new)
        back_eps.append(bp)
    final = idx.superfinal
    if torch.isfinite(cost[final]):
        end, reached = final, True
    else:
        end, reached = int(torch.argmin(cost)), False
    total = float(cost[end])
    # walk back: epsilon arcs of a frame, then its emitting arc
    arcs = []
    s = end
    be, bx = back_em, back_eps          # read an entry at a time
    for t in range(T, -1, -1):
        seen = 0
        while int(bx[t][s]) >= 0:
            a = int(bx[t][s])
            arcs.append(a)
            s = int(idx.src[a])
            seen += 1
            if seen > S:
                raise RuntimeError("epsilon back-pointers loop")
        if t == 0:
            break
        a = int(be[t - 1][s])
        arcs.append(a)
        s = int(idx.src[a])
    arcs.reverse()
    tuples = [(int(idx.src[a]), int(idx.dst[a]), int(idx.il[a]),
               int(idx.ol[a]), float(idx.w[a])) for a in arcs]
    return tuples, total, reached
