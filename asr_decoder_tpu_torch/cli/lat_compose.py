"""Lattice ⊗ LM rescoring tool (ref: src/newlm/lat-compose.cc:16-36):
compose a binary lattice with one LM (add) or a difference LM (replace),
print the n-best word-id sequences."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.cli.lmscore import load_lm
from asr_decoder_tpu_torch.fst.lattice import Lattice
from asr_decoder_tpu_torch.fst.nbest import nshortest
from asr_decoder_tpu_torch.lm.compose import (ComposeArpaLm, DiffArpaLm,
                                        compose_lattice)
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(
        usage="lat-compose [options] <lattice> <lm2> [lm1]\n"
              "  with lm1: difference rescore lm2-lm1 (ref lat-compose.cc)")
    cfg = {"scale": 1.0, "nbest": 1, "out": ""}
    opts.register("scale", lambda: cfg["scale"],
                  lambda v: cfg.__setitem__("scale", v), "LM scale", float)
    opts.register("nbest", lambda: cfg["nbest"],
                  lambda v: cfg.__setitem__("nbest", v),
                  "Print this many best paths", int)
    opts.register("out", lambda: cfg["out"],
                  lambda v: cfg.__setitem__("out", v),
                  "Also write the rescored lattice here", str)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if not 2 <= len(pos) <= 3:
        print(opts.usage(), file=sys.stderr)
        return 2
    lat = Lattice.read_binary(pos[0])
    if len(pos) == 3:
        lm = DiffArpaLm(load_lm(pos[2]), load_lm(pos[1]),
                        lm1_scale=cfg["scale"], lm2_scale=cfg["scale"])
    else:
        lm = ComposeArpaLm(load_lm(pos[1]), cfg["scale"])
    res = compose_lattice(lat, lm)
    if cfg["out"]:
        res.write_binary(cfg["out"])
    for p in nshortest(res, cfg["nbest"]):
        words = [str(a.olabel) for a in p.arcs if a.olabel != 0]
        print(f"{p.graph_cost + p.am_cost:.4f}\t{' '.join(words)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
