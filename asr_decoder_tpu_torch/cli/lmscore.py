"""Score text with an ARPA/FSA LM (ref: src/newlm/lmscore.cc,
compose-text.cc): reads ``<word> ...`` lines, prints per-line LM cost."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.lm.arpa import Fsa, read_arpa
from asr_decoder_tpu_torch.lm.compose import ArpaLmScore
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def load_lm(path: str) -> Fsa:
    with open(path, "rb") as f:
        head = f.read(16)
    if b"\\data\\" in head or head.lstrip()[:1] in (b"\\", b"#"):
        return read_arpa(path)
    return Fsa.read_binary(path)


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(usage="lmscore [options] <lm> [text-file|-]")
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if not 1 <= len(pos) <= 2:
        print(opts.usage(), file=sys.stderr)
        return 2
    scorer = ArpaLmScore(load_lm(pos[0]))
    src = sys.stdin if len(pos) == 1 or pos[1] == "-" else open(pos[1])
    for line in src:
        ws = line.split()
        if ws:
            print(f"{scorer.score_text(ws):.6f}\t{' '.join(ws)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
