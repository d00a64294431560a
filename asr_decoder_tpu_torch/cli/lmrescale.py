"""Rescale every weight of a binary FSA LM (ref: src/newlm/lmrescale.cc —
used to pre-scale G₁ by −1 for difference-LM builds)."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.cli.lmscore import load_lm
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(usage="lmrescale --scale=S <in-lm> <out-fsa>")
    scale = {"v": 1.0}
    opts.register("scale", lambda: scale["v"],
                  lambda v: scale.__setitem__("v", v),
                  "Multiply all LM weights by this", float)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if len(pos) != 2:
        print(opts.usage(), file=sys.stderr)
        return 2
    load_lm(pos[0]).rescale(scale["v"]).write_binary(pos[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
