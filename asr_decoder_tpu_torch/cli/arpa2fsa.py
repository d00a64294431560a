"""ARPA text LM → binary FSA converter (ref: src/newlm/arpa2fsa-bin.cc)."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.fst.symbol import SymbolTable
from asr_decoder_tpu_torch.lm.arpa import read_arpa
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(usage="arpa2fsa [options] <arpa-text> <out-fsa>")
    words = {"v": ""}
    opts.register("words", lambda: words["v"],
                  lambda v: words.__setitem__("v", v),
                  "words.txt pinning word ids (default: ids assigned in "
                  "ARPA order)", str)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if len(pos) != 2:
        print(opts.usage(), file=sys.stderr)
        return 2
    word2id = None
    if words["v"]:
        word2id = dict(SymbolTable.read_text(words["v"]).items())
    fsa = read_arpa(pos[0], word2id=word2id)
    fsa.write_binary(pos[1])
    print(f"wrote {pos[1]}: {fsa.num_states} states {fsa.num_arcs} arcs",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
