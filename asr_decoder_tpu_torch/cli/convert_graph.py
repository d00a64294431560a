"""OpenFST → custom decode-graph binary converter
(ref: src/fst_format_convert_tool/convert_fst.c, convert_hmm.c)."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.cli._model import load_graph
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(
        usage="convert-graph [options] <in-fst> <out-fst>\n"
              "  or (hmm bundle, ref convert_hmm.c):\n"
              "convert-graph --hmm-list=LIST <out-hmm-bundle>")
    hmm = {"v": ""}
    opts.register("hmm-list", lambda: hmm["v"],
                  lambda v: hmm.__setitem__("v", v),
                  "File listing per-phone HMM fst paths (one per line, "
                  "line i+1 = ilabel i+1)", str)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if hmm["v"]:
        if len(pos) != 1:
            print(opts.usage(), file=sys.stderr)
            return 2
        from asr_decoder_tpu_torch.fst.clg import write_hmm_bundle
        with open(hmm["v"]) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        hmms = [None] + [load_graph(p) for p in paths]
        write_hmm_bundle(pos[0], hmms)
        print(f"wrote {pos[0]}: {len(paths)} hmms", file=sys.stderr)
        return 0
    if len(pos) != 2:
        print(opts.usage(), file=sys.stderr)
        return 2
    fst = load_graph(pos[0])
    fst.write_binary(pos[1])
    print(f"wrote {pos[1]}: {fst.num_states} states {fst.num_arcs} arcs",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
