"""Tool dispatcher: ``python -m asr_decoder_tpu_torch <tool> [args]``
(the reference ships ~20 standalone bins, SURVEY §2.9; here one package
entry point fans out to the same surface)."""

from __future__ import annotations

import sys

TOOLS = {
    "serve": ("asr_decoder_tpu_torch.cli.serve", "streaming ASR TCP service"),
    "post-serve": ("asr_decoder_tpu_torch.cli.post_serve",
                   "second-pass rescore service"),
    "decode": ("asr_decoder_tpu_torch.cli.decode", "offline decode + RTF/WER"),
    "arpa2fsa": ("asr_decoder_tpu_torch.cli.arpa2fsa", "ARPA → binary FSA"),
    "convert-graph": ("asr_decoder_tpu_torch.cli.convert_graph",
                      "OpenFST → custom graph binary / hmm bundle"),
    "lmscore": ("asr_decoder_tpu_torch.cli.lmscore", "score text with an LM"),
    "lmrescale": ("asr_decoder_tpu_torch.cli.lmrescale", "rescale LM weights"),
    "lat-compose": ("asr_decoder_tpu_torch.cli.lat_compose",
                    "lattice ⊗ LM rescoring"),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m asr_decoder_tpu_torch <tool> [args]\n\ntools:")
        for name, (_, doc) in TOOLS.items():
            print(f"  {name:15s} {doc}")
        return 0 if len(sys.argv) >= 2 else 2
    tool = sys.argv[1]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r} (try --help)", file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(TOOLS[tool][0])
    return mod.main(sys.argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
