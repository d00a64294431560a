"""Post-processing (rescore) service main
(ref: src/post-processing-service/asr-post-process-service.cc:28):
``post-serve [options] <lm2> [lm1]`` — lm1 enables replace mode."""

from __future__ import annotations

import sys

from asr_decoder_tpu_torch.cli.lmscore import load_lm
from asr_decoder_tpu_torch.serving.post_service import (ConstLmRescorer,
                                                        PostConfig,
                                                        run_post_server)
from asr_decoder_tpu_torch.utils.config import ConfigOptions


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(usage="post-serve [options] <lm2> [lm1]")
    cfg = PostConfig()
    cfg.register(opts)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if not 1 <= len(pos) <= 2:
        print(opts.usage(), file=sys.stderr)
        return 2
    lm2 = load_lm(pos[0])
    lm1 = load_lm(pos[1]) if len(pos) == 2 else None
    run_post_server(ConstLmRescorer(lm2, lm1), cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
