"""Streaming ASR service main (ref: src/v2-asrbin/v2-asr-service.cc:
``asr-service --config=conf.txt <nnet> <graph> <words.txt>``)::

    python -m asr_decoder_tpu_torch.cli.serve --device=cuda <nnet> <graph> <words.txt>
"""

from __future__ import annotations

import asyncio
import sys

from asr_decoder_tpu_torch.utils.config import ConfigOptions
from asr_decoder_tpu_torch.cli._model import build_info, register_info_flags
from asr_decoder_tpu_torch.serving.server import AsrServer, SocketConfig


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(
        usage="serve [options] <nnet-binary> <graph> <words.txt>")
    sock = SocketConfig()
    sock.register(opts)
    dec, online, fbank, am, extra = register_info_flags(opts)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    if len(pos) != 3:
        print(opts.usage(), file=sys.stderr)
        return 2
    info = build_info(pos[0], pos[1], pos[2], dec, online, fbank, am, extra,
                      device=extra["device"])
    asyncio.run(AsrServer(info, sock).serve_forever())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
