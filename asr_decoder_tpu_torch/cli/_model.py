"""Shared model/graph loading for the CLI mains (the OnlineDecoderInfo
construction of OnlineDecoderConf + OnlineDecoderInfo, ref:
src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:22-231).  Port of
``asr_decoder_tpu/cli/_model.py``: the same flags (``--hmmfst-file`` loads
a ``clg`` graph) plus ``--device``.  Like the JAX loader it builds no
BigLM: a ``biglm-hclg`` info is made with ``OnlineDecoderInfo(difflm=...)``."""

from __future__ import annotations

import struct

import numpy as np
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.clg import ClgFst
from asr_decoder_tpu_torch.fst.fst import StdFst
from asr_decoder_tpu_torch.fst.symbol import SymbolTable
from asr_decoder_tpu_torch.utils.config import ConfigOptions
from asr_decoder_tpu_torch.frontend.fbank import FbankConfig
from asr_decoder_tpu_torch.models.nnet import AmConfig, Nnet
from asr_decoder_tpu_torch.serving.session import (OnlineDecoderConfig,
                                                   OnlineDecoderInfo)


def register_info_flags(opts: ConfigOptions):
    """Register the session flag surface; returns the config objects and
    ``extra`` (``trans-model``, ``hmmfst-file``, ``device``)."""
    dec = DecoderConfig()
    online = OnlineDecoderConfig()
    fbank = FbankConfig()
    am = AmConfig()
    dec.register(opts)
    online.register(opts)
    fbank.register(opts, "fbank")
    am.register(opts, "am")
    extra = {"trans-model": "", "hmmfst-file": "", "device": "cuda"}
    opts.register("trans-model",
                  lambda: extra["trans-model"],
                  lambda v: extra.__setitem__("trans-model", v),
                  "Kaldi transition model (ilabel→pdf map); empty = "
                  "identity/CTC mapping", str)
    opts.register("hmmfst-file",
                  lambda: extra["hmmfst-file"],
                  lambda v: extra.__setitem__("hmmfst-file", v),
                  "HMM bundle for graph-type=clg (ref --hmmfst-file)", str)
    opts.register("device",
                  lambda: extra["device"],
                  lambda v: extra.__setitem__("device", v),
                  "Torch device for the AM and the search (cuda, cuda:N, "
                  "cpu)", str)
    return dec, online, fbank, am, extra


def load_graph(path: str) -> StdFst:
    """Custom binary or OpenFST ConstFst/VectorFst, sniffed by magic."""
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) == 4 and struct.unpack("<i", head)[0] == 2125659606:
        return StdFst.read_openfst_const(path)
    return StdFst.read_binary(path)


def build_info(am_path: str, graph_path: str, words_path: str,
               dec, online, fbank, am, extra, *,
               device: str) -> OnlineDecoderInfo:
    # fp32 products stay fp32 on the card (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nnet = Nnet.read_binary(am_path, device=device)
    words = SymbolTable.read_text(words_path)
    kw = {}
    if online.graph_type == "clg":
        # the graph file is the CLG layer; the HMMs come from the bundle
        if not extra.get("hmmfst-file"):
            raise ValueError("--hmmfst-file is required for graph-type=clg")
        kw["clg_graph"] = ClgFst.load(graph_path, extra["hmmfst-file"])
        fst = None
    else:
        fst = load_graph(graph_path)
    if extra["trans-model"]:
        from asr_decoder_tpu_torch.models.transition import TransitionModel
        tm = TransitionModel.read(extra["trans-model"])
        i2p = tm.ilabel_map(ctc_blank_shift=online.ctc_blank_shift)
    else:
        # identity / CTC ilabel-1 mapping (ref nnet-nnet.h:212-233)
        n = nnet.output_dim
        if online.ctc_blank_shift:
            i2p = np.concatenate([[0], np.arange(n, dtype=np.int64)])
        else:
            i2p = np.arange(n + 1, dtype=np.int64)
    return OnlineDecoderInfo(nnet, fst, words, i2p, decoder_config=dec,
                             online_config=online, fbank_config=fbank,
                             am_config=am, device=device, **kw)
