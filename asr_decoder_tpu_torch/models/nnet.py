"""Acoustic model container + posterior pipeline (the decodable).

Port of ``asr_decoder_tpu/models/nnet.py`` (ref: src/nnet/nnet-nnet.h:17-308,
nnet-nnet.cc): the ordered layer stack, the reference's raw binary model
format (``u32 nlayer`` then per layer ``i32 in, i32 out, i32 type`` + raw
float blobs, ref: nnet-nnet.cc:15-35, nnet-component.cc:66-101) — byte for
byte the format the JAX package reads and writes — and the posterior
post-processing of ``am_forward``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.utils.cuda_graphs import (GraphRunner, copy_into,
                                                     static_buffers,
                                                     static_key)
from asr_decoder_tpu_torch.models.layers import (ID_KINDS, KIND_IDS, Layer,
                                                 make_layer)

# log-prob above which a CTC blank frame is skippable
# (ref: SkipBlockFrame threshold 20, nnet-nnet.h:265-275; saturation constant
#  2.71828e30 whose log ≈ 70, nnet-nnet.cc:149)
BLANK_SATURATE = 2.71828e30
BLANK_SKIP_LOGPROB = 20.0


@dataclass
class AmConfig:
    """ref: NnetForwardOptions (nnet-nnet.h:63-87)."""
    skip: int = flag(0, "Frame-subsampling factor minus one (skip frames)")
    skip_copy: bool = flag(False, "Copy scores to skipped frames so the "
                                  "search still walks every input frame "
                                  "(ref _skip score copy, nnet-nnet.cc:"
                                  "93-116); False drops skipped frames")
    do_log: bool = flag(True, "Transform NN output by log()")
    sub_prior: bool = flag(True, "Subtract log prior (last layer must be Prior)")
    do_softmax: bool = flag(True, "Apply the final softmax layer")
    block_scale: float = flag(1.0, "CTC blank posterior scale")
    skip_block: float = flag(1.0, "Saturate blank posteriors above this")
    acoustic_scale: float = flag(1.0, "Scaling factor for acoustic likelihoods")
    block_pdf_pdfid: int = flag(-1, "CTC blank output row; -1 = no blank")
    skip_blank_frames: bool = flag(
        False, "CTC blank-skip: frames whose blank logprob exceeds the "
               "skip threshold are masked out of the search (tokens carry "
               "unchanged) — the best-path fast path of the reference's "
               "SkipBlockFrame (ref nnet-nnet.h:265-275); lattice output "
               "is unavailable in this mode")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class Nnet(nn.Module):
    """Ordered layer stack + model IO."""

    def __init__(self, layers: list[Layer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @property
    def input_dim(self) -> int:
        return self.layers[0].input_dim if len(self.layers) else 0

    @property
    def output_dim(self) -> int:
        return self.layers[-1].output_dim if len(self.layers) else 0

    def context(self) -> tuple[int, int]:
        """(left, right) context of the first splice layer
        (ref: NnetForward::GetLRoffset, nnet-nnet.cc:73-88)."""
        for l in self.layers:
            if l.kind == "splice":
                return -min(l.meta), max(l.meta)
        return 0, 0

    def init_state(self, batch: int, device=None):
        return [l.init_state(batch, device) for l in self.layers]

    # ------------------------------------------------------------------
    # reference raw-binary model format
    # ------------------------------------------------------------------
    @staticmethod
    def read_binary(path: str, device="cuda") -> "Nnet":
        layers: list[Layer] = []
        with open(path, "rb") as f:
            (nlayer,) = struct.unpack("<I", f.read(4))
            while True:
                hdr = f.read(12)
                if len(hdr) < 12:
                    break
                din, dout, typ = struct.unpack("<3i", hdr)
                kind = ID_KINDS.get(typ)
                if kind is None:
                    raise IOError(f"unknown component type 0x{typ:x}")
                layers.append(_read_layer_blob(f, kind, din, dout))
        if nlayer != len(layers):
            raise IOError(f"expected {nlayer} layers, read {len(layers)}")
        return Nnet(layers).to(device)

    def write_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<I", len(self.layers)))
            for l in self.layers:
                f.write(struct.pack("<3i", l.input_dim, l.output_dim,
                                    KIND_IDS[l.kind]))
                _write_layer_blob(f, l)


def from_numpy_layers(layers, device="cuda") -> Nnet:
    """Build the port's Nnet from ``(kind, input_dim, output_dim, meta,
    {name: ndarray})`` tuples — what a JAX ``Nnet`` yields as
    ``[(l.kind, l.input_dim, l.output_dim, l.meta, {k: np.asarray(v) for
    k, v in l.params.items()}) for l in nnet.layers]``."""
    return Nnet([make_layer(kind, din, dout,
                            {k: torch.from_numpy(np.array(v, np.float32))
                             for k, v in params.items()}, meta)
                 for kind, din, dout, meta, params in layers]).to(device)


def to_numpy_layers(nnet: Nnet) -> list:
    """The inverse of ``from_numpy_layers``: the same tuples, the weights as
    host float32 arrays (copies, detached from any graph)."""
    return [(l.kind, l.input_dim, l.output_dim, l.meta,
             {k: v.detach().cpu().numpy().copy() for k, v in l.params.items()})
            for l in nnet.layers]


def _f32(f, n) -> np.ndarray:
    a = np.fromfile(f, "<f4", n)
    if len(a) != n:
        raise IOError("truncated model blob")
    return a


# blob field order per kind (ref nnet-component.cc readers); shapes are
# filled from (din, dout, H) when read
_BLOB_FIELDS = {
    "add_shift": ("shift",),
    "rescale": ("scale",),
    "prior": ("log_priors",),
    "affine": ("bias", "weight"),
    "linear": ("weight",),
    "softmax": (),
    "sigmoid": (),
    "lstm": ("w_gifo_x", "w_gifo_m", "bias", "phole_i", "phole_f",
             "phole_o"),
    "tf_lstm": ("w_gifo_x", "w_gifo_m", "bias"),
    "lstm_projected": ("w_gifo_x", "w_gifo_r", "bias", "phole_i", "phole_f",
                       "phole_o", "w_r_m"),
    "sru": ("w_xfrh", "bias_f", "bias_r"),
}


def _blob_shapes(kind: str, din: int, dout: int, H: int) -> dict:
    return {
        "shift": (din,), "scale": (din,), "log_priors": (din,),
        "bias": (dout,) if kind == "affine" else (4 * H,),
        "weight": (dout, din),
        "w_gifo_x": (4 * H, din), "w_gifo_m": (4 * H, H),
        "w_gifo_r": (4 * H, dout), "w_r_m": (dout, H),
        "phole_i": (H,), "phole_f": (H,), "phole_o": (H,),
        "w_xfrh": (4 * dout, din), "bias_f": (dout,), "bias_r": (dout,),
    }


def _read_layer_blob(f, kind: str, din: int, dout: int) -> Layer:
    if kind == "splice":
        offs = np.fromfile(f, "<i4", dout // din)
        return make_layer("splice", din, dout,
                          meta=tuple(int(o) for o in offs))
    if kind == "lstm_cudnn":
        kind = "lstm"
    H = dout
    if kind == "lstm_projected":
        (H,) = struct.unpack("<i", f.read(4))
    shapes = _blob_shapes(kind, din, dout, H)
    params = {}
    for name in _BLOB_FIELDS[kind]:
        shape = shapes[name]
        params[name] = torch.from_numpy(
            _f32(f, int(np.prod(shape))).reshape(shape).copy())
    return make_layer(kind, din, dout, params)


def _write_layer_blob(f, l: Layer) -> None:
    if l.kind == "splice":
        np.asarray(l.meta, "<i4").tofile(f)
        return
    kind = "lstm" if l.kind == "lstm_cudnn" else l.kind
    if kind not in _BLOB_FIELDS:
        raise IOError(f"no blob writer for {l.kind}")
    if kind == "lstm_projected":
        f.write(struct.pack("<i", l.w_r_m.shape[1]))
    for name in _BLOB_FIELDS[kind]:
        getattr(l, name).detach().cpu().numpy().astype("<f4").tofile(f)


# ----------------------------------------------------------------------
# the decodable: forward + posterior pipeline
# ----------------------------------------------------------------------

def am_forward(layers, x: torch.Tensor, state, *, do_softmax=True,
               do_log=True, sub_prior=True, block_pdf_pdfid=-1,
               block_scale=1.0, skip_block=1.0, skip=0, skip_copy=False):
    """x f32[B,T,D] → log-likelihood rows f32[B,T',V], with streaming state.

    Mirrors NnetForward::FeedForward (ref: nnet-nnet.cc:89-168): run layers
    (stopping before Prior; before Softmax too when do_softmax=False), blank
    scale/saturate, log, prior subtraction; frame subsampling runs the net
    on every (1+skip)-th input frame (ref: nnet-nnet.cc:93-116).  With
    ``skip_copy`` the computed rows are copied onto the skipped frames so
    T' == T; without it skipped frames are dropped (T' = ceil(T/(1+skip))).
    The acoustic scale is NOT applied here (the search applies it, ref
    LogLikelihood nnet-nnet.h:212-233).
    """
    T_in = x.shape[1]
    if skip:
        x = x[:, ::1 + skip]
    new_state = []
    for i, layer in enumerate(layers):
        if layer.kind == "prior":
            break
        if layer.kind == "softmax" and not do_softmax:
            break
        x, st = layer(x, state[i])
        new_state.append(st)
    new_state.extend(state[len(new_state):])
    if do_softmax and do_log:
        if block_pdf_pdfid >= 0:
            x = x.clone()
            blank = x[..., block_pdf_pdfid] * block_scale
            x[..., block_pdf_pdfid] = torch.where(
                blank / (block_scale + 1e-8) > skip_block,
                torch.full_like(blank, BLANK_SATURATE), blank)
        x = torch.log(x)
        if sub_prior:
            last = layers[-1]
            if last.kind == "prior":
                x, _ = last(x, {})
    if skip and skip_copy:
        x = torch.repeat_interleave(x, 1 + skip, dim=1)[:, :T_in]
    return x, new_state


class GraphedAm:
    """``am_forward`` over one layer list, one captured CUDA graph for each
    static key (``utils/cuda_graphs.py``): the device, the shapes and
    dtypes of the input and the streaming state, and the keyword flags —
    as the JAX AM is
    jitted by shapes and static arguments.  The input and the carries go
    in through the runner's static buffers; the log-likelihoods and the new
    state come out as fresh tensors, so nothing a caller keeps is
    overwritten by the next call.  Runs only without autograd (training
    calls ``am_forward``)."""

    def __init__(self, layers):
        self.layers = list(layers)
        self._runners: dict = {}

    def _runner(self, x, state, flags) -> GraphRunner:
        key = (str(x.device), static_key((x, state)),
               tuple(sorted(flags.items())))
        run = self._runners.get(key)
        if run is None:
            layers = self.layers    # not self: no cycle keeps a dropped AM
            run = self._runners[key] = GraphRunner(
                lambda b: am_forward(layers, *b, **flags),
                static_buffers((x, state), x.device), x.device)
        return run

    def __call__(self, x: torch.Tensor, state, **flags):
        run = self._runner(x, state, flags)
        with run.lock:
            copy_into(run.buffers, (x, state))
            y, new = run()
            return y.clone(), [{k: v.clone() for k, v in st.items()}
                               for st in new]


def blank_frame_mask(loglikes: torch.Tensor, block_pdf_pdfid: int,
                     acoustic_scale: float = 1.0) -> torch.Tensor:
    """True where the frame is a skippable CTC blank: the reference
    compares the acoustically scaled blank score with the threshold
    (ref: SkipBlockFrame, nnet-nnet.h:265-275; scale at nnet-nnet.h:231)."""
    return acoustic_scale * loglikes[..., block_pdf_pdfid] > BLANK_SKIP_LOGPROB


def pack_nonblank_frames(loglikes: torch.Tensor, block_pdf_pdfid: int,
                         acoustic_scale: float = 1.0,
                         thresh: float | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop skippable blank-dominated frames and left-pack the rest.

    ``loglikes`` f32[B, T, V] → (packed f32[B, T', V], mask bool[B, T'])
    on the input's device, with T' = max per-utterance kept count (at least
    1) — the batched analogue of the reference's SkipBlockFrame frame
    skipping (ref: nnet-nnet.h:265-275): skipped frames never reach the
    search at all, so decode cost scales with the non-blank frame count.
    ``thresh`` overrides the default unnormalized-score threshold (use
    ≈ log(0.95) for log-softmax posteriors).  Kept rows are copied, never
    computed; rows past an utterance's count are zero.  Reading T' is the
    one host synchronisation.
    """
    cut = BLANK_SKIP_LOGPROB if thresh is None else thresh
    keep = ~(acoustic_scale * loglikes[..., block_pdf_pdfid] > cut)
    counts = keep.sum(dim=1)
    Tp = max(int(counts.max()), 1)
    # a stable sort of the dropped flag lists the kept frames first, in order
    order = torch.sort((~keep).to(torch.uint8), dim=1,
                       stable=True).indices[:, :Tp]
    mask = torch.arange(Tp, device=loglikes.device)[None, :] < counts[:, None]
    rows = torch.gather(
        loglikes, 1, order[..., None].expand(-1, -1, loglikes.shape[-1]))
    return torch.where(mask[..., None], rows, torch.zeros_like(rows)), mask
