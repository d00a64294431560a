"""Acoustic model container + posterior pipeline (the decodable).

Port of ``asr_decoder_tpu/models/nnet.py`` (ref: src/nnet/nnet-nnet.h:17-308,
nnet-nnet.cc): the ordered layer stack, the reference's raw binary model
format (``u32 nlayer`` then per layer ``i32 in, i32 out, i32 type`` + raw
float blobs, ref: nnet-nnet.cc:15-35, nnet-component.cc:66-101) — byte for
byte the format the JAX package reads and writes — and the posterior
post-processing of ``am_forward``.

Counters (this process, the calls of every ``GraphedAm`` given per-row
lengths, from the host's lengths and the output's shape: nothing is read
back from the card): ``frames_out`` padded output frames, ``frames_real``
the rows' output frames, ``attn_pairs`` Σ T'_b² over rows, the query-key
pairs of a full-context attention layer a head.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.utils.cuda_graphs import (GraphRunner, copy_into,
                                                     static_buffers,
                                                     static_key)
from asr_decoder_tpu_torch.utils.profiling import span
from asr_decoder_tpu_torch.models import layers as L
from asr_decoder_tpu_torch.models.layers import (ID_KINDS, KIND_IDS, Layer,
                                                 make_layer)

# log-prob above which a CTC blank frame is skippable
# (ref: SkipBlockFrame threshold 20, nnet-nnet.h:265-275; saturation constant
#  2.71828e30 whose log ≈ 70, nnet-nnet.cc:149)
BLANK_SATURATE = 2.71828e30
BLANK_SKIP_LOGPROB = 20.0

# GraphedAm's counters (module docstring); callers read differences
frames_out = 0
frames_real = 0
attn_pairs = 0
_counters_lock = threading.Lock()


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

    @property
    def streaming(self) -> bool:
        """Whether the AM can run chunk by chunk (the served path): False
        once a layer reads the whole utterance."""
        return all(l.streaming for l in self.layers)

    def output_lengths(self, lengths, skip: int = 0):
        """Output frames of rows of ``lengths`` input frames (integer numpy
        array or tensor), through ``am_forward`` with ``skip``."""
        return output_lengths(self.layers, lengths, skip)

    @classmethod
    def conformer(cls, config: dict, seed: int, device="cuda") -> "Nnet":
        """A full-context Conformer AM with seeded weights: conv2d_subsample
        (``feat_dim`` → ``d_model``), ``blocks`` conformer blocks
        (``heads``, ``conv_kernel``, ``ffn_dim``), affine to ``num_pdfs``,
        softmax and a uniform prior (``benchmark/configs/conformer_l.json``
        has these keys under ``am``)."""
        gen = torch.Generator().manual_seed(seed)
        d, V = config["d_model"], config["num_pdfs"]
        layers = [L.make_conv2d_subsample(gen, config["feat_dim"], d)]
        layers += [L.make_conformer(gen, d, config["heads"],
                                    config["conv_kernel"], config["ffn_dim"])
                   for _ in range(config["blocks"])]
        layers += [L.make_affine(gen, d, V), L.make_softmax(V),
                   L.make_prior(np.ones(V))]
        return cls(layers).to(device)

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


def require_streaming(nnet: Nnet, user: str) -> None:
    """Raise for an AM that cannot run chunk by chunk (``Nnet.streaming``
    False): ``user`` would decode it wrongly."""
    if not nnet.streaming:
        kinds = sorted({l.kind for l in nnet.layers if not l.streaming})
        raise ValueError(
            f"{user} streams its AM chunk by chunk, but this AM's "
            f"{', '.join(kinds)} layers read the whole utterance: decode it "
            f"offline (GraphedAm with lengths, then TorchBeamSearch.advance "
            f"with the output lengths' frame mask)")


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
# the port's own kinds: a conformer blob opens with i32 heads, kernel and
# ffn width (its ``meta``), then each weight of ``layers.conformer_shapes``
# in order; a conv2d_subsample blob is ``layers.subsample_shapes``' weights
_PORT_SHAPES = {
    "conv2d_subsample": lambda din, dout, meta: L.subsample_shapes(din, dout),
    "conformer": lambda din, dout, meta: L.conformer_shapes(dout, *meta),
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
    if kind in _PORT_SHAPES:
        meta = (tuple(int(v) for v in np.fromfile(f, "<i4", 3))
                if kind == "conformer" else ())
        params = {name: torch.from_numpy(
                      _f32(f, int(np.prod(shape))).reshape(shape).copy())
                  for name, shape in _PORT_SHAPES[kind](din, dout,
                                                        meta).items()}
        return make_layer(kind, din, dout, params, meta)
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
    if l.kind in _PORT_SHAPES:
        if l.kind == "conformer":
            np.asarray(l.meta, "<i4").tofile(f)
        for name in _PORT_SHAPES[l.kind](l.input_dim, l.output_dim, l.meta):
            getattr(l, name).detach().cpu().numpy().astype("<f4").tofile(f)
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

def output_lengths(layers, lengths, skip: int = 0):
    """Rows of ``lengths`` input frames → their output frames through
    ``am_forward`` (``skip`` without ``skip_copy``)."""
    if skip:
        lengths = (lengths + skip) // (1 + skip)
    for layer in layers:
        if getattr(layer, "takes_lengths", False):
            lengths = layer.out_lengths(lengths)
    return lengths


def am_forward(layers, x: torch.Tensor, state, *, lengths=None,
               do_softmax=True, do_log=True, sub_prior=True,
               block_pdf_pdfid=-1, block_scale=1.0, skip_block=1.0, skip=0,
               skip_copy=False):
    """x f32[B,T,D] → log-likelihood rows f32[B,T',V], with streaming state.

    Mirrors NnetForward::FeedForward (ref: nnet-nnet.cc:89-168): run layers
    (stopping before Prior; before Softmax too when do_softmax=False), blank
    scale/saturate, log, prior subtraction; frame subsampling runs the net
    on every (1+skip)-th input frame (ref: nnet-nnet.cc:93-116).  With
    ``skip_copy`` the computed rows are copied onto the skipped frames so
    T' == T; without it skipped frames are dropped (T' = ceil(T/(1+skip))).
    The acoustic scale is NOT applied here (the search applies it, ref
    LogLikelihood nnet-nnet.h:212-233).

    ``lengths`` i64[B] (on ``x``'s device): the real input frames of each
    row of a padded batch.  The layers that take lengths (the only ones
    that may change the frame count) keep the padding out of each row's
    real output frames, and the call returns ``(x, state, output
    lengths)``; a row's real frames then equal the same row run alone.
    Without it every row is whole and the call returns ``(x, state)``.
    Layers of other types (``parallel/mesh.py``'s wrappers) count as
    kinds that take no lengths.
    """
    T_in = x.shape[1]
    if lengths is not None and skip and skip_copy:
        raise ValueError("lengths are not carried through skip_copy")
    if skip:
        x = x[:, ::1 + skip]
        if lengths is not None:
            lengths = (lengths + skip) // (1 + skip)
    new_state = []
    for i, layer in enumerate(layers):
        if layer.kind == "prior":
            break
        if layer.kind == "softmax" and not do_softmax:
            break
        if getattr(layer, "takes_lengths", False):
            x, st = layer(x, state[i], lengths)
            if lengths is not None:
                lengths = layer.out_lengths(lengths)
        else:
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
    if lengths is not None:
        return x, new_state, lengths
    return x, new_state


class GraphedAm:
    """``am_forward`` over one layer list, one captured CUDA graph for each
    static key (``utils/cuda_graphs.py``): the device, the shapes and
    dtypes of the input, the streaming state and the lengths, and the
    keyword flags — as the JAX AM is
    jitted by shapes and static arguments.  The input, the carries and the
    lengths go in through the runner's static buffers, so a padded length
    has one capture whatever its rows' lengths; the log-likelihoods and the
    new state come out as fresh tensors, so nothing a caller keeps is
    overwritten by the next call.  Runs only without autograd (training
    calls ``am_forward``).

    The captures of one ``GraphedAm`` share one memory pool (otherwise
    each keeps a pool at its own peak: a full-context AM over long padded
    batches needs ~15 GB a shape): safe because a call holds
    ``lock`` from its copy in to its outputs' clones, on the caller's one
    stream (as every runner's replays are), so no capture's outputs are
    read after another's replay.  Each call is the span
    ``am/forward``; a call with lengths adds to the module's counters."""

    def __init__(self, layers):
        self.layers = list(layers)
        self._runners: dict = {}
        self._pools: dict = {}
        self.lock = threading.Lock()

    def _runner(self, bufs, flags) -> GraphRunner:
        x = bufs[0]
        key = (str(x.device), static_key(bufs), tuple(sorted(flags.items())))
        run = self._runners.get(key)
        if run is None:
            layers = self.layers    # not self: no cycle keeps a dropped AM
            pool = None
            if x.device.type == "cuda":
                pool = self._pools.get(str(x.device))
                if pool is None:
                    pool = self._pools[str(x.device)] = \
                        torch.cuda.graph_pool_handle()
            run = self._runners[key] = GraphRunner(
                lambda b: am_forward(layers, b[0], b[1],
                                     lengths=b[2] if len(b) > 2 else None,
                                     **flags),
                static_buffers(bufs, x.device), x.device, pool=pool)
        return run

    def __call__(self, x: torch.Tensor, state, lengths=None, **flags):
        """``lengths``: the real frames of each row, on the host (numpy or
        a CPU tensor; the counters read them there): then the call returns
        ``(loglikes, state, output lengths)``, the last a host i64 array,
        else ``(loglikes, state)``."""
        global frames_out, frames_real, attn_pairs
        with span("am/forward"):
            host = None
            bufs = (x, state)
            if lengths is not None:
                host = np.asarray(lengths, np.int64)
                bufs = (x, state, torch.from_numpy(host).to(x.device))
            run = self._runner(bufs, flags)
            with self.lock:
                copy_into(run.buffers, bufs)
                out = run()
                y = out[0].clone()
                new = [{k: v.clone() for k, v in st.items()}
                       for st in out[1]]
            if host is None:
                return y, new
            real = output_lengths(self.layers, host, flags.get("skip", 0))
            with _counters_lock:
                frames_out += y.shape[0] * y.shape[1]
                frames_real += int(real.sum())
                attn_pairs += int((real * real).sum())
            return y, new, real


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
