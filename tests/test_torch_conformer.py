"""The port's full-context Conformer AM (``models/layers.py``:
``conv2d_subsample`` and ``conformer``; ``models/nnet.py``: lengths
through ``am_forward`` and ``GraphedAm``) on the CPU at d 64, 4 heads, 2
blocks, an even kernel of 8 (so the two sides of its padding differ) and
a feed-forward width of 256, against the plain reference
``tests/conformer_reference.py``; the existing layer kinds through the
changed AM path; the refusal of the served path; a padded batch through
the search and the traceback against each row alone.  Imports nothing of
JAX.

Tolerance: a padded row against the reference computed alone, atol 2e-5
in the log domain.  Both are float32; they sum products in other orders
(batched against one row, an explicit patch matrix and a tap loop
against the library's convolutions), and 2 blocks carry those last-bit
differences; the readings are ~5e-7.  Everything else is exact."""

import numpy as np
import pytest
import torch

import conformer_reference as ref
from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
from asr_decoder_tpu_torch.fst.symbol import SymbolTable
from asr_decoder_tpu_torch.fst.synthetic import random_hclg
from asr_decoder_tpu_torch.models import layers as L
from asr_decoder_tpu_torch.models import nnet as N
from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
from asr_decoder_tpu_torch.serving.batcher import BatchedStreamingDecoder
from asr_decoder_tpu_torch.serving.session import (OnlineDecoderInfo,
                                                   OnlineDecoderSession)

SMALL = dict(feat_dim=20, d_model=64, heads=4, blocks=2, ffn_dim=256,
             conv_kernel=8, num_pdfs=24)
ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _net(seed=0, device="cpu"):
    return N.Nnet.conformer(SMALL, seed, device=device)


def _feats(seed, B=3, T=61):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, T, SMALL["feat_dim"]), generator=g) * 3.0 + 12.0


def _ref_layers(net):
    return [(l.kind, {k: v.detach().cpu() for k, v in l.params.items()})
            for l in net.layers]


@pytest.mark.parametrize("seed", [0, 1])
def test_padded_batch_matches_reference_row_by_row(seed):
    net = _net(seed)
    x = _feats(seed)
    lens = torch.tensor([61, 40, 9])
    with torch.inference_mode():
        y, _, out = N.am_forward(net.layers, x, net.init_state(3),
                                 lengths=lens)
        assert y.shape[1] == L.subsample_lengths(61)
        assert out.tolist() == [int(L.subsample_lengths(n)) for n in
                                lens.tolist()]
        for b, n in enumerate(lens.tolist()):
            want = ref.forward(_ref_layers(net), x[b, :n])
            assert want.shape[0] == out[b]
            np.testing.assert_allclose(y[b, :want.shape[0]].numpy(),
                                       want.numpy(), rtol=0, atol=ATOL)


def test_padding_does_not_reach_real_frames():
    """Changing only the padded frames of a row leaves its real output
    frames bit for bit."""
    net = _net(2)
    x = _feats(2)
    lens = torch.tensor([61, 33, 20])
    y = []
    with torch.inference_mode():
        for fill in (0.0, 1e3):
            xx = x.clone()
            for b, n in enumerate(lens.tolist()):
                xx[b, n:] = fill
            y.append(N.am_forward(net.layers, xx, net.init_state(3),
                                  lengths=lens))
    (a, _, out), (b, _, _) = y
    for r, n in enumerate(out.tolist()):
        assert torch.equal(a[r, :n], b[r, :n])
    assert not torch.equal(a[1:, -1], b[1:, -1])


@pytest.mark.parametrize("T", list(range(0, 40)))
def test_output_length_rule(T):
    """T' = ((T − 1) // 2 − 1) // 2 (at least 0) frames of the front end,
    on numpy and torch, through ``Nnet.output_lengths`` with and without
    ``skip``; the convolutions give as many frames."""
    want = max(((T - 1) // 2 - 1) // 2, 0)
    assert int(L.subsample_lengths(np.int64(T))) == want
    assert int(L.subsample_lengths(torch.tensor(T))) == want
    net = _net(0)
    assert net.output_lengths(np.array([T])).tolist() == [want]
    assert net.output_lengths(np.array([T]), skip=1).tolist() == \
        [max((((T + 1) // 2 - 1) // 2 - 1) // 2, 0)]
    if T >= 7:
        with torch.inference_mode():
            y, _ = net.layers[0](torch.zeros(1, T, SMALL["feat_dim"]), {})
        assert y.shape[1] == want


def test_binary_round_trip(tmp_path):
    """Both kinds write, read back bit for bit (kinds, dims, meta,
    weights) and write again byte for byte."""
    net = _net(3)
    a, b = tmp_path / "a.nnet", tmp_path / "b.nnet"
    net.write_binary(str(a))
    back = N.Nnet.read_binary(str(a), device="cpu")
    back.write_binary(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert [(l.kind, l.input_dim, l.output_dim, l.meta) for l in back.layers] \
        == [(l.kind, l.input_dim, l.output_dim, l.meta) for l in net.layers]
    for la, lb in zip(net.layers, back.layers):
        assert la.params.keys() == lb.params.keys()
        for k in la.params:
            assert torch.equal(la.params[k], lb.params[k]), k
    assert not back.streaming and N.Nnet([net.layers[-1]]).streaming


def _old_kind_net(kind, rng):
    """[kind, affine, softmax, prior] over the kinds the reference format
    had, with random weights."""
    D, H, P, V = 12, 10, 6, 9
    n = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.3).astype(np.float32))
    lstm = {"w_gifo_x": n(4 * H, D), "w_gifo_m": n(4 * H, H),
            "bias": n(4 * H), "phole_i": n(H), "phole_f": n(H),
            "phole_o": n(H)}
    params, dout, meta = {
        "splice": ({}, 3 * D, (-1, 0, 1)),
        "add_shift": ({"shift": n(D)}, D, ()),
        "rescale": ({"scale": n(D)}, D, ()),
        "sigmoid": ({}, D, ()),
        "affine": ({"weight": n(H, D), "bias": n(H)}, H, ()),
        "linear": ({"weight": n(H, D)}, H, ()),
        "lstm": (lstm, H, ()),
        "lstm_cudnn": (lstm, H, ()),
        "tf_lstm": ({k: lstm[k] for k in ("w_gifo_x", "w_gifo_m", "bias")},
                    H, ()),
        "lstm_projected": ({"w_gifo_x": n(4 * H, D), "w_gifo_r": n(4 * H, P),
                            "bias": n(4 * H), "phole_i": n(H),
                            "phole_f": n(H), "phole_o": n(H),
                            "w_r_m": n(P, H)}, P, ()),
        "sru": ({"w_xfrh": n(4 * D, D), "bias_f": n(D), "bias_r": n(D)},
                D, ()),
    }[kind]
    layers = [L.make_layer(kind, D, dout, params or None, meta),
              L.make_layer("affine", dout, V,
                           {"weight": n(V, dout), "bias": n(V)}),
              L.make_softmax(V), L.make_layer("prior", V, V,
                                              {"log_priors": n(V)})]
    return N.Nnet(layers)


OLD_KINDS = ["splice", "add_shift", "rescale", "sigmoid", "affine", "linear",
             "lstm", "lstm_cudnn", "tf_lstm", "lstm_projected", "sru"]


@pytest.mark.parametrize("kind", OLD_KINDS)
def test_existing_kinds_bit_identical(kind):
    """Each kind the AM path ran before: ``am_forward`` equals the layers
    called one after another, with or without full-row lengths (which
    come back unchanged, skipped as ``skip`` drops frames), and
    ``GraphedAm`` equals ``am_forward``, bit for bit."""
    rng = np.random.default_rng(len(kind))
    net = _old_kind_net(kind, rng)
    x = torch.from_numpy(rng.standard_normal((3, 11, 12)).astype(np.float32))
    with torch.inference_mode():
        h, st = x, net.init_state(3)
        for i, l in enumerate(net.layers[:3]):
            h, st[i] = l(h, st[i])
        want = torch.log(h) - net.layers[3].log_priors
        got, new = N.am_forward(net.layers, x, net.init_state(3))
        assert torch.equal(got, want)
        for a, b in zip(new, st):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        full = torch.full((3,), 11)
        got2, _, out = N.am_forward(net.layers, x, net.init_state(3),
                                    lengths=full)
        assert torch.equal(got2, want) and out.tolist() == [11] * 3
        _, _, out = N.am_forward(net.layers, x, net.init_state(3),
                                 lengths=full, skip=2)
        assert out.tolist() == [4] * 3
        am = N.GraphedAm(net.layers)
        for _ in range(2):
            g, gst = am(x, net.init_state(3))
            assert torch.equal(g, want)
            g3, _, gout = am(x, net.init_state(3), full.numpy())
            assert torch.equal(g3, want) and gout.tolist() == [11] * 3


def test_graphed_am_lengths_one_runner_a_padded_length_and_counters():
    """Rows of other lengths reuse the padded length's runner; the
    counters add the padded frames, the real frames and Σ T'²."""
    net = _net(4)
    am = N.GraphedAm(net.layers)
    x = _feats(4)
    before = (N.frames_out, N.frames_real, N.attn_pairs)
    with torch.inference_mode():
        outs = [am(x, net.init_state(3), np.array(lens))
                for lens in ([61, 40, 9], [20, 61, 33])]
        eager = N.am_forward(net.layers, x, net.init_state(3),
                             lengths=torch.tensor([20, 61, 33]))
    assert len(am._runners) == 1
    assert torch.equal(outs[1][0], eager[0])
    real = [int(L.subsample_lengths(n)) for n in (61, 40, 9, 20, 61, 33)]
    assert outs[0][2].tolist() + outs[1][2].tolist() == real
    T = int(L.subsample_lengths(61))
    assert (N.frames_out - before[0], N.frames_real - before[1],
            N.attn_pairs - before[2]) == (6 * T, sum(real),
                                          sum(r * r for r in real))


def _info(net):
    rng = np.random.default_rng(5)
    fst = random_hclg(rng, num_states=60, num_ilabels=SMALL["num_pdfs"] - 1,
                      num_words=10, max_degree=4)
    words = SymbolTable()
    for w in range(11):
        words.add(f"w{w}", w)
    return OnlineDecoderInfo(
        net, fst, words, np.arange(SMALL["num_pdfs"]),
        decoder_config=DecoderConfig(beam=8.0, beam_width=16, max_active=16,
                                     min_active=2, arc_lanes=8,
                                     eps_mode="closure"), device="cpu")


@pytest.mark.parametrize("user", ["session", "arena"])
def test_served_path_refuses_a_full_context_am(user):
    info = _info(_net(5))
    with pytest.raises(ValueError, match="conformer.*conv2d_subsample|"
                                         "read the whole utterance"):
        if user == "session":
            OnlineDecoderSession(info)
        else:
            BatchedStreamingDecoder(info, 2)


def test_padded_decode_equals_rows_alone():
    """The padded batch through ``GraphedAm`` with lengths, the search
    with the output lengths' frame mask and the traceback: each row's
    answer equals the row's own scores decoded alone, unpadded (arc ids,
    words, cost exactly), and those scores equal the row's own AM run
    within the tolerance above."""
    net = _net(6)
    info_rng = np.random.default_rng(7)
    fst = random_hclg(info_rng, num_states=200,
                      num_ilabels=SMALL["num_pdfs"] - 1, num_words=20,
                      max_degree=6, eps_frac=0.2)
    search = TorchBeamSearch(
        DeviceFst.build(fst, arc_lanes=8), np.arange(SMALL["num_pdfs"]),
        DecoderConfig(beam=10.0, beam_width=16, max_active=16,
                      min_active=2, arc_lanes=8, eps_mode="closure",
                      relax_impl="topk"), device="cpu")
    x = _feats(6, B=4, T=70)
    lens = np.array([70, 23, 51, 38])
    am = N.GraphedAm(net.layers)
    with torch.inference_mode():
        ll, _, out = am(x, net.init_state(4), lens)
        mask = np.arange(ll.shape[1])[None, :] < out[:, None]
        state, init_log, logs = search.decode(ll, mask)
        got = search.traceback(state, init_log, logs, fst)
        for b, n in enumerate(out.tolist()):
            alone, _ = N.am_forward(net.layers, x[b:b + 1, :lens[b]],
                                    net.init_state(1))
            np.testing.assert_allclose(alone[0].numpy(), ll[b, :n].numpy(),
                                       rtol=0, atol=ATOL)
            st1, il1, lg1 = search.decode(ll[b:b + 1, :n])
            want = search.traceback(st1, il1, lg1, fst)[0]
            assert got[b] == want, b
    assert len({len(r["ilabels"]) for r in got}) > 1


@pytest.mark.cuda
def test_graphed_am_on_the_card_bit_exact(cuda):
    """On a card: the captured graph against the eager ``am_forward`` bit
    for bit, at two padded lengths sharing the AM's pool, each replayed
    with other row lengths; every row's real frames against the
    reference within the tolerance above (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = _net(8, device=cuda)
    am = N.GraphedAm(net.layers)
    with torch.inference_mode():
        for T, sets in ((61, ([61, 40, 9], [30, 61, 17])),
                        (95, ([95, 12, 64], [7, 50, 95]))):
            x = _feats(T, T=T).to(cuda)
            for lens in sets + sets:
                y, _, out = am(x, net.init_state(3, cuda), np.array(lens))
                want, _, wout = N.am_forward(
                    net.layers, x, net.init_state(3, cuda),
                    lengths=torch.tensor(lens, device=cuda))
                assert torch.equal(y, want), (T, lens)
                assert out.tolist() == wout.tolist()
                for b, n in enumerate(lens):
                    r = ref.forward(_ref_layers(net), x[b, :n].cpu())
                    np.testing.assert_allclose(
                        y[b, :r.shape[0]].cpu().numpy(), r.numpy(), rtol=0,
                        atol=ATOL)
    assert len(am._runners) == 2 and len(am._pools) == 1
