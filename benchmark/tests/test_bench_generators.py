"""Every generator gives the same inputs for the same seed, and every
seed the same set of lengths (in another order)."""

import numpy as np
import torch

from benchmark import graphs, inputs
from benchmark.traffic.loadgen import lengths

JOB = {"params": {"pool": 512, "length": {"median_s": 6.0, "sigma": 0.5,
                                          "min_s": 1.5, "max_s": 20.0}}}


def test_lengths_same_seed_same_set():
    a = lengths(dict(JOB, seed=2**31 + 7))
    b = lengths(dict(JOB, seed=2**31 + 7))
    c = lengths(dict(JOB, seed=11))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(c))
    assert not np.array_equal(a, c)
    assert 6.0 < a.mean() < 7.5 and a.min() >= 1.5 and a.max() <= 20.0


def test_waves_posteriors_weights_graphs():
    np.testing.assert_array_equal(inputs.wave(5, 3, 1.0),
                                  inputs.wave(5, 3, 1.0))
    assert not np.array_equal(inputs.wave(5, 3, 1.0), inputs.wave(6, 3, 1.0))
    g = graphs.random_hclg(9, 500, 20)
    h = graphs.random_hclg(9, 500, 20)
    np.testing.assert_array_equal(g.dst, h.dst)
    lex = {1: [1, 2, 3], 2: [2, 1]}
    np.testing.assert_array_equal(inputs.ctc_posteriors(lex, 3, 2, 20, 4, 1),
                                  inputs.ctc_posteriors(lex, 3, 2, 20, 4, 1))
    am = {"feat_dim": 8, "context": 1, "proj": 6, "hidden": 5,
          "num_layers": 2, "num_pdfs": 20}
    a = inputs.am_weights(am, 2**33, "cpu")
    b = inputs.am_weights(am, 2**33, "cpu")
    for (_, _, _, _, pa), (_, _, _, _, pb) in zip(a, b):
        for k in pa:
            if k != "offsets":
                assert torch.equal(pa[k], pb[k])
    assert torch.equal(inputs.wave_batch(3, 1, 2, 0.1, "cpu"),
                       inputs.wave_batch(3, 1, 2, 0.1, "cpu"))


def test_tlg_matches_the_program_recipe():
    """The benchmark's frozen TLG recipe builds the same arcs as the
    program's own ``fst/tlg.py`` over its own ARPA parser."""
    from asr_decoder_tpu_torch.fst.tlg import build_tlg
    from asr_decoder_tpu_torch.lm.arpa import parse_arpa
    from asr_decoder_tpu_torch.lm.synth_arpa import synth_arpa_text
    lm = {"vocab_size": 40, "n_bigram": 100, "n_trigram": 40, "n_4gram": 10}
    g = graphs.build_tlg(lm, 6)
    fsa = parse_arpa(synth_arpa_text(**lm, seed=1))
    fst, i2p = build_tlg(g.lexicon, fsa, 6)
    mine = inputs.port_fst(g, "end")
    for k in ("state_offset", "arc_ilabel", "arc_olabel", "arc_weight",
              "arc_dst"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(fst, k))
    np.testing.assert_array_equal(g.ilabel2pdf, i2p)
