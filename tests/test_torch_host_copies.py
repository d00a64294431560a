"""The port's own copies of the JAX package's host modules
(``asr_decoder_tpu_torch/{fst,decoder,lm,utils,serving,frontend,align,eval,
models,cli}``) against their originals, and the port's independence from
the JAX package.

Tolerance: none.  Each copy runs the original's numpy code unchanged, so
the same seeded inputs give equal arrays, equal bytes and equal text; a
file written by either package loads in the other to equal contents.

``to_port`` carries a JAX-package host object across as arrays: the other
port tests use it so that whatever goes into a port function is an object
of the port's own classes.
"""

import ast
import contextlib
import dataclasses
import importlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import asr_decoder_tpu_torch.__main__ as PMAIN
import asr_decoder_tpu_torch.align.phone_to_word as PPW
import asr_decoder_tpu_torch.align.word_align as PA
import asr_decoder_tpu_torch.cli.arpa2fsa as PA2F
import asr_decoder_tpu_torch.cli.convert_graph as PCG
import asr_decoder_tpu_torch.cli.lat_compose as PLC
import asr_decoder_tpu_torch.cli.lmrescale as PLR
import asr_decoder_tpu_torch.cli.lmscore as PLS
import asr_decoder_tpu_torch.cli.post_serve as PPS
import asr_decoder_tpu_torch.decoder.config as PC
import asr_decoder_tpu_torch.decoder.gold as PG
import asr_decoder_tpu_torch.decoder.raw_lattice as PR
import asr_decoder_tpu_torch.decoder.ref_parity as PRP
import asr_decoder_tpu_torch.eval.synth_task as PS
import asr_decoder_tpu_torch.frontend.audio as PAU
import asr_decoder_tpu_torch.fst.algorithms as PALG
import asr_decoder_tpu_torch.fst.clg as PCLG
import asr_decoder_tpu_torch.fst.ctc_graph as PCTC
import asr_decoder_tpu_torch.fst.determinize as PD
import asr_decoder_tpu_torch.fst.device_fst as PDF
import asr_decoder_tpu_torch.fst.fst as PF
import asr_decoder_tpu_torch.fst.nbest as PN
import asr_decoder_tpu_torch.fst.symbol as PSY
import asr_decoder_tpu_torch.fst.synthetic as PSYN
import asr_decoder_tpu_torch.fst.tlg as PTLG
import asr_decoder_tpu_torch.lm.arpa as PARPA
import asr_decoder_tpu_torch.lm.compose as PCOMP
import asr_decoder_tpu_torch.lm.synth_arpa as PSA
import asr_decoder_tpu_torch.models.transition as PT
import asr_decoder_tpu_torch.serving.post_service as PPOST
import asr_decoder_tpu_torch.serving.protocol as PP
import asr_decoder_tpu_torch.utils as PU
import asr_decoder_tpu_torch.utils.config as PCO
import asr_decoder_tpu_torch.utils.timer as PTM
import asr_decoder_tpu_torch.utils.wer as PW
import asr_decoder_tpu.__main__ as JMAIN
import asr_decoder_tpu.align.phone_to_word as JPW
import asr_decoder_tpu.align.word_align as JA
import asr_decoder_tpu.cli.arpa2fsa as JA2F
import asr_decoder_tpu.cli.convert_graph as JCG
import asr_decoder_tpu.cli.lat_compose as JLC
import asr_decoder_tpu.cli.lmrescale as JLR
import asr_decoder_tpu.cli.lmscore as JLS
import asr_decoder_tpu.cli.post_serve as JPS
import asr_decoder_tpu.decoder.config as JC
import asr_decoder_tpu.decoder.gold as JG
import asr_decoder_tpu.decoder.raw_lattice as JR
import asr_decoder_tpu.decoder.ref_parity as JRP
import asr_decoder_tpu.eval.synth_task as JS
import asr_decoder_tpu.frontend.audio as JAU
import asr_decoder_tpu.fst.algorithms as JALG
import asr_decoder_tpu.fst.clg as JCLG
import asr_decoder_tpu.fst.ctc_graph as JCTC
import asr_decoder_tpu.fst.determinize as JD
import asr_decoder_tpu.fst.device_fst as JDF
import asr_decoder_tpu.fst.fst as JF
import asr_decoder_tpu.fst.nbest as JN
import asr_decoder_tpu.fst.symbol as JSY
import asr_decoder_tpu.fst.synthetic as JSYN
import asr_decoder_tpu.fst.tlg as JTLG
import asr_decoder_tpu.lm.arpa as JARPA
import asr_decoder_tpu.lm.compose as JCOMP
import asr_decoder_tpu.lm.synth_arpa as JSA
import asr_decoder_tpu.models.transition as JT
import asr_decoder_tpu.serving.post_service as JPOST
import asr_decoder_tpu.serving.protocol as JP
import asr_decoder_tpu.utils as JU
import asr_decoder_tpu.utils.config as JCO
import asr_decoder_tpu.utils.timer as JTM
import asr_decoder_tpu.utils.wer as JW

from test_lattice_ops import random_lattice

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "asr_decoder_tpu_torch"


def to_port(obj):
    """``obj`` with every JAX-package host object in it rebuilt as the
    port's class of the same module path and name, attribute for
    attribute (arrays copied)."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    mod = type(obj).__module__
    if mod.startswith("asr_decoder_tpu."):
        cls = getattr(importlib.import_module(
            "asr_decoder_tpu_torch." + mod.partition(".")[2]),
            type(obj).__qualname__)
        if isinstance(obj, tuple):                  # NamedTuple
            return cls(*map(to_port, obj))
        new = object.__new__(cls)
        new.__dict__.update({k: to_port(v) for k, v in vars(obj).items()})
        return new
    if isinstance(obj, (list, tuple)):
        return type(obj)(map(to_port, obj))
    return obj


def assert_same(j, p):
    """Equal contents, recursively; a port object against its original."""
    if isinstance(j, np.ndarray):
        assert isinstance(p, np.ndarray) and j.dtype == p.dtype
        np.testing.assert_array_equal(j, p)
    elif isinstance(j, dict):
        assert j.keys() == p.keys()
        for k in j:
            assert_same(j[k], p[k])
    elif type(j).__module__.startswith("asr_decoder_tpu."):
        assert type(p).__module__ == "asr_decoder_tpu_torch." + \
            type(j).__module__.partition(".")[2]
        assert type(p).__qualname__ == type(j).__qualname__
        if isinstance(j, tuple):
            assert_same(tuple(j), tuple(p))
        else:
            assert vars(j).keys() == vars(p).keys()
            for k in vars(j):
                assert_same(vars(j)[k], vars(p)[k])
    elif isinstance(j, (list, tuple)):
        assert type(j) is type(p) and len(j) == len(p)
        for a, b in zip(j, p):
            assert_same(a, b)
    else:
        assert j == p


# -- the port imports nothing of the JAX package ---------------------------

def _imported_modules(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_port_sources_import_no_jax_package():
    """An AST scan of every file of the port and of ``chip_smoke.py``: no
    import of ``asr_decoder_tpu`` (any module of it) or of ``jax``."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("asr_decoder_tpu", "jax", "jaxlib")]
    assert not bad, bad


# -- each copy against its original ---------------------------------------

def _graph(mod, seed=3):
    return mod.random_hclg(np.random.default_rng(seed), num_states=300,
                           num_ilabels=30, num_words=40)


def case_random_hclg(tmp_path):
    assert_same(_graph(JSYN), _graph(PSYN))


def case_std_fst_binary(tmp_path):
    """A StdFst binary written by either package loads in the other."""
    j, p = _graph(JSYN), _graph(PSYN)
    j.write_binary(str(tmp_path / "j.fst"))
    p.write_binary(str(tmp_path / "p.fst"))
    assert (tmp_path / "j.fst").read_bytes() == \
        (tmp_path / "p.fst").read_bytes()
    assert_same(j, PF.StdFst.read_binary(str(tmp_path / "j.fst")))
    assert_same(JF.StdFst.read_binary(str(tmp_path / "p.fst")), p)


def case_device_fst_npz(tmp_path):
    """DeviceFst.build (split CSR, ε depth, closure) equal, and a saved
    ``.npz`` loads in the other package."""
    j = JDF.DeviceFst.build(_graph(JSYN), arc_lanes=4)
    p = PDF.DeviceFst.build(_graph(PSYN), arc_lanes=4)
    j.build_closure()
    p.build_closure()
    assert_same(j, p)
    j.save(str(tmp_path / "j.npz"))
    p.save(str(tmp_path / "p.npz"))
    assert_same(j, PDF.DeviceFst.load(str(tmp_path / "j.npz")))
    assert_same(JDF.DeviceFst.load(str(tmp_path / "p.npz")), p)


def case_hmm_bundle(tmp_path):
    """``write_hmm_bundle`` bytes equal; each package reads the other's
    bundle into an equal ClgFst."""
    rng = np.random.default_rng(5)
    hmms = [None]
    for _ in range(4):                # linear chains with an ε exit
        n = int(rng.integers(2, 4))
        src = np.repeat(np.arange(n), 2)[:-1]
        dst = np.minimum(src + np.arange(len(src)) % 2, n - 1)
        il = rng.integers(1, 7, len(src)).astype(np.int32)
        il[-1] = 0
        hmms.append(JF.StdFst.from_arcs(
            n, 0, n - 1, src, il, np.zeros(len(src), np.int32),
            rng.random(len(src)).astype(np.float32), dst.astype(np.int32)))
    JCLG.write_hmm_bundle(str(tmp_path / "j.hmm"), hmms)
    PCLG.write_hmm_bundle(str(tmp_path / "p.hmm"), to_port(hmms))
    assert (tmp_path / "j.hmm").read_bytes() == \
        (tmp_path / "p.hmm").read_bytes()
    clg = _graph(JSYN, seed=6)
    clg.arc_ilabel[clg.arc_ilabel > 4] = 1
    clg.write_binary(str(tmp_path / "clg.fst"))
    j = JCLG.ClgFst.load(str(tmp_path / "clg.fst"), str(tmp_path / "p.hmm"))
    p = PCLG.ClgFst.load(str(tmp_path / "clg.fst"), str(tmp_path / "j.hmm"))
    assert_same(j, p)
    assert j.eps_depth() == p.eps_depth()


def case_protocol(tmp_path):
    """Wire bytes of both packages' C2S and S2C packages are equal and
    each unpacks the other's."""
    pcm = np.random.default_rng(7).integers(-3000, 3000, 480) \
        .astype(np.int16)

    def packages(M):
        return [M.C2SPackage.from_samples(pcm, audio_head=True, nbest=3,
                                          ali_info=True, n=5),
                M.S2CPackage(M.EndFlag.END, ali_info=True, warn=True,
                             lattice=b"lat", results=[
                                 M.NbestResult("w1 w2", 1.5, -2.25, [1, 2]),
                                 M.NbestResult("w3", 0.5, 0.0, [3])],
                             align=[("w1", 0.0, 0.25), ("w2", 0.25, 0.5)])]
    jb = [k.pack() for k in packages(JP)]
    assert jb == [k.pack() for k in packages(PP)]
    assert jb[1] == PP.S2CPackage.unpack(jb[1]).pack()
    assert jb[1] == JP.S2CPackage.unpack(packages(PP)[1].pack()).pack()
    head = jb[0][:PP.C2SPackage.head_size()]
    jh, jn = JP.C2SPackage.unpack_head(head)
    ph, pn = PP.C2SPackage.unpack_head(head)
    assert jn == pn and jh.pack() == ph.pack()


def case_audio(tmp_path):
    """A 22.05 kHz stereo WAV payload decodes to equal 16 kHz samples."""
    x = (np.random.default_rng(8).standard_normal((2205, 2)) * 3000) \
        .astype("<i2")
    data = x.tobytes()
    wav = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, 22050, 22050 * 4, 4, 16)
           + b"data" + struct.pack("<I", len(data)) + data)
    assert_same(JAU.decode_audio(wav), PAU.decode_audio(wav))


def _arpa_text(mod):
    return mod.synth_arpa_text(vocab_size=30, n_bigram=60, n_trigram=25,
                               seed=4)


def case_arpa(tmp_path):
    """``synth_arpa_text`` equal; ``parse_arpa`` gives equal Fsas, and an
    Fsa binary written by either package loads in the other."""
    text = _arpa_text(JSA)
    assert text == _arpa_text(PSA)
    j, p = JARPA.parse_arpa(text), PARPA.parse_arpa(text)
    assert_same(j, p)
    j.write_binary(str(tmp_path / "j.lm"))
    p.write_binary(str(tmp_path / "p.lm"))
    assert_same(j, PARPA.Fsa.read_binary(str(tmp_path / "j.lm")))
    assert_same(JARPA.Fsa.read_binary(str(tmp_path / "p.lm")), p)


def case_decoder_config(tmp_path):
    """Every field, its type and its default."""
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(JC.DecoderConfig)]
    assert jf == [(f.name, f.type, f.default) for f in
                  dataclasses.fields(PC.DecoderConfig)]


def case_config_options(tmp_path):
    """A command line and a config file parse to equal values."""
    conf = tmp_path / "dec.conf"
    conf.write_text("--beam=11.5\n--eps-mode=sweeps  # a comment\n")
    argv = [f"--config={conf}", "--beam-width=96", "--log-snapshots=false",
            "--dec.lattice-beam=3", "pos1", "--min-active=7", "pos2"]
    got = []
    for CO, C in ((JCO, JC), (PCO, PC)):
        opts, a, b = CO.ConfigOptions("u"), C.DecoderConfig(), \
            C.DecoderConfig()
        a.register(opts)
        b.register(opts, "dec")
        got.append((opts.parse(argv), dataclasses.asdict(a),
                    dataclasses.asdict(b)))
    assert got[0] == got[1]


def case_symbol_table(tmp_path):
    j = JSY.SymbolTable()
    for i, w in enumerate(["<eps>", "a", "b", "zz"]):
        j.add(w, i * 3)
    j.write_text(str(tmp_path / "w.txt"))
    p = PSY.SymbolTable.read_text(str(tmp_path / "w.txt"))
    p.write_text(str(tmp_path / "p.txt"))
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "w.txt").read_text()
    assert_same(j, p)


def case_word_spans(tmp_path):
    g = _graph(JSYN)
    rng = np.random.default_rng(9)
    arcs = rng.integers(0, g.num_arcs, 40)
    for anchor in ("start", "end"):
        spans = JA.word_spans(arcs, g.arc_ilabel, g.arc_olabel, 5, anchor)
        assert spans == PA.word_spans(arcs, g.arc_ilabel.copy(),
                                      g.arc_olabel.copy(), 5, anchor)
        assert spans


def case_raw_lattice(tmp_path):
    """The pruned raw lattice from per-frame token sets (what the
    searches' logs turn into) has the same text."""
    rng = np.random.default_rng(10)
    fst = JSYN.random_hclg(rng, num_states=12, num_ilabels=8, num_words=5)
    T = 6
    toks = [{int(s): float(c) for s, c in zip(
        rng.choice(fst.num_states, 6, replace=False), rng.random(6) * 4)}
        for _ in range(T + 1)]
    toks[0] = {fst.start: 0.0}
    ll = rng.standard_normal((T, 9)).astype(np.float32)
    i2p = np.arange(9, dtype=np.int32)
    jl = JR.lattice_from_token_sets(fst, toks, ll, i2p,
                                    JC.DecoderConfig(lattice_beam=1e9))
    pl = PR.lattice_from_token_sets(to_port(fst), toks, ll, i2p,
                                    PC.DecoderConfig(lattice_beam=1e9))
    assert (jl is None) == (pl is None)
    if jl is not None:
        assert jl.to_text() == pl.to_text()
        assert jl.to_bytes() == pl.to_bytes()


def case_determinize_nbest(tmp_path):
    """``determinize_lattice`` then ``nshortest`` on random lattices: the
    same lattice text and the same n-best paths."""
    for seed in range(3):
        lat = random_lattice(np.random.default_rng(seed))
        plat = to_port(lat)
        assert lat.to_bytes() == plat.to_bytes()
        jd, pd = JD.determinize_lattice(lat), PD.determinize_lattice(plat)
        assert jd.to_text() == pd.to_text()
        assert_same(JN.nshortest(jd, 4), PN.nshortest(pd, 4))


def case_synth_task_ctc_graph(tmp_path):
    """``SynthTask`` (lexicon, costs, templates, sampled batches) and the
    CTC decode graph built over its lexicon, flat and trie-shared."""
    j, p = JS.SynthTask(seed=2), PS.SynthTask(seed=2)
    assert_same(j, p)
    jb, pb = (t.sample_batch(np.random.default_rng(3), 3, 200, 30)
              for t in (j, p))
    assert_same(jb, pb)
    for share in (False, True):
        jg = JCTC.build_ctc_decode_graph(j.lexicon, j.word_costs,
                                         j.num_phones, share)
        pg = PCTC.build_ctc_decode_graph(p.lexicon, p.word_costs,
                                         p.num_phones, share)
        assert_same(jg, pg)


_TOPO = """<TransitionModel>
<Topology>
<TopologyEntry>
<ForPhones> 1 2 </ForPhones>
<State> 0 <PdfClass> 0 <Transition> 0 0.5 <Transition> 1 0.5 </State>
<State> 1 <PdfClass> 1 <Transition> 1 0.5 <Transition> 2 0.5 </State>
<State> 2 </State>
</TopologyEntry>
</Topology>
<Triples> 4
1 0 0
1 1 1
2 0 2
2 1 3
</Triples>
</TransitionModel>
"""


def case_transition_model(tmp_path):
    """A Kaldi text transition model read by both, the ilabel maps, and
    each package's text writer read back by the other."""
    j = JT.TransitionModel.read_stream(JT.KaldiStream(_TOPO.encode()))
    p = PT.TransitionModel.read_stream(PT.KaldiStream(_TOPO.encode()))
    for shift in (False, True):
        assert_same(j.ilabel_map(shift), p.ilabel_map(shift))
    j.write_text(str(tmp_path / "j.mdl"))
    p.write_text(str(tmp_path / "p.mdl"))
    assert (tmp_path / "j.mdl").read_text() == \
        (tmp_path / "p.mdl").read_text()
    pj = PT.TransitionModel.read(str(tmp_path / "j.mdl"))
    jp = JT.TransitionModel.read(str(tmp_path / "p.mdl"))
    assert_same(jp.ilabel_map(), pj.ilabel_map())
    assert [pj.transition_id_to_pdf(t) for t in range(1, 9)] == \
        [j.transition_id_to_pdf(t) for t in range(1, 9)]


def case_score_pair(tmp_path):
    rng = np.random.default_rng(11)
    for _ in range(20):
        ref = rng.integers(0, 5, int(rng.integers(0, 8))).tolist()
        hyp = rng.integers(0, 5, int(rng.integers(0, 8))).tolist()
        assert dataclasses.asdict(JW.score_pair(ref, hyp)) == \
            dataclasses.asdict(PW.score_pair(ref, hyp))


def case_phone_to_word(tmp_path):
    """Lexicon file read, longest-match alignment with an unmatched phone,
    and frame spans."""
    (tmp_path / "lex").write_text("ni p1 p2\nhao p3\nnihao p1 p2 p3\n"
                                  "x p4 p5\n")
    got = []
    for M, SY in ((JPW, JSY), (PPW, PSY)):
        words, phones = SY.SymbolTable(), SY.SymbolTable()
        for i, w in enumerate(["<eps>", "ni", "hao", "nihao", "x"]):
            words.add(w, i)
        for i, ph in enumerate(["<eps>", "p1", "p2", "p3", "p4", "p5"]):
            phones.add(ph, i)
        p2w = M.PhoneToWord.read_lexicon(str(tmp_path / "lex"), words,
                                         phones)
        w, spans, ok = p2w.align([1, 2, 3, 4, 5, 9, 1, 2])
        got.append((w, [vars(sp) for sp in spans], ok,
                    p2w.align_with_frames([1, 2, 3], [4, 9, 15])))
    assert got[0] == got[1]


def _lms(mod):
    text1, text2 = (mod.synth_arpa_text(vocab_size=30, n_bigram=n,
                                        n_trigram=t, seed=sd)
                    for n, t, sd in ((40, 0, 12), (60, 25, 13)))
    return text1, text2


def _word_lattice(seed):
    lat = random_lattice(np.random.default_rng(seed))
    for s in range(lat.num_states):           # olabels in the LM's vocab
        for a in lat.arcs(s):
            if a.olabel:
                a.olabel = 1 + a.olabel % 30
    return lat


def case_compose_lmscore(tmp_path):
    """Lattice ⊗ scale·G and ⊗ (G₂ − G₁) give equal bytes; ``load_lm``
    reads an ARPA text and an Fsa binary; ``score_text`` and the
    ``lmscore`` CLI print equal lines."""
    t1, t2 = _lms(JSA)
    assert (t1, t2) == _lms(PSA)
    (tmp_path / "g1.arpa").write_text(t1)
    (tmp_path / "g2.arpa").write_text(t2)
    JARPA.parse_arpa(t2).write_binary(str(tmp_path / "g2.fsa"))
    for name in ("g2.arpa", "g2.fsa"):
        assert_same(JLS.load_lm(str(tmp_path / name)),
                    PLS.load_lm(str(tmp_path / name)))
    j1, j2 = (JLS.load_lm(str(tmp_path / n)) for n in ("g1.arpa", "g2.arpa"))
    p1, p2 = (PLS.load_lm(str(tmp_path / n)) for n in ("g1.arpa", "g2.arpa"))
    for seed in range(3):
        lat = _word_lattice(seed)
        plat = to_port(lat)
        assert JCOMP.compose_lattice(lat, JCOMP.ComposeArpaLm(j2, 0.7)) \
            .to_bytes() == PCOMP.compose_lattice(
                plat, PCOMP.ComposeArpaLm(p2, 0.7)).to_bytes()
        assert JCOMP.rescore_lattice(lat, j1, j2, 0.5, 1.5).to_bytes() == \
            PCOMP.rescore_lattice(plat, p1, p2, 0.5, 1.5).to_bytes()
    text = "w1 w2 w3\nw4 w29 w7 w7\n\nw30 w11\n"
    (tmp_path / "text").write_text(text)
    assert JCOMP.ArpaLmScore(j2).score_text(text.split()) == \
        PCOMP.ArpaLmScore(p2).score_text(text.split())
    assert_same(JCOMP.ArpaLmScore(j2).text_to_lattice([1, 4, 9]),
                PCOMP.ArpaLmScore(p2).text_to_lattice([1, 4, 9]))
    out = []
    for M in (JLS, PLS):
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert M.main([str(tmp_path / "g2.arpa"),
                           str(tmp_path / "text")]) == 0
        out.append(buf.getvalue())
    assert out[0] == out[1] and len(out[0].splitlines()) == 3
    assert JPS.main([]) == PPS.main([]) == 2         # usage: lm2 [lm1]


def case_post_service(tmp_path, monkeypatch):
    """Request and response bytes, and ``PostServer._process`` in add and
    replace mode on random lattices (and on garbage): equal responses.
    The original's native n-shortest is turned off: the copy keeps the
    original's Python n-shortest only."""
    from asr_decoder_tpu.fst import native_nbest
    monkeypatch.setattr(native_nbest, "_lib", lambda: None)
    t1, t2 = _lms(JSA)
    jr = JPOST.ConstLmRescorer(JARPA.parse_arpa(t2), JARPA.parse_arpa(t1))
    pr = PPOST.ConstLmRescorer(PARPA.parse_arpa(t2), PARPA.parse_arpa(t1))
    js, ps = JPOST.PostServer(jr), PPOST.PostServer(pr)
    for seed in range(3):
        data = _word_lattice(seed).to_bytes()
        for mode in (JPOST.MODE_ADD, JPOST.MODE_REPLACE):
            jq = JPOST.PostRequest(mode, 0.8, 3, False, data)
            pq = PPOST.PostRequest(mode, 0.8, 3, False, data)
            assert jq.pack() == pq.pack()
            jres, pres = js._process(jq), ps._process(pq)
            assert pres.ok and pres.results
            assert jres.pack() == pres.pack()
    bad = PPOST.PostRequest(lattice=b"\x01bad")
    assert ps._process(bad).pack() == js._process(
        JPOST.PostRequest(lattice=b"\x01bad")).pack()


def _tlg(ARPA_MOD, SA, TLG, lm_scale=1.0):
    fsa = ARPA_MOD.parse_arpa(SA.synth_arpa_text(
        vocab_size=40, n_bigram=120, n_trigram=60, n_4gram=20, seed=5))
    rng = np.random.default_rng(6)
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if wname.startswith("w") and wid % 7:          # some words are OOV
            ph = [int(rng.integers(1, 9))]
            while len(ph) < int(rng.integers(2, 5)):
                q = int(rng.integers(1, 9))
                if q != ph[-1]:
                    ph.append(q)
            lexicon[wid] = ph
    return fsa, lexicon, TLG.build_tlg(lexicon, fsa, 8, lm_scale)


def case_tlg(tmp_path):
    """``build_tlg`` over a seeded 4-gram ARPA and lexicon: the composed
    graph arc for arc, the ilabel map, the olabel anchor."""
    for scale in (1.0, 0.5):
        _, _, (jf, ji) = _tlg(JARPA, JSA, JTLG, scale)
        _, _, (pf, pi) = _tlg(PARPA, PSA, PTLG, scale)
        assert_same(jf, pf)
        assert_same(ji, pi)
        assert jf.num_arcs > 500 and pf.olabel_anchor == "end"


def _gold_same(j, p, lattice=False):
    assert type(p).__module__ == "asr_decoder_tpu_torch.decoder.gold"
    assert (j.words, j.ilabels, j.cost, j.reached_final) == \
        (p.words, p.ilabels, p.cost, p.reached_final)
    if lattice:
        assert j.lattice.to_bytes() == p.lattice.to_bytes()


def case_gold_hclg(tmp_path):
    """``GoldDecoder`` on a random graph, pruned and unpruned, with the
    raw lattice."""
    g = JSYN.random_hclg(np.random.default_rng(12), num_states=60,
                         num_ilabels=9, num_words=7)
    i2p = np.arange(10, dtype=np.int32)
    ll = np.random.default_rng(13).standard_normal((9, 10)).astype(
        np.float32)
    for kw in (dict(beam=1e9, max_active=10000, min_active=0),
               dict(beam=3.0, max_active=12, min_active=2,
                    acoustic_scale=0.7)):
        j = JG.GoldDecoder(g, i2p, JC.DecoderConfig(**kw)).decode(
            ll, want_lattice=True)
        p = PG.GoldDecoder(to_port(g), i2p, PC.DecoderConfig(**kw)).decode(
            ll, want_lattice=True)
        _gold_same(j, p, lattice=j.lattice is not None)
        assert j.ilabels


def _clg_pair(tmp_path):
    rng = np.random.default_rng(5)
    hmms = [None]
    for _ in range(4):
        n = int(rng.integers(2, 4))
        src = np.repeat(np.arange(n), 2)[:-1]
        dst = np.minimum(src + np.arange(len(src)) % 2, n - 1)
        il = rng.integers(1, 7, len(src)).astype(np.int32)
        il[-1] = 0
        hmms.append(JF.StdFst.from_arcs(
            n, 0, n - 1, src, il, np.zeros(len(src), np.int32),
            rng.random(len(src)).astype(np.float32), dst.astype(np.int32)))
    JCLG.write_hmm_bundle(str(tmp_path / "h.hmm"), hmms)
    clg = _graph(JSYN, seed=6)
    clg.arc_ilabel[clg.arc_ilabel > 4] = 1
    clg.write_binary(str(tmp_path / "clg.fst"))
    return (JCLG.ClgFst.load(str(tmp_path / "clg.fst"),
                             str(tmp_path / "h.hmm")),
            PCLG.ClgFst.load(str(tmp_path / "clg.fst"),
                             str(tmp_path / "h.hmm")))


def case_gold_clg(tmp_path):
    """``GoldClgDecoder`` over a CLG layer and an HMM bundle."""
    jg, pg = _clg_pair(tmp_path)
    i2p = np.arange(8, dtype=np.int32)
    ll = np.random.default_rng(14).standard_normal((10, 8)).astype(
        np.float32)
    kw = dict(beam=8.0, max_active=40, min_active=2)
    _gold_same(JG.GoldClgDecoder(jg, i2p, JC.DecoderConfig(**kw)).decode(ll),
               PG.GoldClgDecoder(pg, i2p, PC.DecoderConfig(**kw)).decode(ll))


def case_gold_biglm(tmp_path):
    """``GoldBigLmDecoder``: the (state, lm1, lm2) pair search with the
    difference-LM cost."""
    t1, t2 = _lms(JSA)
    g = JSYN.random_hclg(np.random.default_rng(15), num_states=80,
                         num_ilabels=9, num_words=30)
    i2p = np.arange(10, dtype=np.int32)
    ll = np.random.default_rng(16).standard_normal((8, 10)).astype(
        np.float32)
    kw = dict(beam=6.0, max_active=30, min_active=2)
    j = JG.GoldBigLmDecoder(g, i2p, JARPA.parse_arpa(t1),
                            JARPA.parse_arpa(t2), 0.7, 1.3,
                            JC.DecoderConfig(**kw)).decode(ll)
    p = PG.GoldBigLmDecoder(to_port(g), i2p, PARPA.parse_arpa(t1),
                            PARPA.parse_arpa(t2), 0.7, 1.3,
                            PC.DecoderConfig(**kw)).decode(ll)
    _gold_same(j, p)


_FAKE_REFPARITY = """#!/bin/sh
echo frames=5
echo nonempty=1
echo cost=12.5 graph=4.25 acoustic=8.25
echo words=3 1 4
echo ilabels=2 7 1 8
echo arcs=0:5 5:9
echo nbest=2
echo nb0 cost=12.5 graph=4.25 words=3 1 4
echo nb1 cost=13.0 graph=5.0 words=3 1
"""


def case_ref_parity(tmp_path):
    """No reference tree here, so ``available()`` is False in both; the
    copy's tools directory is the repository's; ``run`` writes the same
    graph and input files byte for byte and parses a decoder's output to
    the same dict (a stand-in binary prints a fixed reply)."""
    assert JRP.available() is False and PRP.available() is False
    assert PRP.REF_ROOT == JRP.REF_ROOT
    assert Path(PRP._TOOLS_DIR).resolve() == Path(JRP._TOOLS_DIR).resolve() \
        == ROOT / "tools" / "refparity"
    assert (Path(PRP._TOOLS_DIR) / "build.sh").exists()
    assert PRP.available(str(tmp_path)) is False
    fake = tmp_path / "refparity_main"
    fake.write_text(_FAKE_REFPARITY)
    fake.chmod(0o755)
    assert PRP.build(str(tmp_path)) == JRP.build(str(tmp_path)) == str(fake)
    g = _graph(JSYN)
    ll = np.random.default_rng(17).standard_normal((5, 31)).astype(
        np.float32)
    i2p = np.arange(31, dtype=np.int64)
    out = []
    for M, graph, wd in ((JRP, g, "j"), (PRP, to_port(g), "p")):
        (tmp_path / wd).mkdir()
        out.append(M.run(str(fake), graph, ll, i2p, acoustic_scale=0.8,
                         beam=9.0, max_active=50, min_active=3, nbest=2,
                         workdir=str(tmp_path / wd)))
    assert out[0] == out[1] and out[0]["words"] == [3, 1, 4]
    assert len(out[0]["nbest"]) == 2 and out[0]["arcs"] == [(0, 5), (5, 9)]
    for name in ("graph.fst", "input.blob"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "p" / name).read_bytes()


def case_fst_algorithms(tmp_path):
    """``reverse``, ``rmepsilon``, Tarjan components and ``dfs_access`` on
    random lattices, one with a cycle."""
    for seed in range(4):
        lat = random_lattice(np.random.default_rng(seed + 100))
        plat = to_port(lat)
        assert JALG.reverse(lat).to_bytes() == PALG.reverse(plat).to_bytes()
        if seed == 3:
            for l, A in ((lat, JALG), (plat, PALG)):
                l.add_arc(1, type(l.arcs(0)[0])(
                    1, 0, type(l.arcs(0)[0].weight)(0.1, 0.0), 0))
        assert JALG.strongly_connected_components(lat) == \
            PALG.strongly_connected_components(plat)
        assert_same(JALG.dfs_access(lat), PALG.dfs_access(plat))
        if seed != 3:
            JALG.rmepsilon(lat)
            PALG.rmepsilon(plat)
            assert lat.to_bytes() == plat.to_bytes()


def case_timer_and_utils_exports(tmp_path):
    """``RtfStats`` arithmetic, ``Timer``, and the names ``utils`` exports."""
    j, p = JTM.RtfStats(), PTM.RtfStats()
    for wav, run, nosil in ((4.0, 1.0, 3.0), (2.5, 0.75, 0.0)):
        j.add(wav, run, nosil)
        p.add(wav, run, nosil)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert (j.rtf, j.nosil_rtf, j.speedup) == (p.rtf, p.nosil_rtf, p.speedup)
    t = PTM.Timer()
    assert 0.0 <= t.elapsed() < 5.0
    names = ("ConfigOptions", "get_logger", "set_verbose_level", "vlog",
             "Timer")
    for n in names:
        assert hasattr(JU, n)
        assert getattr(PU, n).__module__.startswith(
            "asr_decoder_tpu_torch.utils.")
    assert PU.Timer is PTM.Timer and PU.ConfigOptions is PCO.ConfigOptions


def _main_out(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def case_cli_lm_tools(tmp_path):
    """``arpa2fsa`` (with and without ``--words``), ``lmrescale`` and
    ``lat-compose`` (add and difference mode, ``--out``): the same exit
    codes, stdout, stderr text and files from both packages' ``main``."""
    t1, t2 = _lms(JSA)
    (tmp_path / "g1.arpa").write_text(t1)
    (tmp_path / "g2.arpa").write_text(t2)
    words = JSY.SymbolTable()
    words.add("<eps>", 0)
    for i in range(1, 31):
        words.add(f"w{i}", 40 - i)
    for i, w in enumerate(("<s>", "</s>", "<unk>")):
        words.add(w, 50 + i)
    words.write_text(str(tmp_path / "words.txt"))
    _word_lattice(1).write_binary(str(tmp_path / "l.lat"))
    for tag, (A2F, LR, LC) in (("j", (JA2F, JLR, JLC)),
                               ("p", (PA2F, PLR, PLC))):
        d = tmp_path / tag
        d.mkdir()
        runs = [
            (A2F.main, [str(tmp_path / "g2.arpa"), str(d / "g2.fsa")]),
            (A2F.main, [f"--words={tmp_path / 'words.txt'}",
                        str(tmp_path / "g1.arpa"), str(d / "g1w.fsa")]),
            (A2F.main, [str(tmp_path / "g1.arpa"), str(d / "g1.fsa")]),
            (A2F.main, ["only-one-arg"]),
            (LR.main, ["--scale=-1.0", str(d / "g1.fsa"),
                       str(d / "g1neg.fsa")]),
            (LR.main, []),
            (LC.main, ["--nbest=3", "--scale=0.8", f"--out={d / 'o.lat'}",
                       str(tmp_path / "l.lat"), str(d / "g2.fsa")]),
            (LC.main, ["--nbest=2", str(tmp_path / "l.lat"),
                       str(d / "g2.fsa"), str(d / "g1.fsa")]),
            (LC.main, [str(tmp_path / "l.lat")]),
        ]
        (tmp_path / f"{tag}.log").write_text(repr(
            [(rc, out, err.replace(str(d), "<dir>")
              .replace("asr_decoder_tpu_torch", "asr_decoder_tpu"))
             for rc, out, err in (_main_out(m, a) for m, a in runs)]))
    assert (tmp_path / "j.log").read_text() == (tmp_path / "p.log").read_text()
    assert "\\t" in (tmp_path / "j.log").read_text()      # n-best lines
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == ["g1.fsa", "g1neg.fsa", "g1w.fsa", "g2.fsa", "o.lat"]
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "p" / n).read_bytes()


def case_cli_convert_graph(tmp_path):
    """``convert-graph``: a graph binary and an HMM bundle from a list of
    HMM graphs; the port's goes through its own ``cli/_model.load_graph``."""
    g = _graph(JSYN)
    g.write_binary(str(tmp_path / "in.fst"))
    hmm_paths = []
    for i in range(3):
        h = JSYN.random_hclg(np.random.default_rng(20 + i), num_states=5,
                             num_ilabels=4, num_words=2)
        h.write_binary(str(tmp_path / f"h{i}.fst"))
        hmm_paths.append(str(tmp_path / f"h{i}.fst"))
    (tmp_path / "hmm.list").write_text("\n".join(hmm_paths) + "\n")
    logs = []
    for tag, CG in (("j", JCG), ("p", PCG)):
        d = tmp_path / tag
        d.mkdir()
        runs = [[str(tmp_path / "in.fst"), str(d / "out.fst")],
                [f"--hmm-list={tmp_path / 'hmm.list'}", str(d / "hmm.bundle")],
                [str(tmp_path / "in.fst")]]
        logs.append([(rc, out, err.replace(str(d), "<dir>"))
                     for rc, out, err in (_main_out(CG.main, a)
                                          for a in runs)])
    assert logs[0] == logs[1] and [r[0] for r in logs[0]] == [0, 0, 2]
    for n in ("out.fst", "hmm.bundle"):
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "p" / n).read_bytes()
    assert (tmp_path / "p" / "out.fst").read_bytes() == \
        (tmp_path / "in.fst").read_bytes()
    assert PCG.load_graph.__module__ == "asr_decoder_tpu_torch.cli._model"


def case_main_table(tmp_path, monkeypatch):
    """``python -m``'s tool table: the same tools and descriptions, each
    pointing at the port's module of the same name, which exists and has a
    ``main``; the help text and the unknown-tool reply."""
    assert list(PMAIN.TOOLS) == list(JMAIN.TOOLS)
    for name, (jmod, jdoc) in JMAIN.TOOLS.items():
        pmod, pdoc = PMAIN.TOOLS[name]
        assert pdoc == jdoc
        assert pmod == "asr_decoder_tpu_torch." + jmod.partition(".")[2]
        assert callable(importlib.import_module(pmod).main)
    got = []
    for M in (JMAIN, PMAIN):
        for argv in (["x", "--help"], ["x"], ["x", "no-such-tool"]):
            monkeypatch.setattr(sys, "argv", argv)
            rc, out, err = _main_out(lambda _: M.main(), None)
            got.append((rc, out.replace("asr_decoder_tpu_torch",
                                        "asr_decoder_tpu"), err))
    assert got[:3] == got[3:] and [g[0] for g in got[:3]] == [0, 2, 2]


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case, tmp_path, monkeypatch):
    fn = CASES[case]
    if "monkeypatch" in fn.__code__.co_varnames:
        fn(tmp_path, monkeypatch)
    else:
        fn(tmp_path)
