"""The port's offline decode CLI (``asr_decoder_tpu_torch/cli/decode.py``)
against the JAX one (``asr_decoder_tpu/cli/decode.py``) on the CPU: the
same model, graph and words files, three seeded 16-bit 16 kHz waves, a wav
list and a reference transcript, the same flags.

Tolerance: none.  Every stdout line (``<utt> <words>`` and, with
``--ali=true``, ``<utt> ali <word> <begin> <end>``) and the ``%WER`` line
on stderr are equal as text; both print the real-time-factor line (its
times are each run's own).
"""

import wave as wavelib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from asr_decoder_tpu.cli import decode as jax_decode  # noqa: E402
from asr_decoder_tpu_torch.cli import decode as port_decode  # noqa: E402

from test_session import make_info, make_wave  # noqa: E402

SEEDS = (0, 3, 7)
FLAGS = ["--beam=1e9", "--beam-width=64", "--arc-lanes=8", "--min-active=0",
         "--lattice-beam=8", "--chunk-frames=16", "--fbank.num-bins=16"]
RTF = "real-time factor assuming 100 frames/sec is"


def write_wav(path, samples, rate=16000):
    with wavelib.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, np.int16).tobytes())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The positional arguments both CLIs take, and the ``--ref-text``
    flag: the JAX test model written as files, and the seeded waves."""
    tmp = tmp_path_factory.mktemp("decode_cli")
    info = make_info()
    paths = [str(tmp / n) for n in ("final.nnet", "graph.fst", "words.txt")]
    info.nnet.write_binary(paths[0])
    info.fst.write_binary(paths[1])
    info.words.write_text(paths[2])
    lines = []
    for seed in SEEDS:
        p = tmp / f"u{seed}.wav"
        write_wav(p, make_wave(seed))
        lines.append(f"u{seed} {p}\n")
    (tmp / "wav.list").write_text("".join(lines))
    # one reference a word off, one far off, one empty: a WER with
    # insertions, deletions and substitutions
    (tmp / "ref.txt").write_text("u0 w1 w2\nu3 w3 w3 w3 w3 w3 w3\nu7\n")
    return (paths + [str(tmp / "wav.list")],
            f"--ref-text={tmp / 'ref.txt'}")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


@pytest.mark.parametrize("ali", [False, True])
def test_decode_cli_matches_jax(files, capsys, ali):
    pos, ref = files
    argv = FLAGS + [f"--ali={str(ali).lower()}", ref] + pos
    jrc, jout, jerr = _run(jax_decode.main, argv, capsys)
    prc, pout, perr = _run(port_decode.main, ["--device=cpu"] + argv, capsys)
    assert jrc == prc == 0
    assert pout == jout
    texts = [ln for ln in jout if " ali " not in ln]
    assert [ln.split()[0] for ln in texts] == [f"u{s}" for s in SEEDS]
    assert sum(len(ln.split()) - 1 for ln in texts) > 0, "no words decoded"
    alis = [ln for ln in jout if " ali " in ln]
    assert len(alis) == (sum(len(ln.split()) - 1 for ln in texts)
                         if ali else 0)
    wer = [[ln for ln in err if ln.startswith("%WER")] for err in (jerr,
                                                                   perr)]
    assert wer[1] == wer[0] and len(wer[0]) == 1
    for err in (jerr, perr):
        assert sum(RTF in ln for ln in err) == 1


def test_decode_cli_wrong_arguments(files, capsys):
    """Three positional arguments: rc 2 and the usage text on stderr, as
    the JAX CLI does."""
    pos, _ = files
    jrc, jout, jerr = _run(jax_decode.main, pos[:3], capsys)
    prc, pout, perr = _run(port_decode.main, ["--device=cpu"] + pos[:3],
                           capsys)
    assert jrc == prc == 2
    assert jout == pout == []
    assert perr[0] == jerr[0] == ("decode [options] <nnet-binary> <graph> "
                                  "<words.txt> <wav-list>")
    assert any(ln.strip().startswith("--ali ") for ln in perr)
