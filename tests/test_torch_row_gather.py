"""The row-gather counterparts of the ``tools/perf`` TPU microbench kernels
(``make_dma_gather``, ``make_dma``, ``make_dma_dyn``), the tools that
drive them, and the port's other ``tools/perf`` modules.

On the CPU each counterpart runs the kernel's plain version and is held to
the JAX tools' XLA gathers (``xla_row_gather`` and ``t[i]``, the JAX
modules imported by path) at S = 4096, NIDX = 1024; on a GPU the CUDA
kernel is held to its plain version.  Every comparison is bit-exact: a
gather moves 32-bit words and computes nothing.  The dynamic variant
specifies rows below its live count only, so only those are compared.
Each tool also runs its smallest point on the CPU through injected sizes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.ops import fetch as F
from asr_decoder_tpu_torch.tools.perf import bench_dma_variants as DV
from asr_decoder_tpu_torch.tools.perf import bench_row_gather as RG

S, NIDX = 4096, 1024
WIDTHS = [128, 256, 512]
TOOLS = Path(__file__).resolve().parents[1] / "tools" / "perf"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _jax_tool(name):
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_array(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _inputs(W, seed=0, rows=S, nidx=NIDX):
    rng = np.random.default_rng(seed)
    table = rng.integers(-2**31, 2**31 - 1, (rows, W),
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, rows, nidx).astype(np.int32)
    return table, idx


def _cases(W):
    """(name, callable, live rows) of every counterpart at width W."""
    cases = [("make_dma", DV.make_dma(W), NIDX)]
    if W == 128:
        cases += [("make_dma_gather", RG.make_dma_gather(), NIDX)]
        cases += [(f"make_dma_dyn/{n}", DV.make_dma_dyn(W, n), n)
                  for n in (NIDX, NIDX // 4, NIDX // 16)]
    return cases


@pytest.mark.parametrize("W", WIDTHS)
def test_counterparts_match_jax_gathers(W):
    jrg = _jax_tool("bench_row_gather")
    table, idx = _inputs(W, seed=W)
    want = np.asarray(jrg.xla_row_gather(_jax_array(table), _jax_array(idx)))
    assert want.shape == (NIDX, W)
    np.testing.assert_array_equal(want, table[idx])          # t[i]
    for name, fn, n in _cases(W):
        got = fn(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
        assert got.shape == (NIDX, W), name
        np.testing.assert_array_equal(got[:n], want[:n], err_msg=name)


def test_row_gather_clamps_and_checks():
    """Out-of-range indices read the clamped row, as the kernel does; a
    width or shape the kernel does not take is refused."""
    table = torch.arange(6 * 128, dtype=torch.int32).reshape(6, 128)
    idx = torch.tensor([5, -4, 9, 0], dtype=torch.int32)
    got = F.row_gather(table, idx, torch.tensor([4], dtype=torch.int32))
    assert got[:, 0].tolist() == [640, 0, 640, 0]
    with pytest.raises(ValueError):
        DV.make_dma(256)(table, idx)
    with pytest.raises(ValueError):
        F.row_gather(table, idx[None], torch.tensor([4], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("W", WIDTHS)
def test_row_gather_kernel_matches_plain(cuda, W):
    """Each counterpart's kernel against the plain version on the card,
    at the JAX tools' shapes (2M rows, 131,072 indices)."""
    rows, nidx = 2_000_000, 131_072
    gen = torch.Generator(device=cuda).manual_seed(W)
    table = torch.randint(-2**31, 2**31 - 1, (rows, W), generator=gen,
                          device=cuda, dtype=torch.int32)
    idx = torch.randint(0, rows, (nidx,), generator=gen, device=cuda,
                        dtype=torch.int32)
    want = F.fetch_plain(table, idx[None])[0]
    cases = [("make_dma", DV.make_dma(W), nidx)]
    if W == 128:
        cases += [("make_dma_gather", RG.make_dma_gather(), nidx)]
        cases += [(f"make_dma_dyn/{n}", DV.make_dma_dyn(W, n), n)
                  for n in (131_072, 32_768, 8_192)]
    for name, fn, n in cases:
        before = F.launches
        got = fn(table, idx)
        torch.cuda.synchronize()
        assert F.launches == before + 1, name
        assert torch.equal(got[:n], want[:n]), name


@pytest.mark.cuda
@pytest.mark.parametrize("W", WIDTHS)
def test_row_gather_kernel_counts(cuda, W):
    """Device-side counts the microbenches never use: 0 (nothing read, the
    launch still counted), past N (read as N), and ragged ones that end
    inside a warp's 8 tokens or a block's 64; launched back to back on
    one stream with no sync between, then all checked."""
    rows, nidx = 100_000, 20_000
    gen = torch.Generator(device=cuda).manual_seed(W + 1)
    table = torch.randint(-2**31, 2**31 - 1, (rows, W), generator=gen,
                          device=cuda, dtype=torch.int32)
    counts = [0, nidx + 9, 1_000, 8_195, nidx - 1, 17, 0, nidx]
    idxs = [torch.randint(0, rows, (nidx,), generator=gen, device=cuda,
                          dtype=torch.int32) for _ in counts]
    before = F.launches
    outs = [F.row_gather(table, i, torch.tensor([n], dtype=torch.int32,
                                                device=cuda))
            for i, n in zip(idxs, counts)]
    torch.cuda.synchronize()
    assert F.launches == before + len(counts)
    for i, n, got in zip(idxs, counts, outs):
        assert got.shape == (nidx, W)
        want = F.fetch_plain(table, i[None])[0]
        assert torch.equal(got[:n], want[:n]), n


# -- the pairing helper (``tools/perf/_common.paired_ms``), stub timer --------

def _stub_timer(times):
    """A timer that records which callable it timed and returns the next
    of ``times``."""
    calls = []
    it = iter(times)

    def timer(fn):
        calls.append(fn())
        return next(it)
    return timer, calls


def test_paired_ms_alternates_order():
    """The kernel goes first in even pairs and the library in odd ones."""
    from asr_decoder_tpu_torch.tools.perf._common import paired_ms
    timer, calls = _stub_timer([1.0] * 10)
    p = paired_ms(lambda: "k", lambda: "l", 5, timer)
    assert calls == ["k", "l", "l", "k", "k", "l", "l", "k", "k", "l"]
    assert len(p["kernel"]) == len(p["library"]) == 5


def test_paired_ms_medians_and_wins():
    """Each side's times in pair order, their medians, and the pairs in
    which the kernel is strictly faster (a tie is no win)."""
    from asr_decoder_tpu_torch.tools.perf._common import paired_ms
    # pair order k l | l k | k l | l k: kernel 1, 5, 3, 4; library 2, 4,
    # 3, 9
    timer, _ = _stub_timer([1.0, 2.0, 4.0, 5.0, 3.0, 3.0, 9.0, 4.0])
    p = paired_ms(lambda: None, lambda: None, 4, timer)
    assert p["kernel"] == [1.0, 5.0, 3.0, 4.0]
    assert p["library"] == [2.0, 4.0, 3.0, 9.0]
    assert p["kernel_ms"] == 3.5 and p["library_ms"] == 3.5
    assert p["wins"] == 2


def test_paired_line_reports_medians_ranges_and_wins():
    from asr_decoder_tpu_torch.tools.perf._common import (paired_line,
                                                          paired_ms)
    timer, _ = _stub_timer([0.18, 0.19, 0.2, 0.17, 0.16, 0.19])
    p = paired_ms(lambda: None, lambda: None, 3, timer)
    assert paired_line("make_dma W=512", p) == (
        "make_dma W=512 paired with its library call, 3 alternating pairs: "
        "kernel 0.1700 ms [0.1600, 0.1800], library 0.1900 ms [0.1900, "
        "0.2000]; the kernel faster in 3 of 3")


def test_ab_tool_compares_live_rows_only():
    """The A/B tool's bit-exact gate between two builds looks at the rows
    below each live count and at nothing past them."""
    from asr_decoder_tpu_torch.tools.perf.bench_kernels_ab import (
        same_live_rows)
    a = torch.arange(2 * 5 * 3, dtype=torch.int32).reshape(2, 5, 3)
    b = a.clone()
    b[0, 2:] = -1                       # past live[0] = 2
    b[1, 4:] = -1                       # past live[1] = 4
    assert same_live_rows(a, b, torch.tensor([2, 4]))
    assert not same_live_rows(a, b, torch.tensor([3, 4]))
    assert not same_live_rows(a, b, torch.tensor([2, 5]))
    assert same_live_rows(a, b, torch.tensor([0, 0]))


# -- the tools, smallest point on the CPU ------------------------------------

def test_bench_row_gather_smoke(capsys):
    RG.main(["--device", "cpu", "--rows", "4096", "--nidx", "1024",
             "--repeats", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert [r.split()[0] for r in out[1:]] == ["xla", "dma"]
    assert all("ns/idx" in r and "GB/s" in r for r in out[1:])


def test_bench_dma_variants_smoke(capsys):
    DV.main(["--device", "cpu", "--rows", "4096", "--nidx", "1024",
             "--repeats", "2", "--sort-batch", "2", "--sort-div", "64"])
    out = capsys.readouterr().out
    for want in ("sort 3key [2,512] (v2 emit)", "top_k 512->64 [2]",
                 "dma W=512 (2048B rows)", "dma W=128 live=64",
                 "plain [512,32]",
                 "pair W=512 paired with its library call, 10 alternating",
                 "pair W=128 live=64 paired with its library call"):
        assert want in out, want
    assert "graph" not in out          # no CUDA graph on the CPU


def test_bench_points_smoke(capsys):
    from asr_decoder_tpu_torch.tools.perf import bench_points as BP
    rows = BP.run_point("headline", torch.device("cpu"), states=3000, B=2,
                        T=5, K=32)
    assert [r.split()[:2] for r in rows] == [["headline", "sort"],
                                              ["headline", "topk"]]
    assert all("ms/frame" in r and "(cpu)" in r for r in rows)
    assert capsys.readouterr().out.splitlines() == rows


def test_profile_production_smoke(capsys, tmp_path, monkeypatch):
    from asr_decoder_tpu_torch.tools.perf import profile_production as PP
    monkeypatch.setattr(PP, "BUILD_DIR", tmp_path)
    args = ["--device", "cpu", "--states", "3000", "--batch", "2",
            "--frames", "3", "--beam-width", "32",
            "--trace-dir", str(tmp_path / "trace")]
    PP.main(args)
    first = capsys.readouterr()
    assert (tmp_path / "prod_graph_3000.npz").exists()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert "search/emit3" in first.out and "aten::" in first.out
    PP.main(args)                          # the second run loads the cache
    assert "loaded cached graph" in capsys.readouterr().err


def test_scope_ranges_only_under_the_profiler(tmp_path):
    """A search range costs nothing with no profiler recording and shows by
    name in ``key_averages()`` under ``trace``; a program span opens a
    range only under the profiler, and is recorded either way."""
    from asr_decoder_tpu_torch.utils.profiling import scope, span, spans, \
        trace
    assert not isinstance(scope("test/idle"), torch.profiler.record_function)
    with span("test/span_idle") as idle:
        assert idle._range is None
    with trace(str(tmp_path)) as prof:
        with scope("test/double"):
            torch.ones(4) * 2
        with span("test/span") as traced:
            assert isinstance(traced._range, torch.profiler.record_function)
            torch.ones(4) * 3
    keys = {e.key for e in prof.key_averages()}
    assert "test/double" in keys and "test/span" in keys
    assert "test/span_idle" not in keys
    assert {"test/span_idle", "test/span"} <= {
        s.name for s in spans(idle.start, traced.end)}
    assert (tmp_path / "trace.json").exists()
