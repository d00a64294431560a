"""The port's batched gather (``asr_decoder_tpu_torch/ops/gather.py``): CPU
parity with the JAX gather (both of its paths) and, on a GPU, the CUDA
kernel against its plain version.  Every comparison is bit-exact: a gather
moves 32-bit words and computes nothing."""

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.ops import gather as G


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _inputs(B, V, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((B, V)).astype(np.float32)
    if dtype == np.int32:
        table = table.view(np.int32)          # every bit pattern, NaNs too
    idx = rng.integers(0, V, (B, N)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("B,V,N", [(4, 256, 512), (1, 9, 40), (8, 2048, 128)])
def test_gather_matches_jax(B, V, N, dtype):
    pytest.importorskip("jax")
    from asr_decoder_tpu.ops.gather import batched_table_gather as jax_gather
    table, idx = _inputs(B, V, N, dtype)
    got = G.batched_table_gather(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy()
    for force in ("xla", "interpret"):
        want = np.asarray(jax_gather(table, idx, force=force))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_gather_rejects_bad_inputs():
    t = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        G.batched_table_gather(t, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(TypeError):
        G.batched_table_gather(t.double(), torch.zeros((2, 3),
                                                       dtype=torch.int32))
    with pytest.raises(ValueError):
        G.batched_table_gather(t, torch.zeros((3, 3), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("V,N", [(2048, 4096), (4096, 1024), (2560, 1024),
                                 (1024, 512), (512, 512), (65536, 4096),
                                 (9, 40)])
def test_gather_kernel_matches_plain(cuda, V, N, dtype):
    table, idx = _inputs(32, V, N, dtype, seed=V + N)
    t, i = torch.from_numpy(table).to(cuda), torch.from_numpy(idx).to(cuda)
    before = G.launches
    got = G.batched_table_gather(t, i)
    (want,) = G.gather_plain_many((t,), i)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    assert got.dtype == t.dtype and got.shape == (32, N)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("V,N", [(512 * 8 + 2 * 512, 512), (512 * 8, 4096),
                                 (512 * 4 + 512, 512)])
def test_gather_kernel_at_graph_type_shapes(cuda, V, N, dtype):
    """The shapes the clg and biglm-hclg searches give the kernel at B=16,
    K=512: the CLG ε-stage table [B, K·Ae + 2K] (Ae = 8) read at the K
    winners, the BigLM emit-stage compaction [B, K·A] (A = 8) permuted
    whole, and a BigLM ε-stage table [B, K·L + K] (L = 4)."""
    table, idx = _inputs(16, V, N, dtype, seed=V + 7 * N)
    t, i = torch.from_numpy(table).to(cuda), torch.from_numpy(idx).to(cuda)
    before = G.launches
    got = G.batched_table_gather(t, i)
    (want,) = G.gather_plain_many((t,), i)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _many_inputs(P, B, V, N, seed, offset=0):
    """P tables [B, V] (f32 and i32 in turn, every bit pattern) and one
    index [B, N] with out-of-range values mixed in; ``offset`` words in
    front of each array's storage shift its rows off 16-byte alignment."""
    rng = np.random.default_rng(seed)
    tables = []
    for p in range(P):
        t = rng.standard_normal(B * V + offset).astype(np.float32)
        t = torch.from_numpy(t)[offset:].view(B, V)
        tables.append(t if p % 2 == 0 else t.view(torch.int32))
    idx = rng.integers(-3, V + 3, B * N + offset).astype(np.int32)
    return tables, torch.from_numpy(idx)[offset:].view(B, N)


@pytest.mark.parametrize("P", [1, 3, 8])
def test_gather_many_matches_jax(P):
    """Each output of the multi-table form equals the JAX gather of its
    table (both JAX paths), bit for bit."""
    pytest.importorskip("jax")
    from asr_decoder_tpu.ops.gather import batched_table_gather as jax_gather
    tables, idx = _many_inputs(P, 4, 300, 130, seed=P)
    idx = idx.clamp(0, 299)
    got = G.batched_table_gather_many(tables, idx)
    assert len(got) == P
    for t, g in zip(tables, got):
        assert g.dtype == t.dtype and g.shape == (4, 130)
        for force in ("xla", "interpret"):
            want = np.asarray(jax_gather(t.numpy(), idx.numpy(),
                                         force=force))
            np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                          want.view(np.int32))


def test_gather_many_rejects_bad_inputs():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    t = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        G.batched_table_gather_many([], idx)
    with pytest.raises(ValueError):
        G.batched_table_gather_many([t] * 9, idx)
    with pytest.raises(ValueError):
        G.batched_table_gather_many([t, torch.zeros((2, 9))], idx)
    with pytest.raises(TypeError):
        G.batched_table_gather_many([t, t.long()], idx)


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(1, 9))
@pytest.mark.parametrize("B,V,N,offset", [
    (1, 2048, 4096, 0), (3, 1001, 37, 0), (2, 1001, 516, 1),
    (2, 30000, 515, 0), (5, 6, 1029, 3), (32, 8192, 4096, 0),
    (256, 2048, 4096, 0)])
def test_gather_many_kernel_matches_plain(cuda, P, B, V, N, offset):
    """Against the plain version over clamped indices, one launch: V and N
    not multiples of 4 and rows and indices off 16-byte alignment (the
    scalar path), B = 1, block sizes from 32 to 256 threads, P = 1..8."""
    tables, idx = _many_inputs(P, B, V, N, seed=P * V + N, offset=offset)
    tables = [t.to(cuda) for t in tables]
    idx = idx.to(cuda)
    want = G.gather_plain_many(tables, idx.clamp(0, V - 1))
    before = G.launches
    got = G.batched_table_gather_many(tables, idx)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (B, N)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
