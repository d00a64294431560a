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
    want = G.gather_plain(t, i)
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
    want = G.gather_plain(t, i)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
