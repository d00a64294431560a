"""The port's state-record fetch (``asr_decoder_tpu_torch/ops/fetch.py``): CPU
parity with the JAX fetch (``impl="xla"``, narrow table, one state a row)
and, on a GPU, the CUDA kernel against its plain version.  Only rows below
``live[b]`` are specified, so only those are compared — bit-exactly."""

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.ops import fetch as F


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _inputs(S, L, B, K, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.integers(-2**31, 2**31 - 1, (S, L), dtype=np.int64)
    state = rng.integers(0, S, (B, K)).astype(np.int32)
    # live covers 0, partial and full; dead slots past it hold NO_STATE
    live = np.array([[0, K, K // 3, 1][b % 4] for b in range(B)], np.int32)
    state[np.arange(K)[None, :] >= live[:, None]] = -1
    return table.astype(np.int32), state, live


def _live_rows(out, live):
    return [out[b, :live[b]] for b in range(len(live))]


@pytest.mark.parametrize("L", [32, 64, 128, 256, 512])
def test_fetch_matches_jax(L):
    pytest.importorskip("jax")
    from asr_decoder_tpu.ops.fetch import fetch_pages
    table, state, live = _inputs(1000, L, 6, 40)
    got = F.fetch_records(torch.from_numpy(table), torch.from_numpy(state),
                          torch.from_numpy(live)).numpy()
    want = np.asarray(fetch_pages(table, state, live, 1, L, impl="xla"))
    assert got.shape == want.shape == (6, 40, L)
    for g, w in zip(_live_rows(got, live), _live_rows(want, live)):
        np.testing.assert_array_equal(g, w)


def test_fetch_rejects_bad_inputs():
    s = torch.zeros((2, 4), dtype=torch.int32)
    lv = torch.zeros(2, dtype=torch.int32)
    for L in (48, 1024):
        with pytest.raises(ValueError):
            F.fetch_records(torch.zeros((5, L), dtype=torch.int32), s, lv)
    with pytest.raises(TypeError):
        F.fetch_records(torch.zeros((5, 32)), s, lv)
    with pytest.raises(ValueError):
        F.fetch_records(torch.zeros((5, 32), dtype=torch.int32), s,
                        torch.zeros(3, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("S", [200_001, 2_500_000])
def test_fetch_kernel_matches_plain(cuda, S, L):
    table, state, live = _inputs(S, L, 16, 512, seed=L)
    t, s, lv = (torch.from_numpy(a).to(cuda) for a in (table, state, live))
    before = F.launches
    got = F.fetch_records(t, s, lv)
    want = F.fetch_plain(t, s)
    torch.cuda.synchronize()
    assert F.launches == before + 1
    for g, w in zip(_live_rows(got.cpu().numpy(), live),
                    _live_rows(want.cpu().numpy(), live)):
        np.testing.assert_array_equal(g, w)


def _ragged_live(B, K):
    """Live counts a row in turn: 0, K, K // 3, 1, past K, the int32
    maximum (both read as K), K - 1 and 17.  The ragged ones end inside
    a warp's 8 tokens and a block's 64 on the wide path, and inside a
    thread's 4 tokens on the narrow one."""
    return np.array([[0, K, K // 3, 1, K + 5, 2**31 - 1, K - 1, 17][b % 8]
                     for b in range(B)], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("B,K", [(16, 512), (3, 37), (1, 4096), (256, 512)])
def test_fetch_kernel_live_counts(cuda, L, B, K):
    """Every record width at the search's (B, K) and ragged ones: live 0,
    partial, full and past K (every row live in the last case), states
    out of range clamped, states repeated within a row, the live rows
    bit-exact."""
    table, state, _ = _inputs(5000, L, B, K, seed=B + K + L)
    rng = np.random.default_rng(L)
    live = _ragged_live(B, K)
    state = np.where(rng.random(state.shape) < 0.05, 5000 + 7, state)
    state = np.where(rng.random(state.shape) < 0.02, -3, state)
    dup = rng.random(state.shape) < 0.1
    state[dup] = np.broadcast_to(state[:, :1], state.shape)[dup]
    if B == 256:
        live[:] = K
        state = rng.integers(-2, 5002, (B, K)).astype(np.int32)
    t, s, lv = (torch.from_numpy(a).to(cuda) for a in (table, state, live))
    before = F.launches
    got = F.fetch_records(t, s, lv)
    want = F.fetch_plain(t, s)
    torch.cuda.synchronize()
    assert F.launches == before + 1
    for g, w in zip(_live_rows(got.cpu().numpy(), live),
                    _live_rows(want.cpu().numpy(), live)):
        np.testing.assert_array_equal(g, w)
