"""The served arena's paged log store (``asr_decoder_tpu_torch/serving/
logstore.py``) on the CPU: pages reserved a row at a time from a pool that
doubles up to its limit, refused past it with the store unchanged, given
back by ``clear``; frames written through it read back in order."""

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.ops.beamsearch import FrameLog
from asr_decoder_tpu_torch.serving import logstore
from asr_decoder_tpu_torch.serving.logstore import LogStore, LogStoreFull

S, K, P = 2, 8, 4
PAGE = P * (2 * S + 2) * K * 4


@pytest.fixture(autouse=True)
def small_pages(monkeypatch):
    monkeypatch.setattr(logstore, "PAGE_FRAMES", P)


def _store(rows=3, pages=6):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logstore, "CPU_BYTES", pages * PAGE)
        return LogStore(rows, S, K, torch.device("cpu"))


def test_reserve_grows_the_pool_and_the_table():
    st = _store()
    assert st.num_pages == 3 and st.pages.shape == (3, 1)
    st.reserve(0, 1)
    st.reserve(0, P)                   # the same page
    assert st.held.tolist() == [1, 0, 0]
    st.reserve(1, 3 * P + 1)           # four pages: the pool doubles
    assert st.num_pages == 6 and st.held.tolist() == [1, 4, 0]
    assert st.pages.shape[1] >= 4
    held = np.concatenate([st.pages[0, :1], st.pages[1, :4]])
    assert len(set(held.tolist())) == 5 and len(st.free) == 1
    assert set(held.tolist()) | set(st.free) == set(range(6))


def test_a_reservation_past_the_limit_changes_nothing():
    st = _store()
    st.reserve(0, 5 * P)
    pool, pages = st.pool, st.pages.copy()
    with pytest.raises(LogStoreFull, match="limit of 6"):
        st.reserve(1, 2 * P)
    assert st.pool is pool and np.array_equal(st.pages, pages)
    assert st.held.tolist() == [5, 0, 0] and len(st.free) == 1
    st.reserve(1, P)                   # the last free page still serves


def test_clear_returns_a_rows_pages():
    st = _store()
    st.reserve(0, 2 * P)
    st.reserve(2, 3 * P)
    st.clear(0)
    assert st.held.tolist() == [0, 0, 3] and (st.pages[0] == -1).all()
    assert len(st.free) == st.num_pages - 3
    st.reserve(1, 3 * P)               # from the freed pages, no growth
    assert st.num_pages == 6 and len(st.free) == 0


def test_frames_written_read_back_across_pages_and_growth():
    """Two ticks of frames into rows 0 and 2 (the second tick past the
    first pages, the pool growing between them): ``frames`` gives each
    row's frames in order, and the packed loglikes are the rows'."""
    st = _store(pages=12)
    g = torch.Generator().manual_seed(0)
    F, B, V = 5, 3, 4
    want = {0: [], 2: []}
    done = {0: 0, 2: 0}
    for tick in range(2):
        log = FrameLog(
            torch.randint(-3, 100, (F, S, B, K), generator=g,
                          dtype=torch.int32),
            torch.randint(-3, 100, (F, S, B, K), generator=g,
                          dtype=torch.int32),
            torch.randint(-3, 100, (F, B, K), generator=g,
                          dtype=torch.int32),
            torch.randn((F, B, K), generator=g))
        ll = torch.randn((B, F, V), generator=g)
        valid = {0: F, 2: 3 + tick}
        for r, v in valid.items():
            st.reserve(r, done[r] + v)
        rows = list(valid)
        packed = st.write(log, ll, rows, [done[r] for r in rows],
                          [valid[r] for r in rows])
        for i, r in enumerate(rows):
            v = valid[r]
            assert torch.equal(packed[i, :v], ll[r, :v])
            want[r].append([a[:v, ..., r:r + 1, :].numpy() for a in log])
            done[r] += v
    assert st.num_pages > 3
    for r in (0, 2):
        got = st.frames(r, done[r])
        for j, leaf in enumerate(got):
            np.testing.assert_array_equal(
                leaf, np.concatenate([w[j] for w in want[r]]))
