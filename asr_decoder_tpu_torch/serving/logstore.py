"""The v3 arena's search logs on its block's device, in pages.

Each channel row of a block keeps the logs of the frames it has decoded
(``prev_slot``, ``arc_id``, the token snapshots' states and costs) in
pages of ``P`` frames drawn from one pool on the device: leaves
``[NP, P, S, K]`` and ``[NP, P, K]`` (``FrameLog`` order).  A host page
table ``[rows, M]`` lists each row's pages in frame order, so frame ``t``
of row ``r`` lies in page ``pages[r, t // P]`` at ``t % P``.  The store
holds the live channels' frames, each rounded up to a page: its size is
their sum, not the longest channel times the rows.

Pages are reserved on the host when a push queues frames (``reserve``),
before any frame is written, so a tick never allocates.  The pool doubles
when it runs out of free pages, up to its limit (``default_bytes``: a
quarter of the device's memory): a reservation past that raises
``LogStoreFull`` and leaves the store as it was.  ``clear`` returns a row's pages.  Every
launch that reads or writes the pool runs on the device's one stream, in
order, so a page cleared and reserved again is written only after the
launches that read it before.

``write`` and ``walk`` are ``ops/traceback.py``'s ``store_frames`` and
``best_paths_rows`` over this store; ``frames`` copies one row's logs to
the host (a lattice or n-best).
"""

from __future__ import annotations

import numpy as np
import torch

from asr_decoder_tpu_torch.ops.beamsearch import FrameLog
from asr_decoder_tpu_torch.ops.traceback import (WalkTables, best_paths_rows,
                                                 store_frames)

PAGE_FRAMES = 32           # frames a page
CPU_BYTES = 4 << 30        # the pool's limit on the CPU


class LogStoreFull(RuntimeError):
    """A reservation the store cannot hold within its limit."""


def default_bytes(device: torch.device) -> int:
    """The pool's limit on ``device``: a quarter of a card's memory, or
    ``CPU_BYTES`` on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return CPU_BYTES


class LogStore:
    """One block's paged log store (module doc): ``rows`` channel rows of
    ``S`` stages and ``K`` slots on ``device``."""

    def __init__(self, rows: int, S: int, K: int, device: torch.device):
        self.P, self.S, self.K, self.device = PAGE_FRAMES, S, K, device
        # bytes a page: prev_slot and arc_id [S, K], snapshots [K], 32-bit
        self.page_bytes = self.P * (2 * S + 2) * K * 4
        self.max_pages = max(1, default_bytes(device) // self.page_bytes)
        self.pool = self._alloc(min(rows, self.max_pages))
        self.pages = np.full((rows, 1), -1, np.int32)
        self.held = np.zeros(rows, np.int64)        # pages each row holds
        self.free = list(range(len(self.pool.prev_slot) - 1, -1, -1))

    def _alloc(self, n: int) -> FrameLog:
        P, S, K = self.P, self.S, self.K
        return FrameLog(*(
            torch.empty((n, P, *mid, K), dtype=dtype, device=self.device)
            for mid, dtype in (((S,), torch.int32), ((S,), torch.int32),
                               ((), torch.int32), ((), torch.float32))))

    @property
    def num_pages(self) -> int:
        return len(self.pool.prev_slot)

    def reserve(self, row: int, frames: int) -> None:
        """Make row ``row`` hold pages for its first ``frames`` frames,
        growing the pool where no page is free; raises ``LogStoreFull``,
        with the store unchanged, past its limit."""
        need = -(-frames // self.P) - int(self.held[row])
        if need <= 0:
            return
        short = need - len(self.free)
        if short > 0:
            self._grow(short, row, frames)
        held = int(self.held[row])
        if held + need > self.pages.shape[1]:
            wide = np.full((len(self.pages),
                            max(2 * self.pages.shape[1], held + need)), -1,
                           np.int32)
            wide[:, :self.pages.shape[1]] = self.pages
            self.pages = wide
        for j in range(held, held + need):
            self.pages[row, j] = self.free.pop()
        self.held[row] = held + need

    def _grow(self, short: int, row: int, frames: int) -> None:
        """At least ``short`` more pages in the pool (it doubles), its pages
        copied over on the device."""
        have = self.num_pages
        if have + short > self.max_pages:
            raise LogStoreFull(
                f"log store full: row {row} needs {frames} frames; the pool "
                f"holds {have} pages of {self.P} frames "
                f"({have * self.page_bytes} bytes) of its limit of "
                f"{self.max_pages} ({self.max_pages * self.page_bytes} "
                f"bytes), {len(self.free)} free")
        new = min(max(2 * have, have + short), self.max_pages)
        try:
            pool = self._alloc(new)
        except torch.cuda.OutOfMemoryError as exc:
            raise LogStoreFull(
                f"log store full: no device memory for {new} pages of "
                f"{self.P} frames ({new * self.page_bytes} bytes) for row "
                f"{row}'s {frames} frames") from exc
        for a, b in zip(pool, self.pool):
            a[:have].copy_(b)
        self.pool = pool
        self.free[:0] = range(new - 1, have - 1, -1)

    def clear(self, row: int) -> None:
        """Return row ``row``'s pages to the pool."""
        held = int(self.held[row])
        self.free.extend(int(p) for p in self.pages[row, :held][::-1])
        self.pages[row, :held] = -1
        self.held[row] = 0

    def write(self, log, loglikes: torch.Tensor, rows, offs, valid
              ) -> torch.Tensor:
        """A tick's frames of ``rows`` into their pages and their loglikes
        packed (``ops/traceback.py:store_frames``)."""
        return store_frames(self.pool, log, loglikes, self.pages, rows, offs,
                            valid)

    def walk(self, tables: WalkTables, beam, init_log: FrameLog, rows,
             lengths) -> torch.Tensor:
        """The best paths of ``rows``, each over its first ``lengths``
        frames, from the block's beam and one-row init log
        (``ops/traceback.py:best_paths_rows``)."""
        return best_paths_rows(
            tables, beam.tok_state, beam.tok_cost, self.pool.prev_slot,
            self.pool.arc_id, self.pool.tok_state, init_log.prev_slot,
            init_log.arc_id, init_log.tok_state, self.pages, rows, lengths)

    def frames(self, row: int, n: int) -> FrameLog:
        """Row ``row``'s first ``n`` frames as a host log: [n, S, 1, K]
        logs, [n, 1, K] snapshots."""
        pages = torch.from_numpy(self.pages[row, :-(-n // self.P)]
                                 .astype(np.int64)).to(self.device)
        return FrameLog(*(
            a[pages].flatten(0, 1)[:n].unsqueeze(-2).to("cpu", copy=True)
            .numpy() for a in self.pool))
