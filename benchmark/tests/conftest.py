"""The benchmark's CPU tests: every cell at a tiny size, on the CPU.

    python -m pytest benchmark/tests -q

A test marked ``cuda`` decides inside itself whether a card is there and
skips without one.  The tiny searches keep every token (a beam and a width
past what the tiny graphs hold), so their paths are the exact best ones
and ``search_gap`` reads rounding alone; a fault test cuts them to one
token a frame."""

import pytest
import torch

TINY_AM = {"am": {"feat_dim": 8, "context": 1, "proj": 6, "hidden": 5,
                  "num_layers": 2, "num_pdfs": 20, "skip": 2},
           "fbank": {"num_bins": 8},
           "graph": {"kind": "random_hclg", "num_states": 300,
                     "num_ilabels": 20},
           "search": {"beam": 1000.0, "beam_width": 512, "max_active": 512,
                      "min_active": 4, "arc_lanes": 8,
                      "eps_mode": "closure"}}
TINY_LENGTH = {"median_s": 1.0, "sigma": 0.5, "min_s": 0.5, "max_s": 2.0}
TINY = {
    "tlg2m.offline": {
        "config": {"graph": {"kind": "tlg", "num_phones": 8, "lm": {
            "vocab_size": 60, "n_bigram": 200, "n_trigram": 80,
            "n_4gram": 30}},
            "search": {"beam": 1000.0, "beam_width": 2048,
                       "max_active": 2048,
                       "min_active": 8, "arc_lanes": 16,
                       "eps_mode": "closure", "topk_overfetch": 1}},
        "params": {"batch": 3, "frames": 40, "pool": 2}},
    "hclg200k.offline": {
        "config": TINY_AM,
        "params": {"batch": 3, "wave_s": 1.5, "pool": 2, "sample_rows": 2}},
    "hclg200k.flood": {
        "config": TINY_AM,
        "params": {"clients": 4, "pool": 64, "warm_s": 1.0, "channels": 6,
                   "sample_utts": 3, "length": TINY_LENGTH}},
}
CELLS = sorted(TINY)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
                   "torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def manifest() -> dict:
    from benchmark import harness
    return harness.manifest()


def tiny(cell: str) -> dict:
    """Overrides of ``run_cell`` for ``cell`` at a tiny size (copies)."""
    import copy
    return copy.deepcopy(TINY[cell])
