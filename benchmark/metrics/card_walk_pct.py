"""Share of the replies in the window whose best path came from the device
round's walk over the arena's log store (the program's ``path/card`` spans,
one a reply built by ``get_best_path_from``) among every reply's path
(``path/card`` and ``path/host``, the latter walked over host logs), in %.
None where the program records neither (a version that walks every reply
on the host records no such span), or its ring overwrote the window."""

from benchmark.metrics import _spans


def read(data):
    got = _spans.window(*data["window"])
    if got is None:
        return None
    card = sum(s.name == "path/card" for s in got)
    host = sum(s.name == "path/host" for s in got)
    return 100.0 * card / (card + host) if card + host else None
