"""Channel-chunks a batched arena tick carries: ``AsrServer.chunks_decoded``
over ``AsrServer.dispatches``, their changes over the window."""


def read(data):
    (d0, c0), (d1, c1) = data.get("counters", ((0, 0), (0, 0)))
    return (c1 - c0) / (d1 - d0) if d1 > d0 else None
