"""Bytes of a version's own device storages (pool or codes and hi plane,
offsets, counts) over its edge count, averaged over the versions the
window published (a query cell: the one version it served); read from
the sizes of the program's storages.  Split by the end-to-end metric it
moves: ``.update`` in the writer cells, ``.bfs`` and ``.pagerank`` in the
query cells."""


def read(run, name):
    vals = [b / m for b, m in run["resident"] if m > 0]
    return sum(vals) / len(vals) if vals else None
