"""Answered queries over the whole window (a PageRank call answers one
query per reset row); ``queries_per_s.bfs`` in the BFS cells and
``queries_per_s.pagerank`` in the PageRank cells, whose runs spread
differently, so each has its own bound."""


def read(run, name):
    answers = sum(op.get("answers", 0) for op in run["ops"])
    return answers / run["window_s"] if answers and run["window_s"] > 0 else None
