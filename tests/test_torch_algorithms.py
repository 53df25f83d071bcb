"""The paper's remaining algorithms and baselines in the port
(``repro_torch.core.algorithms``, ``repro_torch.core.baselines``) and the
``aspen-stream`` config, held bit for bit against the reference on the
same numpy inputs: counterparts of ``tests/test_aspen.py``'s
``test_mis_valid``, ``test_two_hop_and_local_cluster``,
``test_baselines_agree_with_aspen``, ``test_pagerank_cc`` and
``test_bfs_matches_oracle``.  Host code in both packages (numpy and the
host C-tree), so the answers must be identical."""
import ast
from pathlib import Path

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs import aspen_stream as jcfg
from repro.core import algorithms as jalg
from repro.core import baselines as jbl
from repro.core import graph as jG
from repro.data.rmat import rmat_edges, symmetrize
from repro_torch.configs import registry as treg
from repro_torch.configs import aspen_stream as tcfg
from repro_torch.core import algorithms as talg
from repro_torch.core import baselines as tbl
from repro_torch.core import graph as tG

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module")
def small_graph():
    edges = symmetrize(rmat_edges(8, 2000, seed=7))  # 256 vertices
    return 256, edges


@pytest.fixture(scope="module")
def both(small_graph):
    n, edges = small_graph
    jg, tg = jG.build_graph(n, edges), tG.build_graph(n, edges)
    return jg, tg, jG.flat_snapshot(jg), tG.flat_snapshot(tg)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_mis_matches_reference(both, seed):
    _, _, js, ts = both
    got, want = talg.mis(ts, seed=seed), jalg.mis(js, seed=seed)
    _eq(got, want)
    assert talg.verify_mis(ts, got) and jalg.verify_mis(js, want)


def test_verify_mis_rejects_what_the_reference_rejects(both):
    _, _, js, ts = both
    s = talg.mis(ts)
    dependent = s.copy()
    v = int(np.flatnonzero(s)[0])
    dependent[ts.neighbors(v)[0]] = True  # two neighbours in the set
    not_maximal = s.copy()
    not_maximal[v] = False  # v and maybe its neighbours uncovered
    for bad in (dependent, not_maximal):
        assert talg.verify_mis(ts, bad) == jalg.verify_mis(js, bad)
    assert not talg.verify_mis(ts, dependent)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_two_hop_and_local_cluster_match_reference(small_graph, both, which):
    n, edges = small_graph
    jg, tg, _, _ = both
    src = int(edges[[0, len(edges) // 2, -1][which], 0])
    th = talg.two_hop(tg, src)
    _eq(th, jalg.two_hop(jg, src))
    adj = {}  # the reference test's oracle
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
    two = set(adj.get(src, set()))
    for u in adj.get(src, set()):
        two |= adj.get(u, set())
    two.discard(src)
    np.testing.assert_array_equal(th, np.asarray(sorted(two)))
    cluster = talg.local_cluster(tg, src)
    _eq(cluster, jalg.local_cluster(jg, src))
    assert src in cluster.tolist()
    _eq(talg.local_cluster(tg, src, eps=1e-3, T=4, alpha=0.3),
        jalg.local_cluster(jg, src, eps=1e-3, T=4, alpha=0.3))


def test_two_hop_of_a_missing_vertex_is_empty(both):
    jg, tg, _, _ = both
    _eq(talg.two_hop(tg, 10_000), jalg.two_hop(jg, 10_000))


@pytest.mark.parametrize("diropt", [False, True])
def test_global_wrappers_match_reference(small_graph, both, diropt):
    n, edges = small_graph
    _, _, js, ts = both
    src = int(edges[0, 0])
    parents = talg.bfs(ts, src, direction_optimize=diropt)
    _eq(parents, jalg.bfs(js, src, direction_optimize=diropt))
    edge_set = set((int(u), int(v)) for u, v in edges)
    for v in range(n):  # a valid BFS tree
        if parents[v] >= 0 and v != src:
            assert (int(parents[v]), v) in edge_set
    _eq(talg.bc(ts, src), jalg.bc(js, src))
    pr = talg.pagerank(ts, iters=20)
    _eq(pr, jalg.pagerank(js, iters=20))
    np.testing.assert_allclose(pr.sum(), 1.0, rtol=1e-6)
    cc = talg.connected_components(ts)
    _eq(cc, jalg.connected_components(js))
    assert (cc[edges[:, 0]] == cc[edges[:, 1]]).all()


def _stores(pkg, n, edges):
    st = pkg.StingerLike(n)
    st.insert_edges(edges)
    return {"stinger": st, "csr": pkg.StaticCSR(n, edges), "llama": pkg.LlamaLike(n, edges),
            "ccsr": pkg.CompressedCSR(n, edges)}


def test_baselines_match_reference(small_graph):
    n, edges = small_graph
    t, j = _stores(tbl, n, edges), _stores(jbl, n, edges)
    src = int(edges[0, 0])
    for name in t:
        assert t[name].nbytes() == j[name].nbytes(), name
        for v in range(0, n, 7):
            _eq(t[name].neighbors(v), j[name].neighbors(v))
            assert t[name].degree(v) == j[name].degree(v)
        _eq(tbl.bfs_adjacency(t[name], src), jbl.bfs_adjacency(j[name], src))
    for v in range(0, n, 29):  # the reference test's checks, against the edges
        expect = np.unique(edges[edges[:, 0] == v][:, 1])
        np.testing.assert_array_equal(np.sort(t["stinger"].neighbors(v)), expect)
        np.testing.assert_array_equal(t["csr"].neighbors(v), expect)
        np.testing.assert_array_equal(t["llama"].neighbors(v), expect)
    p1, p2 = tbl.bfs_adjacency(t["stinger"], src), tbl.bfs_adjacency(t["csr"], src)
    assert ((p1 >= 0) == (p2 >= 0)).all()


def test_baseline_updates_match_reference(small_graph):
    """Inserts, deletes and a rebuild move both packages' stores alike."""
    n, edges = small_graph
    t, j = _stores(tbl, n, edges), _stores(jbl, n, edges)
    rng = np.random.default_rng(5)
    batch = rng.integers(0, n, (300, 2))
    for pkg, s in ((tbl, t), (jbl, j)):
        s["stinger"].insert_edges(batch)
        s["stinger"].delete_edges(edges[::3])
        s["llama"].insert_edges(batch)
        s["csr"] = s["csr"].insert_edges(batch)
    for name in ("stinger", "llama", "csr"):
        assert t[name].nbytes() == j[name].nbytes() and t[name].m == j[name].m
        for v in range(0, n, 11):
            _eq(np.sort(t[name].neighbors(v)), np.sort(j[name].neighbors(v)))


def test_aspen_stream_config_matches_reference():
    spec, ref = treg.get("aspen-stream"), jreg.get("aspen-stream")
    assert (spec.arch_id, spec.family, spec.shapes) == (ref.arch_id, ref.family, ref.shapes)
    assert treg.STREAM_SHAPES == jreg.STREAM_SHAPES
    for which in ("FULL", "REDUCED"):
        t, j = getattr(tcfg, which), getattr(jcfg, which)
        assert dataclass_items(t) == dataclass_items(j)
    assert "aspen-stream" in treg.ARCH_IDS


def dataclass_items(c):
    return [(f, getattr(c, f)) for f in c.__dataclass_fields__]


@pytest.mark.parametrize("module", ["core/algorithms.py", "core/baselines.py",
                                    "configs/aspen_stream.py", "kernels/autotune.py"])
def test_modules_import_neither_jax_nor_repro(module):
    tree = ast.parse((SRC / module).read_text())
    names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.level == 0]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
