"""The port's distributed tier (``pygraphblas_tpu_torch.parallel`` and
``Matrix.shard``) against the JAX package's on the CPU.

The port runs on a 2 x 2 mesh of four spawned gloo ranks
(``testing.RankPool``: one spawn for this file, each rank on one
thread); the JAX tier on ``make_mesh(4)``, a 2 x 2 mesh of the virtual
CPU devices (tests/conftest.py).  Both get the same seeded numpy inputs.
Every rank must return the same host result.  Indices, patterns,
levels, counts and integer values are compared exactly; FP32 PageRank
within 1e-5 absolute, FP32 products within 1e-5 relative."""

import networkx as nx
import numpy as np
import pytest

import pygraphblas_tpu as J
from pygraphblas_tpu.parallel import dist as jdist
from pygraphblas_tpu.parallel import checkpoint as jckpt
from pygraphblas_tpu_torch.testing import RankPool

PR_ATOL = 1e-5
RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jmesh():
    return jdist.make_mesh(4)


def _same(results):
    """The ranks' results, checked equal on every rank; rank 0's."""
    first = results[0]
    for other in results[1:]:
        _assert_equal(first, other)
    return first


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


def _undirected_edges(G):
    rows, cols = [], []
    for u, v in G.edges():
        rows += [u, v]
        cols += [v, u]
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64)


def _spec(typ, n, m, r, c, v):
    """A matrix both ways: the JAX package's, and the port's as the
    (type, n, m, r, c, v) that the ranks build (testing._matrix)."""
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    T = getattr(J.types, typ)
    v = np.asarray(v).astype(T._numpy_t)
    A = J.Matrix.sparse(T, n, m)
    A._build(r, c, v)
    return A, (typ, n, m, r, c, v)


def _jsem(name):
    typ, sem = name.split(".")
    return getattr(getattr(J.types, typ), sem)


def _coo_close(got, want, exact):
    """Port triples (or pairs) against the JAX package's: indices equal,
    values equal (exact) or within RTOL."""
    *gi, gv = got
    *wi, wv = want
    for a, b in zip(gi, wi):
        assert np.array_equal(a, b)
    if exact:
        assert np.array_equal(gv, wv)
    else:
        assert np.allclose(gv, wv, rtol=RTOL)


def test_mesh_is_the_jax_mesh(ranks, jmesh):
    """make_mesh(4) on four ranks: a 2 x 2 mesh named ("i", "j") in
    row-major rank order, as the JAX package's make_mesh(4); another
    size than the world is refused; a second call gives the same mesh."""
    got = ranks.run("mesh")
    assert dict(jmesh.shape) == {"i": 2, "j": 2}
    want_devs = np.asarray(jmesh.devices).reshape(-1)
    for r, g in enumerate(got):
        assert g["shape"] == dict(jmesh.shape)
        assert g["rank"] == r
        assert g["coordinate"] == divmod(r, 2)
        assert g["ranks"] == [[0, 1], [2, 3]]
        assert g["device"] == "cpu" and g["same"]
        assert "world of 4 ranks" in g["refused"]
        # the JAX mesh holds its devices in the same row-major order
        assert jmesh.devices[divmod(r, 2)] == want_devs[r]


def test_dist_spmv_matches_jax(ranks, jmesh):
    """DistSpMV's whole y on a random 50 x 50 (FP32 PLUS_TIMES, MIN_TIMES)
    and on a 37 x 53 rectangle (row and column blocks of other sizes)."""
    import jax

    rng = np.random.RandomState(0)
    for n, m in ((50, 50), (37, 53)):
        keys = np.unique(rng.randint(0, n * m, 300))
        rows, cols = keys // m, keys % m
        vals = rng.rand(len(rows)).astype(np.float32)
        x = rng.rand(m).astype(np.float32)
        cases = [("PLUS", "TIMES", "float32"), ("MIN", "TIMES", "float32")]
        got = _same(ranks.run("spmv", n=n, m=m, rows=rows, cols=cols,
                              vals=vals, x=x, cases=cases))
        for (add, mul, dt), y in zip(cases, got):
            s = jdist.DistSpMV(jmesh, n, m, rows, cols, vals, add=add,
                               mul=mul)
            xp = np.zeros(s.ncols_p, np.float32)
            xp[:m] = x
            want = np.asarray(s(jax.numpy.asarray(xp)))
            assert y.shape == want.shape
            present = np.zeros(len(want), bool)
            present[rows] = True
            assert np.allclose(y[present], want[present], rtol=RTOL)
            # absent rows hold the fold's empty fill, as JAX's
            assert np.array_equal(y[~present], want[~present])


def test_dist_pagerank_matches_jax(ranks, jmesh):
    """dist_pagerank on the karate club (and networkx), and one
    dist_pagerank_step from the same vectors."""
    import jax

    G = nx.karate_club_graph()
    rows, cols = _undirected_edges(G)
    n = G.number_of_nodes()
    s = jdist.DistSpMV(jmesh, 36, 36, cols, rows,
                       np.ones(len(rows), np.float32), add="PLUS",
                       mul="SECOND")
    rng = np.random.RandomState(8)
    r, d_inv = rng.rand(2, 36).astype(np.float32)
    want_r, want_d = jax.jit(lambda a, b: jdist.dist_pagerank_step(
        s, a, b, np.float32(0.01)))(jax.device_put(r, s.y_spec),
                                    jax.device_put(d_inv, s.y_spec))
    got_r, got_d = _same(ranks.run("pagerank_step", n=36, rows=rows,
                                   cols=cols, r=r, d_inv=d_inv,
                                   teleport=0.01))
    assert np.allclose(got_r, np.asarray(want_r), atol=PR_ATOL)
    assert abs(got_d - float(want_d)) <= RTOL * float(want_d)
    got = _same(ranks.run("pagerank", nrows=n, rows=rows, cols=cols,
                          damping=0.85, itermax=100, tol=1e-7))
    want = jdist.dist_pagerank(jmesh, n, rows, cols, damping=0.85,
                               itermax=100, tol=1e-7)
    assert np.allclose(got, want, atol=PR_ATOL)
    expect = nx.pagerank(G, alpha=0.85, tol=1e-10, weight=None)
    assert max(abs(got[k] - v) for k, v in expect.items()) < 1e-3


def test_dist_pagerank_checkpoint_resume(ranks, jmesh, tmp_path):
    """An interrupted run resumed from its snapshot equals the
    uninterrupted run bit for bit (one thread a rank on the CPU), and
    the snapshots cross between the packages: the same file fields and
    signature, each package resuming the other's."""
    G = nx.gnm_random_graph(200, 1500, seed=4, directed=True)
    rows = np.asarray([u for u, v in G.edges()], np.int64)
    cols = np.asarray([v for u, v in G.edges()], np.int64)
    kw = dict(nrows=200, rows=rows, cols=cols, tol=0.0)
    ck = str(tmp_path / "port.npz")
    full = _same(ranks.run("pagerank", itermax=20, **kw))
    _same(ranks.run("pagerank", itermax=10, checkpoint_path=ck,
                    checkpoint_every=5, **kw))
    resumed = _same(ranks.run("pagerank", itermax=20, checkpoint_path=ck,
                              checkpoint_every=5, **kw))
    assert np.array_equal(full, resumed)
    jfull = jdist.dist_pagerank(jmesh, 200, rows, cols, itermax=20, tol=0.0)
    assert np.allclose(full, jfull, atol=PR_ATOL)

    jck = str(tmp_path / "jax.npz")
    jdist.dist_pagerank(jmesh, 200, rows, cols, itermax=10, tol=0.0,
                        checkpoint_path=jck, checkpoint_every=5)
    pk, jk = np.load(ck), np.load(jck)
    assert pk.files == jk.files
    assert str(pk["__signature__"]) == str(jk["__signature__"])
    assert (int(pk["__step__"]), int(jk["__step__"])) == (20, 10)
    from_jax = _same(ranks.run("pagerank", itermax=20, checkpoint_path=jck,
                               checkpoint_every=5, **kw))
    assert np.allclose(from_jax, jfull, atol=PR_ATOL)
    ck10 = str(tmp_path / "port10.npz")
    _same(ranks.run("pagerank", itermax=10, checkpoint_path=ck10,
                    checkpoint_every=5, **kw))
    from_port = jdist.dist_pagerank(jmesh, 200, rows, cols, itermax=20,
                                    tol=0.0, checkpoint_path=ck10,
                                    checkpoint_every=5)
    assert np.allclose(from_port, jfull, atol=PR_ATOL)


def test_checkpoint_and_elastic_run(ranks, tmp_path):
    """save_state from every rank writes rank 0's arrays once; every rank
    loads them; a mismatched signature is refused; elastic_run restarts
    from its snapshot after injected faults, as the JAX package's."""
    path = str(tmp_path / "state.npz")
    got = _same(ranks.run("checkpoint", path=path, signature="sig"))
    assert got["step"] == 3
    assert np.array_equal(got["x"], np.arange(4))
    assert got["refused"] is None
    assert got["fails_left"] == 0
    fails = {"left": 2}

    def step(i, state):
        if i == 3 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("injected fault")
        return {"x": state["x"] + 1}

    want = jckpt.elastic_run(step, {"x": np.zeros(4)}, 6,
                             checkpoint_path=str(tmp_path / "j.npz"),
                             signature="elastic", checkpoint_every=2)
    assert np.array_equal(got["elastic"], want["x"])
    # the JAX package reads the port's snapshot
    step_j, arrays = jckpt.load_state(path, "sig")
    assert step_j == 3 and np.array_equal(arrays["x"], np.arange(4))


def test_matrix_shard_mxv_and_tc(ranks, jmesh):
    """Matrix.shard(mesh): mxv under PLUS_TIMES and MIN_TIMES and the
    triangle count, against the JAX package's DistMatrix."""
    G = nx.gnm_random_graph(400, 3000, seed=7)
    rows, cols = _undirected_edges(G)
    A, spec = _spec("FP32", 400, 400, rows, cols, np.ones(len(rows)))
    D = A.shard(jmesh)
    x = np.random.RandomState(0).rand(400).astype(np.float32)
    for sem in ("FP32.PLUS_TIMES", "FP32.MIN_TIMES"):
        got = _same(ranks.run("shard", A=spec, op="mxv", x=x, semiring=sem))
        want = D.mxv(x, semiring=_jsem(sem))._coo()
        _coo_close(got, want, exact=False)
    tc = _same(ranks.run("shard", A=spec, op="triangle_count"))
    assert tc == D.triangle_count() == sum(nx.triangles(G).values()) // 3


def test_dist_mxv_output_pattern(ranks, jmesh):
    """Only rows with contributions are in mxv's output (no
    identity-valued entries); transposed too."""
    A, spec = _spec("FP32", 64, 64, [0, 0, 5], [1, 2, 3], [1.0, 2.0, 3.0])
    D = A.shard(jmesh)
    x = np.ones(64, np.float32)
    for tr in (False, True):
        got = _same(ranks.run("shard", A=spec, op="mxv", x=x,
                              semiring="FP32.MIN_TIMES", transpose=tr))
        want = D.mxv(x, semiring=J.types.FP32.MIN_TIMES, transpose=tr)._coo()
        _coo_close(got, want, exact=True)
    assert list(got[0]) == [1, 2, 3]


def test_matrix_shard_pagerank(ranks, jmesh):
    G = nx.gnm_random_graph(300, 2500, seed=9, directed=True)
    rows = [u for u, v in G.edges()]
    cols = [v for u, v in G.edges()]
    A, spec = _spec("FP32", 300, 300, rows, cols, np.ones(len(rows)))
    got = _same(ranks.run("shard", A=spec, op="pagerank", tol=1e-8))
    want = A.shard(jmesh).pagerank(tol=1e-8).to_numpy()
    assert np.allclose(got, want, atol=PR_ATOL)


def test_dist_vector_chaining(ranks, jmesh):
    """DistVector: three mxv in a row stay on the devices (each result a
    DistVector) and match the JAX package's chain; to_vector too."""
    rng = np.random.RandomState(5)
    n = 96
    keys = np.unique(rng.randint(0, n * n, 800))
    r, c = keys // n, keys % n
    v = rng.rand(len(r)).astype(np.float32)
    A, spec = _spec("FP32", n, n, r, c, v)
    dense, vec = _same(ranks.run("shard", A=spec, op="chain", steps=3))
    D = A.shard(jmesh)
    y = D.vector(fill=1.0, typ=J.types.FP32)
    for _ in range(3):
        y = D.mxv(y, semiring=J.types.FP32.PLUS_TIMES)
    assert np.allclose(dense, y.to_numpy(), rtol=RTOL)
    _coo_close(vec, y.to_vector()._coo(), exact=False)


def test_dist_mxv_mask_accum(ranks, jmesh):
    rng = np.random.RandomState(6)
    n = 64
    keys = np.unique(rng.randint(0, n * n, 400))
    r, c = keys // n, keys % n
    v = rng.rand(len(r)).astype(np.float32)
    A, spec = _spec("FP32", n, n, r, c, v)
    x = rng.rand(n).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[: n // 2] = True
    got, total = _same(ranks.run("shard", A=spec, op="mxv_mask_accum", x=x,
                                 mask=mask, semiring="FP32.PLUS_TIMES"))
    D = A.shard(jmesh)
    prev = D.vector(fill=2.0, typ=J.types.FP32)
    y = D.mxv(x, semiring=J.types.FP32.PLUS_TIMES, mask=mask,
              accum="PLUS", out=prev, out_dist=True)
    assert np.allclose(got, y.to_numpy(), rtol=RTOL)
    # the padded slots' fill is summed too, as the JAX package's
    assert abs(total - y.reduce_float()) <= RTOL * abs(total)


def test_dist_triangle_count(ranks, jmesh):
    """A random graph, the ring with distance-2 chords (n triangles), and
    the heavy-edge host path (the width cap lowered in both packages)."""
    G = nx.gnm_random_graph(500, 4000, seed=11)
    rows, cols = _undirected_edges(G)
    want = sum(nx.triangles(G).values()) // 3
    assert jdist.dist_triangle_count(jmesh, 500, rows, cols) == want
    assert _same(ranks.run("triangles", nrows=500, rows=rows,
                           cols=cols)) == want
    old = jdist._TC_WIDTH_CAP
    jdist._TC_WIDTH_CAP = 16
    try:
        heavy = jdist.dist_triangle_count(jmesh, 500, rows, cols)
    finally:
        jdist._TC_WIDTH_CAP = old
    assert heavy == want
    assert _same(ranks.run("triangles", nrows=500, rows=rows, cols=cols,
                           width_cap=16)) == want
    n = 1 << 12
    src = np.arange(n, dtype=np.int64)
    e1, e2 = (src + 1) % n, (src + 2) % n
    rows = np.concatenate([src, e1, src, e2])
    cols = np.concatenate([e1, src, e2, src])
    assert jdist.dist_triangle_count(jmesh, n, rows, cols) == n
    assert _same(ranks.run("triangles", nrows=n, rows=rows, cols=cols)) == n


def test_dist_bfs_sssp(ranks, jmesh):
    """bfs_level on a random graph and on an RMAT graph (the balance
    relabel), sssp on a weighted digraph: levels exact, distances within
    RTOL, patterns exact."""
    from pygraphblas_tpu.generators import rmat_edges

    G = nx.gnm_random_graph(300, 1200, seed=5)
    rows, cols = _undirected_edges(G)
    A, spec = _spec("BOOL", 300, 300, rows, cols, np.ones(len(rows)))
    got = _same(ranks.run("shard", A=spec, op="bfs_level", source=0))
    _coo_close(got, A.shard(jmesh).bfs_level(0)._coo(), exact=True)

    r, c, n = rmat_edges(9, 8, seed=3)
    r, c = np.concatenate([r, c]), np.concatenate([c, r])
    keys = np.unique(r.astype(np.int64) * n + c)
    A, spec = _spec("FP32", n, n, keys // n, keys % n, np.ones(len(keys)))
    got = _same(ranks.run("shard", A=spec, op="bfs_level", source=1))
    _coo_close(got, A.shard(jmesh).bfs_level(1)._coo(), exact=True)

    rng = np.random.RandomState(11)
    n, m = 200, 1500
    keys = np.unique(rng.randint(0, n, m).astype(np.int64) * n
                     + rng.randint(0, n, m))
    r, c = keys // n, keys % n
    keep = r != c
    w = rng.uniform(0.1, 5.0, int(keep.sum())).astype(np.float32)
    A, spec = _spec("FP32", n, n, r[keep], c[keep], w)
    got = _same(ranks.run("shard", A=spec, op="sssp", source=0))
    _coo_close(got, A.shard(jmesh).sssp(0)._coo(), exact=False)


def test_dist_masked_mxm(ranks, jmesh):
    """DistMatrix.mxm (the ring masked SpGEMM with values) against the
    JAX package's under FP32 PLUS_TIMES, MIN_PLUS, MAX_FIRST, PLUS_PAIR
    and INT32 MIN_PLUS (exact)."""
    rng = np.random.RandomState(29)
    n = 120

    def rand(nnz, typ, vals=None):
        k = rng.choice(n * n, size=nnz, replace=False)
        v = vals if vals is not None else rng.uniform(0.5, 4.0, nnz)
        if typ == "INT32":
            v = rng.randint(1, 9, nnz)
        return _spec(typ, n, n, k // n, k % n, v)

    for typ, sems in (("FP32", ("PLUS_TIMES", "MIN_PLUS", "MAX_FIRST",
                                "PLUS_PAIR")), ("INT32", ("MIN_PLUS",))):
        A, a = rand(1800, typ)
        B, b = rand(1500, typ)
        M, msk = rand(900, "BOOL", vals=np.ones(900))
        D = A.shard(jmesh)
        for sem in sems:
            name = f"{typ}.{sem}"
            got = _same(ranks.run("shard", A=a, op="mxm", B=b, M=msk,
                                  semiring=name))
            want = D.mxm(B, semiring=_jsem(name), mask=M)._coo()
            _coo_close(got, want, exact=typ == "INT32")


def test_dist_masked_mxm_heavy_rows(ranks, jmesh):
    """Rows wider than the bucket cap (lowered to 32 in both packages)
    take the host intersect and still agree."""
    rng = np.random.RandomState(31)
    n = 64
    rows = np.concatenate([np.zeros(n, np.int64), rng.randint(0, n, 300)])
    cols = np.concatenate([np.arange(n, dtype=np.int64),
                           rng.randint(0, n, 300)])
    k = np.unique(rows * n + cols)
    rows, cols = k // n, k % n
    v = rng.uniform(0.5, 2.0, len(rows))
    A, a = _spec("FP32", n, n, rows, cols, v)
    M, msk = _spec("BOOL", n, n, rows, cols, np.ones(len(rows)))
    got = _same(ranks.run("shard", A=a, op="mxm_heavy", B=a, M=msk,
                          semiring="FP32.PLUS_TIMES", width_cap=32))
    old = jdist._TC_WIDTH_CAP
    jdist._TC_WIDTH_CAP = 32
    try:
        want = A.shard(jmesh).mxm(A, semiring=J.types.FP32.PLUS_TIMES,
                                  mask=M)._coo()
    finally:
        jdist._TC_WIDTH_CAP = old
    _coo_close(got, want, exact=False)


def test_dist_k_truss(ranks, jmesh):
    """k_truss(4) on an 8-clique among 60 vertices of random edges: the
    pruning settles in three passes (each pass a ring masked SpGEMM, and
    in the JAX tier a compile of its own)."""
    G = nx.gnm_random_graph(60, 220, seed=2)
    G.add_edges_from((u, v) for u in range(8) for v in range(u + 1, 8))
    rows, cols = _undirected_edges(G)
    A, spec = _spec("INT64", 60, 60, rows, cols, np.ones(len(rows)))
    got = _same(ranks.run("shard", A=spec, op="k_truss", k=4))
    want = A.shard(jmesh).k_truss(4)._coo()
    _coo_close(got, want, exact=True)
    from pygraphblas_tpu import algorithms

    _coo_close(want, algorithms.k_truss(A, 4)._coo(), exact=True)


def test_dist_ring_plan_cache(ranks, jmesh):
    """A second mxm over the same operands skips the block_csr host
    rebucketing and device placement, as the JAX package's."""
    rng = np.random.RandomState(37)
    n = 80
    k = rng.choice(n * n, size=600, replace=False)
    A, a = _spec("FP32", n, n, k // n, k % n, rng.uniform(0.5, 2.0, len(k)))
    m = rng.choice(n * n, size=200, replace=False)
    M, msk = _spec("BOOL", n, n, m // n, m % n, np.ones(len(m)))
    first, second, same = _same(ranks.run(
        "shard", A=a, op="ring_cache", M=msk, semiring="FP32.PLUS_TIMES",
        balance=False))
    jdist._RING_CACHE.clear()
    jdist._STATS["block_csr_builds"] = 0
    D = A.shard(jmesh, balance=False)
    D.mxm(A, semiring=J.types.FP32.PLUS_TIMES, mask=M)
    assert first == jdist._STATS["block_csr_builds"] == 2
    assert second == first and same


def test_frontier_all_to_all(ranks, jmesh):
    """Every (index, value) packet reaches its destination in the same
    slot as in the JAX package's exchange, the overflow past K slots
    dropped alike, empty slots -1."""
    import jax.numpy as jnp

    Pn, cap = 4, 64
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 10000, (Pn, cap)).astype(np.int64)
    val = rng.rand(Pn, cap).astype(np.float32)
    # rank 0 is the destination of over half the packets, so that it
    # overflows its K slots from every source
    dest = rng.choice(Pn, (Pn, cap), p=[0.55, 0.15, 0.15, 0.15]).astype(
        np.int32)
    dest[rng.rand(Pn, cap) < 0.3] = -1
    got = ranks.run("all_to_all", idx=idx, val=val, dest=dest, cap=cap)
    ri, rv = jdist.frontier_all_to_all(jmesh, jnp.asarray(idx),
                                       jnp.asarray(val), jnp.asarray(dest),
                                       cap)
    ri, rv = np.asarray(ri), np.asarray(rv)
    assert ri.shape == (Pn, Pn, cap // Pn)
    assert np.array_equal(np.stack([g[0] for g in got]), ri)
    assert np.array_equal(np.stack([g[1] for g in got]), rv)
    # some destination overflowed its K slots, so drops were compared
    assert max(np.bincount(dest[s][dest[s] >= 0], minlength=Pn).max()
               for s in range(Pn)) > cap // Pn
