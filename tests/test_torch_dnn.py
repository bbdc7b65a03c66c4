"""The GraphChallenge sparse DNN of the port against the JAX package on
the CPU: ``fused.dnn`` (dense, one matmul a layer), ``algorithms.dnn``
(the containers, per layer) and ``algorithms.hyperdnn`` (the whole net
as one hypersparse block matrix, bias and ReLU inside a user-defined
semiring), on the RadiX-Net test data of ``testing.py`` (the JAX
package's ``demo/dnn`` builders, copied: the same matrices from the
same seed).  Every weight, bias and image value is a binary fraction,
so float32 results are exact in any summation order: the tests ask for
equality."""

import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T
from demo.dnn.challenge import build_biases as jbiases, run_fullscale
from demo.dnn.radix import radix_net as jradix_net
from pygraphblas_tpu import algorithms as jalg, fused as jfused
from pygraphblas_tpu_torch import algorithms as talg, fused as tfused
from pygraphblas_tpu_torch import testing


def _dense(M):
    r, c, v = M._coo()
    d = np.zeros(M.shape, np.float32)
    d[r, c] = v
    return d


def _images(pkg, m, ncols, r, c, v, **kw):
    Y = pkg.Matrix.sparse(pkg.types.FP32, m, ncols, **kw)
    Y._build(r.astype(np.int64), c.astype(np.int64), v)
    return Y


@pytest.fixture
def coo_tier():
    """Both packages' containers forced onto the COO tier."""
    for pkg in (J, T):
        pkg.options_set(bitmap_max_cells=1, vector_max_cells=1)
    yield
    for pkg in (J, T):
        pkg.options_set(bitmap_max_cells=1 << 26, vector_max_cells=1 << 27)


def test_test_data_equals_the_demos():
    """testing.radix_net and build_biases give the JAX package's demo
    matrices, weights drawn from the seed included."""
    for kw in (dict(weight=0.5), dict(weight=None)):
        n, jl = jradix_net([4, 2, 8], 5, seed=11, **kw)
        tn, tl = testing.radix_net([4, 2, 8], 5, seed=11, device="cpu", **kw)
        assert n == tn
        for a, b in zip(jl, tl):
            assert all(np.array_equal(x, y) for x, y in zip(a._coo(),
                                                            b._coo()))
    jb, tb = jbiases(16, 2, -0.3), testing.build_biases(16, 2, -0.3)
    assert [b._coo()[2].tolist() for b in jb] == \
        [b._coo()[2].tolist() for b in tb]
    assert testing.fullscale_radices(1024) == ([32, 32], 0.125)
    assert testing.fullscale_radices(64) == ([32, 2], 2.0)


def _synthetic(m=96, seed=3):
    n, jl = jradix_net([4, 4, 4], 6, weight=0.5, seed=seed)
    _, tl = testing.radix_net([4, 4, 4], 6, weight=0.5, seed=seed,
                              device="cpu")
    rng = np.random.RandomState(seed)
    r = rng.randint(0, m, m * 6).astype(np.int64)
    c = rng.randint(0, n, m * 6).astype(np.int64)
    keys = np.unique(r * n + c)
    r, c = keys // n, keys % n
    v = (rng.randint(1, 9, len(r)) / 8).astype(np.float32)
    return n, m, jl, tl, r, c, v


@pytest.mark.parametrize("tier", ["bitmap", "coo"])
def test_fused_dnn_matches_container_path(tier, request):
    """fused.dnn equal to algorithms.dnn, both equal to the JAX
    package's fused.dnn and algorithms.dnn; on the COO tier the result
    is a COO-tier matrix."""
    if tier == "coo":
        request.getfixturevalue("coo_tier")
    n, m, jl, tl, r, c, v = _synthetic()
    jb = jbiases(n, 6, -0.0625)
    tb = testing.build_biases(n, 6, -0.0625, device="cpu")
    want = _dense(jfused.dnn(jl, jb, _images(J, m, n, r, c, v)))
    assert np.array_equal(want, _dense(jalg.dnn(jl, jb,
                                                _images(J, m, n, r, c, v))))
    got = tfused.dnn(tl, tb, _images(T, m, n, r, c, v, device="cpu"),
                     device="cpu")
    assert got._fmt == ("coo" if tier == "coo" else "bitmap")
    assert np.array_equal(_dense(got), want)
    got2 = talg.dnn(tl, tb, _images(T, m, n, r, c, v, device="cpu"))
    assert np.array_equal(_dense(got2), want)
    assert want.max() > 0 and (want == 0).any()


@pytest.mark.parametrize("tier", ["bitmap", "coo"])
def test_hyperdnn_matches_container_path(tier, request):
    """hyperdnn over hypergraph(layers) and hypergraph(biases, diag=True)
    equal to dnn, and both equal to the JAX package's; the output sits
    in the last block."""
    if tier == "coo":
        request.getfixturevalue("coo_tier")
    n, jl = jradix_net([4, 4], 6, weight=1.0, seed=3)
    _, tl = testing.radix_net([4, 4], 6, weight=1.0, seed=3, device="cpu")
    jb = jbiases(n, 6, -0.25)
    tb = testing.build_biases(n, 6, -0.25, device="cpu")
    rng = np.random.RandomState(0)
    m = 40
    r, c = rng.randint(0, m, 200), rng.randint(0, n, 200)
    keys = np.unique(r.astype(np.int64) * n + c)
    r, c = keys // n, keys % n
    v = np.ones(len(r), np.float32)
    want = _dense(talg.dnn(tl, tb, _images(T, m, n, r, c, v, device="cpu")))
    assert np.array_equal(want, _dense(jalg.dnn(jl, jb,
                                                _images(J, m, n, r, c, v))))
    outs = []
    for pkg, alg, L, B, kw in ((J, jalg, jl, jb, {}),
                               (T, talg, tl, tb, dict(device="cpu"))):
        HW, HB = alg.hypergraph(L), alg.hypergraph(B, diag=True)
        assert HW.nrows == 7 * n and HB.nvals == 6 * n
        Yh = _images(pkg, m, HW.ncols, r, c, v, **kw)
        outs.append(alg.hyperdnn(len(L), HW, HB, Yh)._coo())
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    rr, cc, vv = outs[1]
    assert (cc >= 6 * n).all()
    got = np.zeros((m, n), np.float32)
    got[rr, cc - 6 * n] = vv
    assert np.array_equal(got, want)


def test_relu_semiring_on_the_diagonal_path():
    """relu_neuron_semiring's multiply (a user-defined FP32 binary_op)
    applied by gustavson.spgemm's diagonal-B path on the host: the JAX
    package's values, clip and zero included."""
    vals = np.array([-3.0, -0.25, 0.0, 0.5, 31.75, 40.0], np.float32)
    rows = np.arange(6, dtype=np.int64)
    bias = np.full(6, -0.25, np.float32)
    outs = []
    for pkg, alg, kw in ((J, jalg, {}), (T, talg, dict(device="cpu"))):
        Y = pkg.Matrix.sparse(pkg.types.FP32, 1, 6, **kw)
        Y._build(np.zeros(6, np.int64), rows, vals)
        D = pkg.Matrix.sparse(pkg.types.FP32, 6, 6, **kw)
        D._build(rows, rows, bias)
        outs.append(Y.mxm(D, semiring=alg.relu_neuron_semiring()).to_lists())
    assert outs[0] == outs[1]
    assert outs[1][2] == [0.0, 0.0, 0.0, 0.25, 31.5, 32.0]


@pytest.mark.parametrize("tier", ["bitmap", "coo"])
def test_fullscale_category_oracle(tier, request):
    """run_fullscale's network at 64 neurons and 10 layers (seed 7): the
    port's fused.dnn and algorithms.dnn (and, on the COO tier, hyperdnn)
    give the JAX package's result, and their categories (rows with an
    output) equal the scipy oracle's.  On the bitmap tier hyperdnn's
    user-defined ReLU semiring takes the dense broadcast-reduce, whose
    (400, 704, 704) temporaries make it the slowest case of the file
    under a loaded CPU; its small net is tested above."""
    if tier == "coo":
        request.getfixturevalue("coo_tier")
    m, nn, nl = 400, 64, 10
    want = run_fullscale(nneurons=nn, nlayers=nl, nimages=m)
    radices, w = testing.fullscale_radices(nn)
    n, tl = testing.radix_net(radices, nl, weight=w, seed=7, device="cpu")
    r, c, v = testing.fullscale_images(m, n, seed=7)
    tb = testing.build_biases(n, nl, -0.25, device="cpu")
    truth = testing.scipy_dnn_oracle(r, c, v, [x._coo() for x in tl], m, n,
                                     -0.25)
    cats = set(np.flatnonzero(np.diff(truth.indptr)).tolist())
    assert 0 < len(cats) < m
    got_f = tfused.dnn(tl, tb, _images(T, m, n, r, c, v, device="cpu"),
                       device="cpu")
    got_d = talg.dnn(tl, tb, _images(T, m, n, r, c, v, device="cpu"))
    for got in (got_f, got_d):
        assert all(np.array_equal(a, b)
                   for a, b in zip(got._coo(), want._coo()))
        assert set(got._coo()[0].tolist()) == cats
    if tier == "coo":
        HW = talg.hypergraph(tl)
        HB = talg.hypergraph(tb, diag=True)
        hr, hc, hv = talg.hyperdnn(
            nl, HW, HB, _images(T, m, HW.ncols, r, c, v,
                                device="cpu"))._coo()
        assert np.array_equal(hr, want._coo()[0])
        assert np.array_equal(hc - nl * n, want._coo()[1])
        assert np.array_equal(hv, want._coo()[2])
