"""Port parity: pygraphblas_tpu_torch.core.spgemm against the JAX package.

The plain versions of kernels 9, 10 and 11 (what the port runs on CPU
tensors) must equal the JAX Pallas kernels run in interpret mode on the
same inputs: keys and counts exactly, float32 PLUS_TIMES values within
rtol 1e-5 (the fold order differs), INT32 MIN_PLUS values exactly.  The
host helpers must give the JAX package's arrays in both branches.
"""

import functools

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.core import coosparse as jcoo, sparse as jsparse
from pygraphblas_tpu.core import spgemm as jsg
from pygraphblas_tpu_torch import types
from pygraphblas_tpu_torch.testing import SR_CASES, sr_values
from pygraphblas_tpu_torch.core import coosparse, sparse, spgemm
from pygraphblas_tpu_torch.testing import (PAIR_COUNT_CASES, pair_count_case,
                                           pair_fold_case)

E = 64
NNZ = 1 << 12


def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _slab(rng, dt=np.int32):
    """A sorted list of unique column ids as the JAX kernels' (rows, 128)
    slab with 1280 entries of tail padding, and its values."""
    cols = np.sort(rng.choice(3 * NNZ, NNZ, replace=False)).astype(np.int32)
    pad = np.zeros(NNZ + 1280, np.int32)
    pad[:NNZ] = cols
    vals = (rng.rand(NNZ + 1280) * 4).astype(dt) if dt == np.float32 else \
        rng.randint(-9, 10, NNZ + 1280).astype(dt)
    return pad, vals


def _edges(rng, W):
    """E mask edges over two slabs, B windows near A's so that the lists
    meet; edge 0 has wa = 0, edge 1 wb = 0, edge 2 fills the width."""
    ast = rng.randint(0, NNZ - W - 256, E).astype(np.int32)
    bst = np.clip(ast + rng.randint(-60, 60, E), 0,
                  NNZ - W - 256).astype(np.int32)
    wa = rng.randint(0, min(W // 2, 200), E).astype(np.int32)
    wb = np.minimum(rng.randint(0, min(W - 1, 300), E), W - wa)
    wa[0], wb[1] = 0, 0
    wa[2], wb[2] = W // 2, W - W // 2
    return ast, wa, bst, wb.astype(np.int32)


def _inputs(W, seed, dt=np.int32):
    rng = np.random.RandomState(seed)
    (a, av), (b, bv) = _slab(rng, dt), _slab(rng, dt)
    return a, av, b, bv, _edges(rng, W)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("W", [128, 1024])
def test_fill_keys_plain_matches_pallas(W, monkeypatch):
    """Kernel 9 (_pallas_fill_keys) in interpret mode == fill_keys on CPU
    tensors, key for key."""
    a, _, b, _, edges = _inputs(W, W)
    _interpret(monkeypatch)
    want = np.asarray(jsg._pallas_fill_keys(
        jnp.asarray(a.reshape(-1, 128)), jnp.asarray(b.reshape(-1, 128)),
        *[jnp.asarray(x) for x in edges], W))
    got = spgemm.fill_keys(*_t(a, b, *edges), W)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [128, 1024])
def test_pair_count_plain_matches_pallas(W, monkeypatch):
    """Kernel 10 (_pallas_fill_merge_count) in interpret mode ==
    pair_count on CPU tensors, and both equal a numpy intersection."""
    a, _, b, _, edges = _inputs(W, W + 1)
    _interpret(monkeypatch)
    want = np.asarray(jsg._pallas_fill_merge_count(
        jnp.asarray(a.reshape(-1, 128)), jnp.asarray(b.reshape(-1, 128)),
        *[jnp.asarray(x) for x in edges], W))
    got = spgemm.pair_count(*_t(a, b, *edges), W)
    assert np.array_equal(got.numpy(), want)
    ast, wa, bst, wb = edges
    inter = [len(np.intersect1d(a[s:s + n], b[t:t + m]))
             for s, n, t, m in zip(ast, wa, bst, wb)]
    assert np.array_equal(want, inter) and max(inter) > 0


@pytest.mark.parametrize("kind", PAIR_COUNT_CASES)
def test_pair_count_cases_plain(kind):
    """The hand-made edge lists the GPU checks hold the kernel to: the
    plain version on CPU tensors equals a numpy intersection, and
    b_over_8x_a holds a run of at least 8 edges sharing an A list whose
    ids span two or more 2^18-id windows, with B lists over 8x it."""
    *arrs, W = pair_count_case(kind)
    a, b, ast, wa, bst, wb = arrs
    got = spgemm.pair_count(*(torch.from_numpy(x) for x in arrs), W)
    inter = [len(np.intersect1d(a[s:s + n], b[t:t + m]))
             for s, n, t, m in zip(ast, wa, bst, wb)]
    assert np.array_equal(got.numpy(), inter)
    assert (max(inter) == 0) == (kind == "disjoint")
    if kind == "b_over_8x_a":
        for s in np.unique(ast):
            run = ast == s
            ids = a[s:s + wa[run][0]]
            assert run.sum() >= 8 and (wb[run] > 8 * wa[run]).sum() >= 8
            assert ids[-1] >> 18 > ids[0] >> 18
            assert (wb[run] <= 8 * wa[run]).any()


@pytest.mark.parametrize("sem,dt", [("PLUS_TIMES", np.float32),
                                    ("MIN_PLUS", np.int32)])
def test_pair_fold_plain_matches_pallas(sem, dt, monkeypatch):
    """Kernel 11 (_pallas_fill_merge_fold) in interpret mode == pair_fold
    on CPU tensors at W = 128: counts exact, values exact for INT32
    MIN_PLUS and within rtol 1e-5 for FP32 PLUS_TIMES."""
    W = 128
    a, av, b, bv, edges = _inputs(W, 5, dt)
    jsem = getattr(jtypes.FP32 if dt == np.float32 else jtypes.INT32,
                   sem.lower())
    tsem = getattr(types.FP32 if dt == np.float32 else types.INT32, sem)
    _interpret(monkeypatch)
    jc, jv = jsg._pallas_fill_merge_fold(
        jnp.asarray(a.reshape(-1, 128)), jnp.asarray(av.reshape(-1, 128)),
        jnp.asarray(b.reshape(-1, 128)), jnp.asarray(bv.reshape(-1, 128)),
        *[jnp.asarray(x) for x in edges], W, jsem.mul_op.apply,
        jsem.add_monoid.binaryop.apply, jsem.add_monoid.identity(dt), dt)
    cnt, vals = spgemm.pair_fold(*_t(a, av, b, bv, *edges), W,
                                 tsem.mul_op, tsem.add_monoid)
    assert np.array_equal(cnt.numpy(), np.asarray(jc))
    assert vals.dtype == torch.from_numpy(np.zeros(0, dt)).dtype
    if dt == np.float32:
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5)
    else:
        assert np.array_equal(vals.numpy(), np.asarray(jv))


def _fold_oracle(a, av, b, bv, ast, wa, bst, wb, mul, add, dt):
    """Per edge: np.intersect1d with indices, mul(A's value, B's value) at
    the common ids, folded in id order from the monoid's identity."""
    typ = types._gb_from_dtype(dt)
    mulf, foldf = getattr(typ, mul).apply, getattr(typ, add + "_MONOID").apply
    ident = getattr(typ, add + "_MONOID").identity(np.dtype(dt))
    cnt, out = [], []
    for s, n, t, m in zip(ast, wa, bst, wb):
        _, ia, ib = np.intersect1d(a[s:s + n], b[t:t + m],
                                   return_indices=True)
        acc = torch.tensor(ident, dtype=_t(np.zeros(0, dt))[0].dtype)
        for x in mulf(*_t(av[s + ia], bv[t + ib])):
            acc = foldf(acc, x)
        cnt.append(len(ia))
        out.append(acc.item())
    return np.array(cnt), np.array(out, dt)


def _slab_of(x):
    """A column or value array as the JAX kernels' (rows, 128) slab with
    at least 1280 entries of tail padding."""
    n = -(-(len(x) + 1280) // 128) * 128
    y = np.zeros(n, x.dtype)
    y[:len(x)] = x
    return jnp.asarray(y.reshape(-1, 128))


@pytest.mark.parametrize("kind", PAIR_COUNT_CASES)
@pytest.mark.parametrize("sem,dt", [("PLUS_TIMES", np.float32),
                                    ("MIN_PLUS", np.int32)])
def test_pair_fold_cases_plain(kind, sem, dt, monkeypatch):
    """The hand-made edge lists with values the GPU checks hold pair_fold
    to: the plain version on CPU tensors equals a numpy oracle (counts
    and INT32 MIN_PLUS exactly, FP32 PLUS_TIMES within rtol 1e-5), and
    at widths up to 256 JAX's _pallas_fill_merge_fold in interpret
    mode."""
    a, av, b, bv, ast, wa, bst, wb, W = pair_fold_case(kind, dt)
    add, mul = sem.split("_")
    cnt, vals = spgemm.pair_fold(*_t(a, av, b, bv, ast, wa, bst, wb), W,
                                 mul, add)
    wc, wv = _fold_oracle(a, av, b, bv, ast, wa, bst, wb, mul, add, dt)
    assert np.array_equal(cnt.numpy(), wc)
    assert (wc.max() == 0) == (kind == "disjoint")
    if dt == np.float32:
        np.testing.assert_allclose(vals.numpy(), wv, rtol=1e-5)
    else:
        assert np.array_equal(vals.numpy(), wv)
    if W > 256:
        return
    jsem = getattr(jtypes.FP32 if dt == np.float32 else jtypes.INT32,
                   sem.lower())
    _interpret(monkeypatch)
    jc, jv = jsg._pallas_fill_merge_fold(
        _slab_of(a), _slab_of(av), _slab_of(b), _slab_of(bv),
        *[jnp.asarray(x) for x in (ast, wa, bst, wb)], W,
        jsem.mul_op.apply, jsem.add_monoid.binaryop.apply,
        jsem.add_monoid.identity(dt), dt)
    assert np.array_equal(cnt.numpy(), np.asarray(jc))
    if dt == np.float32:
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5)
    else:
        assert np.array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("width,edges,path", [
    (128, 10 ** 6, "search"), (256, 10 ** 6, "search"),
    (512, 10 ** 6, "search"), (1024, 32767, "search"),
    (1024, 32768, "runs"), (16384, 72229, "runs"), (16384, 9641, "search")])
def test_fold_path_rule(width, edges, path):
    """pair_fold's kernel by the bucket's shape: the runs kernel from
    width 1024 with 32768 edges or more, else the search kernel."""
    assert spgemm.fold_path(width, edges) == path


@pytest.mark.parametrize("hi", [5000, 10 ** 9])
def test_csr_and_row_lookup_equal_jax(hi):
    """Both branches of _row_lookup: dense tables (small id space) and
    the sorted search (ids up to 1e9)."""
    rng = np.random.RandomState(hi % 97)
    rows = np.sort(rng.randint(0, hi, 3000)).astype(np.int64)
    cols = rng.randint(0, 50, 3000).astype(np.int64)
    got = spgemm._csr_of(rows, cols, cols)
    want = jsg._csr_of(rows, cols, cols)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    query = np.concatenate([rows[::7], rng.randint(0, hi + 10, 500)])
    for g, w in zip(spgemm._row_lookup(*got, query),
                    jsg._row_lookup(*want, query)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("canonical", [False, True])
def test_coo_build_equals_jax(canonical):
    rng = np.random.RandomState(4)
    r = rng.randint(0, 300, 5000)
    c = rng.randint(0, 300, 5000)
    v = rng.randint(0, 99, 5000)
    if canonical:
        r, c, v = jcoo.build(r, c, v, np.int64)
    got = coosparse.build(r, c, v, np.int64)
    want = jcoo.build(r, c, v, np.int64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_segment_fold_generic_equals_jax():
    rng = np.random.RandomState(8)
    ids = np.sort(rng.randint(0, 200, 3000))
    vals = rng.randint(-50, 50, 3000).astype(np.int64)
    got = sparse.segment_fold_generic(ids, vals, np.minimum)
    want = jsparse.segment_fold_generic(ids, vals,
                                        jtypes.INT64.MIN_MONOID)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("sem,typ", SR_CASES)
def test_masked_algebra_matches_jax(sem, typ, monkeypatch):
    """C<A> = A @ A at kron-8 under each of the algebra's cases: the port
    as on the CPU (the generic intersect) and with the fused paths' rule
    made true (their kernels' plain versions through the full dispatch)
    equal the JAX package's (exact; ANY: one of the cell's products), and
    the route is the JAX package's (spgemm.py:886-913): pair_count for
    PAIR with an idempotent monoid, pair_fold for an int or float
    output, neither for BOOL and the unsigned types."""
    from pygraphblas_tpu_torch import convert
    from pygraphblas_tpu_torch.generators import rmat_edges
    from pygraphblas_tpu_torch.core import coosparse

    r, c, _ = rmat_edges(8, 8)
    v = sr_values(typ, len(r), 9)
    bt = coosparse.build(c, r, v, v.dtype)
    jsem = getattr(getattr(jtypes, typ), sem)
    tsem = convert.semiring_from_name(jsem.name)
    want = jsg.masked_spgemm(r, c, v, *bt, r, c, jsem, v.dtype)
    calls = []
    for k in ("pair_count", "pair_fold"):
        monkeypatch.setattr(spgemm, k, functools.partial(
            lambda f, k, *a: calls.append(k) or f(*a), getattr(spgemm, k),
            k))
    got = spgemm.masked_spgemm(r, c, v, *bt, r, c, tsem, v.dtype,
                               device="cpu")
    assert not calls
    monkeypatch.setattr(spgemm, "_fast_paths", lambda dev: True)
    fused = spgemm.masked_spgemm(r, c, v, *bt, r, c, tsem, v.dtype,
                                 device="cpu")
    route = {"ANY_PAIR": "pair_count", "PLUS_TIMES": "pair_fold",
             "PLUS_ISLT": "pair_fold"}.get(sem)
    assert set(calls) == ({route} if route else set())
    assert len(want[0]) > 500
    for g in (got, fused):
        for x, y in zip(g, want):
            assert x.dtype == np.asarray(y).dtype
            assert np.array_equal(x, np.asarray(y))
