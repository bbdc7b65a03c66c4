"""User-defined operators in the port against the JAX package, on the CPU.

1. The unsigned views: the port holds UINT16, UINT32 and UINT64 as
   signed bit views (int16, int32, int64); a user binary op, unary op or
   monoid gets the unsigned values, as the JAX package's does
   (``_unsigned.call``), through ``emult``, ``eadd``, ``apply``,
   ``reduce``, ``mxm`` and ``kronecker`` on the bitmap and COO tiers,
   Matrix and Vector, and never at an absent cell or a pad.  UINT64 is
   held to a numpy oracle (the JAX package's ``from_lists`` loses the
   low bits of 2^63 + 5): the unsigned answer, or a TypeError naming
   UINT64 (a float operand), never the signed answer.
2. The kernels' routes on the CPU: ESC's A @ A under the user semiring
   LogSum32 (``testing.logsum32``) against the JAX package's
   ``esc_spgemm`` (its probabilities p = exp(value) within rtol 1e-5:
   another fold order), and ``masked_spgemm`` through the valued path
   (``_fast_paths`` made true, so that ``pair_fold``'s plain version
   runs through the full dispatch) with LogSum32, INT32 PLUS_POW, FP32
   MIN_ATAN2 and INT32 MAX_BXOR against the JAX package's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygraphblas_tpu as J
from pygraphblas_tpu import binaryop as jbinaryop, types as jtypes
from pygraphblas_tpu.core import esc as jesc, spgemm as jsg
from pygraphblas_tpu_torch import (Matrix, Vector, binaryop, generators,
                                   options_set, testing, types, unaryop)
from pygraphblas_tpu_torch.core import esc, spgemm

CPU = torch.device("cpu")

# the fault's operators, in both packages: (port fn, JAX fn)
BIGGER = (lambda x, y: torch.where(x > y, x, y),
          lambda x, y: jnp.where(x > y, x, y))
QUOT = (lambda x, y: x // y, lambda x, y: x // y)
STEP = (lambda x: torch.where(x > 10, x // 3, x + 1),
        lambda x: jnp.where(x > 10, x // 3, x + 1))


def _set_tier(name):
    """Both packages on the bitmap tier or (every container) the COO
    tier."""
    cells = (1, 1) if name == "coo" else (1 << 26, 1 << 27)
    for pkg in (J, None):
        (pkg.options_set if pkg else options_set)(
            bitmap_max_cells=cells[0], vector_max_cells=cells[1])


@pytest.fixture(params=["bitmap", "coo"])
def tier(request):
    _set_tier(request.param)
    yield request.param
    _set_tier("bitmap")


@pytest.fixture
def tiers():
    """Both tiers, one after the other, in one test."""
    yield lambda name: _set_tier(name)
    _set_tier("bitmap")


def _operands(typ, seed):
    """Two 6 x 6 patterns that overlap in part, values past the sign bit
    of the held view and nonzero (x // y)."""
    rng = np.random.RandomState(seed)
    hi = (1 << getattr(types, typ)._bits) - 1
    out = []
    for _ in range(2):
        key = np.unique(rng.randint(0, 36, 20))
        vals = rng.randint(1, hi, len(key), dtype=np.int64)
        vals[:3] = [hi - 1, 1 << (getattr(types, typ)._bits - 1), 5]
        out.append(((key // 6).tolist(), (key % 6).tolist(), vals.tolist()))
    return out


def _both(typ, seed):
    """The operands as (port A, port B, JAX A, JAX B)."""
    (ra, ca, va), (rb, cb, vb) = _operands(typ, seed)
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    return (Matrix.from_lists(ra, ca, va, 6, 6, typ=T, device=CPU),
            Matrix.from_lists(rb, cb, vb, 6, 6, typ=T, device=CPU),
            J.Matrix.from_lists(ra, ca, va, 6, 6, typ=jT),
            J.Matrix.from_lists(rb, cb, vb, 6, 6, typ=jT))


def _lists(M):
    return [list(map(int, x)) for x in M.to_lists()]


@pytest.mark.parametrize("typ", ["UINT16", "UINT32"])
def test_user_binary_ops_at_unsigned_views(typ, tier):
    """emult and eadd with where(x > y, x, y) and x // y: the JAX
    package's answers (the signed view gave the smaller or a negative
    quotient)."""
    A, B, jA, jB = _both(typ, 1)
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    for fn, jfn in (BIGGER, QUOT):
        op, jop = binaryop.binary_op(T)(fn), jbinaryop.binary_op(jT)(jfn)
        assert _lists(A.emult(B, op)) == _lists(jA.emult(jB, jop))
        assert _lists(A.eadd(B, op)) == _lists(jA.eadd(jB, jop))
    big = _lists(A.emult(B, binaryop.binary_op(T)(BIGGER[0])))[2]
    assert max(big) >= 1 << (T._bits - 1)


def test_fault_cases_give_the_jax_answers(tiers):
    """The probe's cases on both tiers: A holds 3000000000 and 5, B 7 and
    4000000000 (UINT16: 60000 for the large values)."""
    for tier, typ, x1, x2 in (
            (t, *c) for t in ("bitmap", "coo")
            for c in (("UINT32", 3000000000, 4000000000),
                      ("UINT16", 60000, 60000))):
        tiers(tier)
        T = getattr(types, typ)
        A = Matrix.from_lists([0, 1], [0, 1], [x1, 5], typ=T, device=CPU)
        B = Matrix.from_lists([0, 1], [0, 1], [7, x2], typ=T, device=CPU)
        assert _lists(A.emult(B, binaryop.binary_op(T)(BIGGER[0])))[2] == \
            [x1, x2]
        assert _lists(A.emult(B, binaryop.binary_op(T)(QUOT[0])))[2] == \
            [x1 // 7, 0]


@pytest.mark.parametrize("typ", ["UINT16", "UINT32"])
def test_user_unary_ops_and_monoids_at_unsigned_views(typ, tier):
    """Matrix.apply and Vector.apply with where(x > 10, x // 3, x + 1);
    a user max monoid (identity 0) and a user plus monoid through
    eadd, Matrix.reduce, reduce_vector and Vector.reduce: the JAX
    package's answers (on the COO tier, whose segment reduce in the JAX
    package takes no user monoid, the reductions are held to numpy's
    over the unsigned values)."""
    A, B, jA, jB = _both(typ, 2)
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    op, jop = unaryop.unary_op(T)(STEP[0]), J.unaryop.unary_op(jT)(STEP[1])
    assert _lists(A.apply(op)) == _lists(jA.apply(jop))
    (_, idx, vals), _ = _operands(typ, 3)
    v = Vector.from_lists(idx, vals, 6, typ=T, device=CPU)
    jv = J.Vector.from_lists(idx, vals, 6, typ=jT)
    assert _lists(v.apply(op)) == _lists(jv.apply(jop))
    ra, _, va = _lists(A)
    for fn, jfn, npf in (BIGGER + (lambda *x: max(x),),
                         (lambda x, y: x + y, lambda x, y: x + y,
                          lambda *x: sum(x) % (1 << T._bits))):
        m = T.new_monoid(binaryop.binary_op(T)(fn), 0)
        jm = jT.new_monoid(jbinaryop.binary_op(jT)(jfn), 0)
        assert _lists(A.eadd(B, m)) == _lists(jA.eadd(jB, jm))
        if tier == "bitmap":
            assert int(A.reduce(m)) == int(jA.reduce(jm))
            assert _lists(A.reduce_vector(m)) == _lists(jA.reduce_vector(jm))
            assert int(v.reduce(m)) == int(jv.reduce(jm))
        else:
            rows = sorted(set(ra))
            assert int(A.reduce(m)) == npf(*va)
            assert _lists(A.reduce_vector(m)) == [
                rows, [npf(*[x for i, x in zip(ra, va) if i == r])
                       for r in rows]]
            assert int(v.reduce(m)) == npf(*_lists(v)[1])


def test_user_semiring_products_at_unsigned_views(tiers):
    """mxm and kronecker with a user x // y multiply at UINT32 on both
    tiers (the dense broadcast-reduce, the host tiers' generic
    intersect): the JAX package's answers; a user op never divides the
    zeros of absent cells or pads, which raises on the CPU."""
    T, jT = types.UINT32, jtypes.UINT32
    quot = binaryop.binary_op(T)(QUOT[0])
    jquot = jbinaryop.binary_op(jT)(QUOT[1])
    sem = T.new_semiring(T.PLUS_MONOID, quot)
    jsem = jT.new_semiring(jT.PLUS_MONOID, jquot)
    for tier in ("bitmap", "coo"):
        tiers(tier)
        A, B, jA, jB = _both("UINT32", 6)
        assert _lists(A.mxm(B, semiring=sem)) == \
            _lists(jA.mxm(jB, semiring=jsem))
        assert _lists(A.kronecker(B, quot)) == _lists(jA.kronecker(jB, jquot))


@pytest.mark.parametrize("tier_name", ["bitmap", "coo"])
def test_uint64_user_ops_against_numpy(tier_name, tiers):
    """UINT64: the unsigned order, division and wrapping arithmetic
    (numpy's uint64), or a TypeError naming UINT64 (a float operand);
    never the signed answer."""
    tiers(tier_name)
    T = types.UINT64
    a = np.array([2 ** 63 + 5, 7, 2 ** 64 - 1], np.uint64)
    b = np.array([9, 2 ** 63 + 9, 2], np.uint64)
    A = Matrix.from_lists([0, 1, 2], [0, 1, 2], a, typ=T, device=CPU)
    B = Matrix.from_lists([0, 1, 2], [0, 1, 2], b, typ=T, device=CPU)
    bigger = binaryop.binary_op(T)(BIGGER[0])
    assert _lists(A.emult(B, bigger))[2] == np.maximum(a, b).tolist()
    plus = binaryop.binary_op(T)(lambda x, y: x * 3 + y - 1)
    assert _lists(A.emult(B, plus))[2] == (a * np.uint64(3) + b
                                           - np.uint64(1)).tolist()
    bits = binaryop.binary_op(T)(lambda x, y: (x ^ y) & ~(y << 1))
    assert _lists(A.emult(B, bits))[2] == ((a ^ b) & ~(b << np.uint64(1))
                                           ).tolist()
    quot = binaryop.binary_op(T)(QUOT[0])
    assert _lists(A.emult(B, quot))[2] == (a // b).tolist()
    with pytest.raises(TypeError, match="UINT64"):
        A.emult(B, binaryop.binary_op(T)(lambda x, y: x * 1.5 + y))
    step = unaryop.unary_op(T)(lambda x: torch.where(x > 8, x, x + 1))
    assert _lists(A.apply(step))[2] == np.where(a > 8, a, a + 1).tolist()
    m = T.new_monoid(bigger, 0)
    assert int(A.reduce(m)) == int(a.max())


def _jax_logsum32():
    ln2 = math.log(2.0)

    @jbinaryop.binary_op(jtypes.FP32)
    def logsum(x, y):
        return jnp.where(x == y, x + ln2, jnp.maximum(x, y)
                         + jnp.log1p(jnp.exp(-jnp.abs(x - y))))

    @jbinaryop.binary_op(jtypes.FP32)
    def logmul(x, y):
        return x + y

    return jtypes.FP32.new_semiring(
        jtypes.FP32.new_monoid(logsum, float("-inf")), logmul)


def _semirings(name):
    """(port semiring, JAX semiring, numpy dtype) by name."""
    if name == "LogSum32":
        return testing.logsum32(), _jax_logsum32(), np.float32
    add, mul, typ = {"PLUS_POW": ("PLUS", "POW", "INT32"),
                     "MIN_ATAN2": ("MIN", "ATAN2", "FP32"),
                     "MAX_BXOR": ("MAX", "BXOR", "INT32")}[name]
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    return (T.new_semiring(getattr(T, add + "_MONOID"), getattr(T, mul)),
            jT.new_semiring(getattr(jT, add + "_MONOID"), getattr(jT, mul)),
            T.numpy_dtype)


def _values(name, n, seed):
    rng = np.random.RandomState(seed)
    if name == "LogSum32":
        return np.log(1.0 - rng.rand(n)).astype(np.float32)
    return rng.randint(1, 6, n)


def _same_p(got, want, rtol):
    """Equal patterns; LogSum32's values as p = exp(value) within rtol."""
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    g, w = np.exp(got[2].astype(np.float64)), np.exp(np.asarray(
        want[2], np.float64))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


def test_esc_logsum32_matches_jax():
    rows, cols, n = generators.rmat_edges(9, 8)
    v = _values("LogSum32", len(rows), 7)
    sem, jsem, dt = _semirings("LogSum32")
    got = esc.esc_spgemm(rows, cols, v, rows, cols, v, sem, dt, device=CPU)
    want = jesc.esc_spgemm(rows, cols, v, rows, cols, v, jsem, dt)
    assert got is not None and want is not None and len(got[0]) > 1000
    _same_p(got, want, 1e-5)


@pytest.fixture(scope="module")
def operands():
    """1500 vertices, about 30k random edges: A, B = A (given as A^T's
    rows) and the mask A."""
    rng = np.random.RandomState(2)
    n, nnz = 1500, 30000
    key = np.unique(rng.randint(0, n, nnz).astype(np.int64) * n
                    + rng.randint(0, n, nnz))
    r, c = key // n, key % n
    order = np.lexsort((r, c))
    return r, c, order


@pytest.mark.parametrize("name", ["LogSum32", "PLUS_POW", "MIN_ATAN2",
                                  "MAX_BXOR"])
def test_masked_spgemm_valued_path_matches_jax(operands, name,
                                               monkeypatch):
    r, c, order = operands
    sem, jsem, dt = _semirings(name)
    v = _values(name, len(r), 3).astype(dt)
    args = (r, c, v, c[order], r[order], v[order], r, c)
    want = jsg.masked_spgemm(*args, jsem, dt)
    monkeypatch.setattr(spgemm, "_fast_paths", lambda dev: True)
    calls = []

    def counted(*a, _orig=spgemm.pair_fold):
        calls.append(1)
        return _orig(*a)

    monkeypatch.setattr(spgemm, "pair_fold", counted)
    got = spgemm.masked_spgemm(*args, sem, dt, device="cpu")
    assert calls, "the valued path (pair_fold) was not taken"
    assert got[2].dtype == np.dtype(dt)
    if name == "LogSum32":
        _same_p(got, want, 1e-5)
    else:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        if dt == np.float32:
            np.testing.assert_allclose(got[2], np.asarray(want[2]),
                                       rtol=1e-6, atol=0)
        else:
            assert np.array_equal(got[2], np.asarray(want[2]))
