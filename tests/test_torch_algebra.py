"""The port's algebra (pygraphblas_tpu_torch: types, ops/table.py,
binaryop, unaryop, monoid, semiring, selectop, descriptor, scalar, base)
against the JAX package's, on the CPU.

Every name of the JAX package's registries exists in the port; every
monoid identity is equal; every binary and unary op, applied to one
small array per type (numpy, from a seed), equals the JAX closure
applied eagerly: exactly for integer and BOOL values and for the
arithmetic ops on floats, within rtol 1e-6 (FP32, FC32) and 1e-12 (FP64,
FC64) for the transcendental ones.  The two packages meet only through
names (``convert.*_from_name``): the port never sees a JAX object."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pygraphblas_tpu import (binaryop as jbinaryop, descriptor as jdesc,
                             monoid as jmonoid, selectop as jselectop,
                             semiring as jsemiring, types as jtypes,
                             unaryop as junaryop)
from pygraphblas_tpu import base as jbase
from pygraphblas_tpu.core import esc as jesc
from pygraphblas_tpu.ops import table as jtable

from pygraphblas_tpu_torch import (base, binaryop, convert, descriptor,
                                   monoid, scalar, selectop, semiring, types,
                                   unaryop)
from pygraphblas_tpu_torch.core import esc
from pygraphblas_tpu_torch.ops import table

CPU = torch.device("cpu")
TYPES = jtable.ALL_TYPES


def _names(module, cls):
    return {k for k, v in vars(module).items() if isinstance(v, cls)}


def test_registries_hold_every_jax_name():
    """Types, binary and unary ops, monoids and semirings: the same names
    (1553 semirings), and each object found by its JAX name."""
    for jm, tm in ((jbinaryop, binaryop), (junaryop, unaryop),
                   (jmonoid, monoid), (jsemiring, semiring)):
        cls = {binaryop: "BinaryOp", unaryop: "UnaryOp", monoid: "Monoid",
               semiring: "Semiring"}[tm]
        want = _names(jm, getattr(jm, cls))
        got = _names(tm, getattr(tm, cls))
        assert got == want, (cls, sorted(want ^ got)[:10])
    assert len(_names(semiring, semiring.Semiring)) == 1553
    for name in TYPES:
        assert convert.type_from_name(name).__name__ == name
        assert types.MetaType._name_type_map.keys() == \
            jtypes.MetaType._name_type_map.keys()
    s = convert.semiring_from_name(jtypes.BOOL.LOR_LAND.name)
    assert s is types.BOOL.LOR_LAND
    assert s.add_monoid.binaryop.op == "LOR" and s.mul_op.op == "LAND"
    assert convert.monoid_from_name("MIN_INT8_monoid") is types.INT8.MIN_MONOID
    assert convert.binaryop_from_name("BSHIFT_UINT16") is \
        types.UINT16.BSHIFT
    assert table.BINARY.keys() == jtable.BINARY.keys()
    assert table.UNARY.keys() == jtable.UNARY.keys()
    assert table.UNARY_POSITIONAL == jtable.UNARY_POSITIONAL


def test_semiring_families_names_and_ztypes():
    """Every semiring: its add monoid, mul op and ztype by name, as in
    the JAX package."""
    for name in _names(jsemiring, jsemiring.Semiring):
        j, t = getattr(jsemiring, name), convert.semiring_from_name(name)
        assert (t.pls, t.mul, t.type) == (j.pls, j.mul, j.type)
        assert t.add_monoid.name == j.add_monoid.name
        assert t.mul_op.name == j.mul_op.name
        assert t.ztype.__name__ == j.ztype.__name__
    for fam, jfam in zip(table.SEMIRING_FAMILIES, jtable.SEMIRING_FAMILIES):
        assert fam == jfam


def test_promotion_lattice():
    for a in TYPES:
        for b in TYPES:
            want = jtypes.promote(getattr(jtypes, a), getattr(jtypes, b))
            got = types.promote(getattr(types, a), getattr(types, b))
            assert got.__name__ == want.__name__


def test_monoid_identities():
    """Every (monoid, type) identity, value and dtype."""
    for name in _names(jmonoid, jmonoid.Monoid):
        j, t = getattr(jmonoid, name), convert.monoid_from_name(name)
        dt = getattr(jtypes, j.type)._numpy_t
        want, got = np.asarray(j.identity(dt)), np.asarray(t.identity(dt))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert t.binaryop.name == j.binaryop.name


# -- the ops, one small array per type --------------------------------------

_N = 12


def _arrays(typ, seed):
    """x and y of type `typ`: the type's extremes and zero among x, zero
    and -1 among y (the division's edge cases), small y for the shifts."""
    rng = np.random.RandomState(seed)
    dt = np.dtype(getattr(jtypes, typ)._numpy_t)
    if dt == np.bool_:
        return (rng.rand(_N) < 0.5), (rng.rand(_N) < 0.5)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        lo = max(int(info.min), -100)
        x = rng.randint(lo, 100, _N).astype(dt)
        x[:4] = [0, info.max, info.min, 1 if dt.kind == "u" else -1]
        y = rng.randint(0 if dt.kind == "u" else -3, 6, _N).astype(dt)
        y[:4] = [0, 0, 3, 2]
        y[4] = 0
        if dt.kind == "i":
            y[5] = -1
        x[6] = info.min
        y[6] = 0 if dt.kind == "u" else -1
        return x, y
    if dt.kind == "f":
        x = (rng.rand(_N) * 6 - 3).astype(dt)
        y = (rng.rand(_N) * 6 - 3).astype(dt)
        x[0], y[0], y[1] = 0, 0, 0
        return x, y
    x = (rng.rand(_N) * 2 - 1 + 1j * (rng.rand(_N) * 2 - 1)).astype(dt)
    y = (rng.rand(_N) * 2 - 1 + 1j * (rng.rand(_N) * 2 - 1)).astype(dt)
    return x, y


# ops compared within a tolerance on floats (transcendental or libm)
_INEXACT = {"POW", "ATAN2", "HYPOT", "FMOD", "REMAINDER", "SQRT", "LOG",
            "EXP", "LOG2", "LOG10", "LOG1P", "EXP2", "EXPM1", "SIN", "COS",
            "TAN", "ASIN", "ACOS", "ATAN", "SINH", "COSH", "TANH", "ASINH",
            "ACOSH", "ATANH", "LGAMMA", "TGAMMA", "ERF", "ERFC", "CARG",
            "ABS", "MINV", "DIV", "RDIV"}


def _rtol(typ):
    return 1e-6 if typ in ("FP32", "FC32") else 1e-12


def _check(got, want, typ, opname, ztyp):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (opname, typ, got.dtype, want.dtype)
    # complex products and quotients: XLA and torch may contract a
    # multiply-add differently, so within the tolerance
    exact = ztyp.numpy_dtype.kind in "biu" or (
        typ in ("FC32", "FC64") and opname in ("FIRST", "SECOND", "PAIR",
                                               "ANY", "PLUS", "MINUS",
                                               "RMINUS", "AINV", "ONE",
                                               "IDENTITY", "CONJ", "CREAL",
                                               "CIMAG")) or (
        typ not in ("FC32", "FC64") and (
            opname not in _INEXACT
            or opname in ("DIV", "RDIV", "MINV", "ABS")))
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=f"{opname} {typ}")
    else:
        np.testing.assert_allclose(got, want, rtol=_rtol(typ),
                                   atol=_rtol(typ), equal_nan=True,
                                   err_msg=f"{opname} {typ}")


@pytest.mark.parametrize("opname", sorted(jtable.BINARY))
def test_binary_op_matches_jax(opname):
    """Each binary op at each of its types (positional ones on index
    tensors)."""
    spec = jtable.BINARY[opname]
    for i, typ in enumerate(spec["types"]):
        j = getattr(jbinaryop, f"{opname}_{typ}")
        t = convert.binaryop_from_name(j.name)
        T = getattr(types, typ)
        ztyp = t.ztype(T)
        assert ztyp.__name__ == j.ztype(getattr(jtypes, typ)).__name__
        if spec["positional"] is not None:
            ix = np.arange(_N, dtype=np.int64)
            pos = {k: ix * (n + 2) for n, k in enumerate(("i0", "j0", "i1",
                                                          "j1"))}
            want = j.apply(None, None, {k: jnp.asarray(v)
                                        for k, v in pos.items()})
            got = t.apply(None, None, {k: torch.from_numpy(v)
                                       for k, v in pos.items()})
            assert np.array_equal(got.numpy(), np.asarray(want))
            continue
        x, y = _arrays(typ, 11 + i)
        want = j.apply(jnp.asarray(x), jnp.asarray(y))
        got = ztyp.to_numpy(t.apply(T.to_torch(x), T.to_torch(y)))
        _check(got, want, typ, opname, ztyp)


@pytest.mark.parametrize("opname", sorted(jtable.UNARY))
def test_unary_op_matches_jax(opname):
    spec = jtable.UNARY[opname]
    for i, typ in enumerate(spec["types"]):
        j = getattr(junaryop, f"{opname}_{typ}")
        t = getattr(unaryop, j.name)
        T = getattr(types, typ)
        ztyp = t.ztype(T)
        assert ztyp.__name__ == j.ztype(getattr(jtypes, typ)).__name__
        if spec.get("positional") is not None:
            ix = np.arange(_N, dtype=np.int64)
            want = j.apply(None, {"i": jnp.asarray(ix), "j": jnp.asarray(
                2 * ix)})
            got = t.apply(None, {"i": torch.from_numpy(ix),
                                 "j": torch.from_numpy(2 * ix)})
            assert np.array_equal(got.numpy(), np.asarray(want))
            continue
        x, _ = _arrays(typ, 31 + i)
        if opname == "ACOSH" and typ in ("FP32", "FP64"):
            x = np.abs(x) + 1
        want = j.apply(jnp.asarray(x))
        got = ztyp.to_numpy(t.apply(T.to_torch(x)))
        if opname in ("LGAMMA", "TGAMMA") and typ == "FP32":
            # XLA's float32 lgamma is off by up to 3e-6 (against math.lgamma
            # in float64): the port's is held to float64 at rtol 1e-6, and
            # to the JAX package's within that error
            f = math.gamma if opname == "TGAMMA" else math.lgamma
            exact = np.array([f(float(v)) if v != 0 else np.inf for v in x])
            np.testing.assert_allclose(got, exact.astype(np.float32),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
            continue
        _check(got, want, typ, opname, ztyp)


@pytest.mark.parametrize("typ", ["INT8", "INT32", "UINT16"])
def test_div_by_zero_saturates_at_the_type(typ):
    """x / 0 is 0 for x == 0, else the type's max (its min for x < 0),
    at the type itself: INT8 5 / 0 is 127; RDIV and MINV the same."""
    dt = np.dtype(getattr(jtypes, typ)._numpy_t)
    info = np.iinfo(dt)
    x = np.array([5, 0, 1, info.max, 7], dt)
    if dt.kind == "i":
        x[2] = -5
    y = np.array([0, 0, 0, 0, 2], dt)
    T = getattr(types, typ)
    got = T.to_numpy(T.DIV.apply(T.to_torch(x), T.to_torch(y)))
    want = np.array([info.max, 0, info.max if dt.kind == "u" else info.min,
                     info.max, 3], dt)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(getattr(jtypes, typ).DIV.apply(
        jnp.asarray(x), jnp.asarray(y))))
    assert np.array_equal(
        T.to_numpy(T.RDIV.apply(T.to_torch(y), T.to_torch(x))), want)


def test_integer_div_by_zero_in_esc_matches_jax():
    """The probe: A = {(0,0): 5, (0,1): -7, (1,1): 0}, B = {(0,0): 0,
    (1,0): 0}, INT32 PLUS_DIV: row 0 is 2147483647 + -2147483648 = -1 in
    both packages (x / 0 saturates), and 0 / 0 is 0."""
    ra, ca = np.array([0, 0, 1]), np.array([0, 1, 1])
    va = np.array([5, -7, 0], np.int32)
    rb, cb = np.array([0, 1]), np.array([0, 0])
    vb = np.zeros(2, np.int32)
    want = jesc.esc_spgemm(ra, ca, va, rb, cb, vb, jtypes.INT32.PLUS_DIV,
                           np.int32)
    got = esc.esc_spgemm(ra, ca, va, rb, cb, vb, types.INT32.PLUS_DIV,
                         np.int32, device=CPU)
    assert np.array_equal(np.asarray(want[2]), [-1, 0])
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_unsigned_bit_views_hold_numpy_arithmetic():
    """UINT16, UINT32 and UINT64 are signed bit views: their order,
    division, min/max and shifts are numpy's unsigned ones."""
    rng = np.random.RandomState(5)
    for typ, dt in (("UINT16", np.uint16), ("UINT32", np.uint32),
                    ("UINT64", np.uint64)):
        T = getattr(types, typ)
        x = rng.randint(0, 1 << 62, 64, dtype=np.int64).astype(dt)
        y = rng.randint(1, 1 << 62, 64, dtype=np.int64).astype(dt)
        x[:3] = [np.iinfo(dt).max, 0, 1]
        y[:3] = [np.iinfo(dt).max - 1, 3, np.iinfo(dt).max]
        tx, ty = T.to_torch(x), T.to_torch(y)
        for op, ref in (("DIV", x // y), ("MIN", np.minimum(x, y)),
                        ("MAX", np.maximum(x, y)), ("PLUS", x + y),
                        ("TIMES", x * y), ("MINUS", x - y)):
            got = T.to_numpy(getattr(T, op).apply(tx, ty))
            assert np.array_equal(got, ref), (typ, op)
        assert np.array_equal(T.to_numpy(T.ISLT.apply(tx, ty)),
                              (x < y).astype(dt))
        s = (y % 5).astype(dt)
        assert np.array_equal(
            T.to_numpy(T.BSHIFT.apply(tx, T.to_torch(s))), x << s)


def test_select_ops_match_jax():
    rng = np.random.RandomState(3)
    i, j = rng.randint(0, 9, 40), rng.randint(0, 9, 40)
    x = rng.randint(-3, 4, 40).astype(np.int32)
    for name in jselectop._BUILTINS:
        want = getattr(jselectop, name).apply(
            jnp.asarray(i), jnp.asarray(j), jnp.asarray(x), 1)
        got = getattr(selectop, name).apply(
            torch.from_numpy(i), torch.from_numpy(j), torch.from_numpy(x), 1)
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    assert selectop.DEFAULT_THUNKS == jselectop.DEFAULT_THUNKS


def test_descriptors_scalar_and_base():
    for name in jdesc.__all__[1:]:
        want, got = getattr(jdesc, name), getattr(descriptor, name)
        assert all(getattr(got, f) == getattr(want, f)
                   for f in descriptor._FIELDS)
    both = descriptor.T0 & descriptor.RSC
    assert both.name == "T0RSC" and both.inp0 and both.replace
    assert descriptor.T0 in both and descriptor.T1 not in both
    s = scalar.Scalar.from_value(42)
    assert s[0] == 42 and s.type is types.INT64 and s.nvals == 1
    s.clear()
    assert not s
    assert base.options_get().keys() == jbase.options_get().keys()
    assert set(vars(base.GlobalConfig())) == set(vars(jbase.GlobalConfig()))
    for name in jbase.__all__:
        if isinstance(getattr(jbase, name), type):
            assert issubclass(getattr(base, name), Exception)
    assert np.array_equal(base._build_range(slice(1, 3), 9).indices(9),
                          jbase._build_range(slice(1, 3), 9).indices(9))
    # the container form: a semiring called on matrices is their mxm
    from pygraphblas_tpu_torch import Matrix

    A = Matrix.from_lists([0, 1], [1, 0], [2.0, 3.0], device="cpu")
    assert types.FP32.PLUS_TIMES(A, A).to_lists() == \
        A.mxm(A, semiring=types.FP32.PLUS_TIMES).to_lists() == \
        [[0, 1], [0, 1], [6.0, 6.0]]


def test_udt_struct_of_tensors_and_binop():
    class Pair(types.Type, metaclass=types.MetaUDT):
        members = ["double w", "uint16_t n"]

        @types.binop()
        def add(x, y):
            return {"w": x["w"] + y["w"], "n": x["n"] + y["n"]}

    arr = np.array([(1.5, 65535), (2.0, 3)], Pair._numpy_t)
    d = Pair.to_dict(arr)
    assert d["w"].dtype == torch.float64 and d["n"].dtype == torch.int16
    out = Pair.add.apply(arr, arr)
    assert out.dtype == Pair._numpy_t
    assert np.array_equal(out["w"], [3.0, 4.0])
    assert np.array_equal(out["n"], np.array([65534, 6], np.uint16))
    m = types.FP32.new_monoid(types.FP32.MAX, -np.inf)
    sr = types.FP32.new_semiring(m, types.FP32.TIMES)
    assert sr.name == "MAX_TIMES_FP32" and sr.add_monoid is m
    assert m.identity(np.float32) == -np.inf


# integer POW's probe (type, x, y, the JAX package's x POW y): jnp.power
# over integers squares over the exponent's low six bits only
POW_ROWS = [("INT64", 3, 64, 1), ("INT64", 2, 70, 64),
            ("INT32", 3, 100, -1953380655), ("INT32", -2, 65, -2),
            ("INT8", -6, -128, 1), ("UINT64", 8, 2**63 + 11, 2**33),
            ("UINT64", 3, 64, 1)]


def _pow_operands(typ):
    """x and y of `typ`: the probe's rows, 0 ** 64, the exponents 63 .. 71,
    100, 127, the type's extremes and negatives, and BSHIFT's -2^31
    (2^31 at UINT32, its int32 reading)."""
    dt = np.dtype(getattr(jtypes, typ)._numpy_t)
    info = np.iinfo(dt)
    rows = [(x, y) for t, x, y, _ in POW_ROWS if t == typ]
    xs = [3, 2, -2, -6, 0, 1, -1, 8, 5, 7, -3, int(info.min), int(info.max)]
    ys = [64, 70, 100, 65, 63, 71, 127, -128, -1, -2, int(info.min),
          int(info.max), 0, 2**31, -2**31, 2**63 + 11]
    pairs = rows + [(x, y) for x in xs for y in ys]
    x = np.array([int(p[0]) & ((1 << 64) - 1) for p in pairs],
                 np.uint64).astype(dt)
    y = np.array([p[1] for p in pairs], object)
    y = np.array([int(v) & ((1 << 64) - 1) for v in y], np.uint64)
    return x, y.astype(dt)


@pytest.mark.parametrize("typ", ["INT8", "INT16", "INT32", "INT64", "UINT8",
                                 "UINT16", "UINT32", "UINT64"])
def test_integer_pow_and_bshift_follow_jax(typ):
    """POW and BSHIFT at the extremes, against the JAX closures: POW
    squares over the exponent's low six bits (|y| wrapping, then DIV's
    rule for y < 0), so 3^64 is 1 at INT64 and 8^(2^63+11) is 2^33 at
    UINT64; BSHIFT negates y in int32 with wrap, so a shift by -2^31
    returns x.  The probe's rows are held to their constants too."""
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    x, y = _pow_operands(typ)
    for name in ("POW", "BSHIFT"):
        want = np.asarray(getattr(jT, name).apply(jnp.asarray(x),
                                                  jnp.asarray(y)))
        got = T.to_numpy(getattr(T, name).apply(T.to_torch(x),
                                                T.to_torch(y)))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {typ}")
        if name == "POW":
            rows = [w for t, _, _, w in POW_ROWS if t == typ]
            assert got[:len(rows)].tolist() == rows
        elif typ in ("INT32", "INT64"):
            at = (y == -2**31)
            assert at.any() and np.array_equal(got[at], x[at])


@pytest.mark.parametrize("typ", ["INT32", "INT64", "UINT32"])
def test_user_op_integer_pow_follows_jax(typ):
    """A user op's integer tensor ** tensor (and Python int ** tensor)
    is jnp.power's six-bit rule on both of the port's routes: the
    closure (``_unsigned.call``, through emult) and, where the type has
    a kernel word, the lowered functor's torch rendering
    (``_opgen.evaluate``; ``csrc/gen.cuh``'s ``ipow`` on the card); a
    Python int exponent keeps the whole exponent, as lax.integer_pow."""
    from pygraphblas_tpu_torch import Matrix, _kernels, _opgen
    import pygraphblas_tpu as J
    T, jT = getattr(types, typ), getattr(jtypes, typ)
    dt = T.numpy_dtype
    xs = np.array([3, 2, 3, -2, 2, 0, 1, -1, 5, 7], np.int64)
    ys = np.array([64, 70, 100, 65, -1, 64, -5, -3, 71, 127], np.int64)
    if typ == "UINT32":
        xs, ys = np.abs(xs), np.abs(ys)
    x, y = xs.astype(dt), ys.astype(dt)
    ix = np.arange(len(x))
    fns = {"pow": (lambda a, b: a ** b), "rpow": (lambda a, b: 3 ** b),
           "const": (lambda a, b: a ** 64 + b)}
    for name, fn in fns.items():
        jop = jbinaryop.binary_op(jT)(fn)
        want = J.Matrix.from_lists(ix, ix, x, typ=jT).emult(
            J.Matrix.from_lists(ix, ix, y, typ=jT), jop).to_lists()
        op = binaryop.binary_op(T)(fn)
        got = Matrix.from_lists(ix, ix, x, typ=T, device=CPU).emult(
            Matrix.from_lists(ix, ix, y, typ=T, device=CPU), op).to_lists()
        assert got == want, name
        if typ in _kernels.TYPE_CODES:
            ir = _opgen.lower(op, T)
            ev = _opgen.evaluate(ir, T.to_torch(x), T.to_torch(y))
            assert T.to_numpy(ev).tolist() == want[2], name
            if name == "pow":
                assert "gen::ipow" in _opgen.functor(ir, T, "F")
