"""Port parity for the Vector container: every operation of the table
below runs on the same inputs (made from a numpy seed) through the JAX
package's Vector and the port's, on the CPU, on the bitmap tier and on
the forced COO tier (``bitmap_max_cells`` = ``vector_max_cells`` = 1 in
both packages), and the results' ``to_arrays()`` are compared: indices,
patterns and integer or boolean values exactly, FP32 element-wise values
exactly, FP32 folds within rtol 1e-5.  ``Vector.cast`` is held to the
values, not to the JAX package's COO branch (it leaves the result's
format unset: ROADMAP Queue C caveat)."""

import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T

from test_torch_matrix import JNS, TNS, N, _check, tier  # noqa: F401


def _data(tname, seed):
    rng = np.random.RandomState(seed)

    def draw(k):
        if tname == "FP32":
            return rng.uniform(-4, 4, k).astype(np.float32)
        return rng.randint(-9, 10, k).astype(np.int64)

    def sp(k):
        return np.sort(rng.choice(N, k, replace=False)), draw(k)

    return dict(u=sp(4), v=sp(5), m=(np.sort(rng.choice(N, 3, False)),
                                     np.ones(3, bool)),
                w=(np.arange(N), draw(N)))


def _inputs(ns, tname, data):
    out = {k: ns.vec(tname, *data[k]) for k in ("u", "v", "w")}
    out["m"] = ns.vec("BOOL", *data["m"])
    return out


def _assign(u, v, m, w, **kw):
    x = u.dup()
    x.assign(w, **kw)
    return x


def _assign_scalar(u, *args, **kw):
    x = u.dup()
    x.assign_scalar(*args, **kw)
    return x


def _setitem(u, index, value):
    x = u.dup()
    x[index] = value
    return x


def _inplace(u, v, op):
    x = u.dup()
    if op == "+":
        x += v
    elif op == "-":
        x -= v
    else:
        x *= v
    return x


CASES = {
    "eadd": (lambda ns, u, v, m, w: u.eadd(v), False),
    "eadd_max": (lambda ns, u, v, m, w: u.eadd(v, u.type.MAX), False),
    "eadd_mask_accum": (lambda ns, u, v, m, w: u.eadd(
        v, out=w.dup(), mask=m, accum=u.type.PLUS), False),
    "eadd_mask_rsc": (lambda ns, u, v, m, w: u.eadd(
        v, out=w.dup(), mask=m, desc=ns.d.RSC), False),
    "emult": (lambda ns, u, v, m, w: u.emult(v), False),
    "emult_str": (lambda ns, u, v, m, w: u.emult(v, "+"), False),
    "emult_lt": (lambda ns, u, v, m, w: u.emult(v, u.type.LT), False),
    "apply": (lambda ns, u, v, m, w: u.apply(u.type.AINV), False),
    "apply_mask": (lambda ns, u, v, m, w: w.apply(
        w.type.ABS, mask=m, out=u.dup(), accum=u.type.MAX), False),
    "apply_first": (lambda ns, u, v, m, w: u.apply_first(
        10, u.type.MINUS), False),
    "apply_second": (lambda ns, u, v, m, w: u.apply_second(
        u.type.MINUS, 10), False),
    "select_gt0": (lambda ns, u, v, m, w: w.select(">0"), False),
    "select_le": (lambda ns, u, v, m, w: w.select("<=", 1), False),
    "select_max": (lambda ns, u, v, m, w: w.select("max"), False),
    "nonzero": (lambda ns, u, v, m, w: w.nonzero(), False),
    "pattern": (lambda ns, u, v, m, w: u.pattern(), False),
    "S": (lambda ns, u, v, m, w: u.S, False),
    "dup": (lambda ns, u, v, m, w: u.dup(), False),
    "reduce": (lambda ns, u, v, m, w: w.reduce(), True),
    "reduce_max": (lambda ns, u, v, m, w: w.reduce(w.type.MAX_MONOID),
                   True),
    "reduce_accum": (lambda ns, u, v, m, w: w.reduce(
        accum=w.type.MINUS), True),
    "reduce_int": (lambda ns, u, v, m, w: w.reduce_int(), True),
    "reduce_float": (lambda ns, u, v, m, w: w.reduce_float(), True),
    "reduce_bool": (lambda ns, u, v, m, w: m.reduce_bool(), True),
    "max": (lambda ns, u, v, m, w: w.max(), True),
    "min": (lambda ns, u, v, m, w: w.min(), True),
    "iseq": (lambda ns, u, v, m, w: (u.iseq(u.dup()), u.iseq(v),
                                     u.isne(v), u.all(u, u.type.EQ)),
             False),
    "extract_slice": (lambda ns, u, v, m, w: w.extract(slice(1, 4)),
                      False),
    "extract_list": (lambda ns, u, v, m, w: w.extract([5, 0, 2]), False),
    "extract_back": (lambda ns, u, v, m, w: w.extract(slice(5, 1, -2)),
                     False),
    "getitem_slice": (lambda ns, u, v, m, w: w[2:5], False),
    "assign_all": (lambda ns, u, v, m, w: _assign(u, v, m, w), False),
    "assign_mask": (lambda ns, u, v, m, w: _assign(u, v, m, w, mask=m,
                                                   accum=u.type.PLUS),
                    False),
    "assign_slice": (lambda ns, u, v, m, w: _assign(
        u, v, m, w.extract(slice(0, 2)), index=slice(2, 4)), False),
    "assign_list": (lambda ns, u, v, m, w: _assign(
        u, v, m, w.extract([0, 1]), index=[4, 1]), False),
    "assign_scalar": (lambda ns, u, v, m, w: _assign_scalar(u, 5), False),
    "assign_scalar_mask": (lambda ns, u, v, m, w: _assign_scalar(
        u, 5, mask=m), False),
    "assign_scalar_slice": (lambda ns, u, v, m, w: _assign_scalar(
        u, 3, slice(1, 3)), False),
    "setitem_slice": (lambda ns, u, v, m, w: _setitem(u, slice(4, None),
                                                      2), False),
    "setitem_mask": (lambda ns, u, v, m, w: _setitem(u, m, 8), False),
    "add": (lambda ns, u, v, m, w: u + v, False),
    "add_scalar": (lambda ns, u, v, m, w: u + 1, False),
    "rsub_scalar": (lambda ns, u, v, m, w: 1 - u, False),
    "mul": (lambda ns, u, v, m, w: u * v, False),
    "iadd": (lambda ns, u, v, m, w: _inplace(u, v, "+"), False),
    "isub": (lambda ns, u, v, m, w: _inplace(u, v, "-"), False),
    "imul": (lambda ns, u, v, m, w: _inplace(u, v, "*"), False),
    "neg": (lambda ns, u, v, m, w: -u, False),
    "abs": (lambda ns, u, v, m, w: abs(u), False),
    "and": (lambda ns, u, v, m, w: u & v, False),
    "or": (lambda ns, u, v, m, w: u | v, False),
    "gt": (lambda ns, u, v, m, w: w > 0, False),
    "lt_neg": (lambda ns, u, v, m, w: w < -2, False),
    "ne_vector": (lambda ns, u, v, m, w: u != v, False),
    "binaryop_call": (lambda ns, u, v, m, w: u.type.TIMES(u, v), False),
    "monoid_call": (lambda ns, u, v, m, w: u.type.MIN_MONOID(u, v), False),
    "unaryop_call": (lambda ns, u, v, m, w: u.type.ABS(u), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tname", ["INT64", "FP32"])
def test_vector_op_matches_jax(tier, tname, name):
    case, folds = CASES[name]
    data = _data(tname, 1 + sorted(CASES).index(name))
    want = case(JNS, **_inputs(JNS, tname, data))
    got = case(TNS, **_inputs(TNS, tname, data))
    _check(got, want, folds, tname)


def test_element_access_matches_jax(tier):
    data = _data("INT64", 77)
    out = []
    for ns in (JNS, TNS):
        u = ns.vec("INT64", *data["u"])
        u[0] = 11
        u[6] = -3
        i0 = int(data["u"][0][-1])
        del u[i0]
        dense = u.to_numpy().tolist() if tier == "bitmap" else None
        out.append((u.nvals, [u.get(i, "x") for i in range(N)],
                    [i in u for i in range(N)], u.to_lists(),
                    list(iter(u)), list(u.I), list(u.V), u.size, u.shape,
                    dense, u.npI.tolist(), u.npV.tolist()))
    assert out[0] == out[1]
    if tier == "coo":   # past vector_max_cells: no dense copy, as in JAX
        with pytest.raises(T.base.InsufficientSpace):
            u.to_numpy()


def test_constructors_match_jax(tier):
    arr = np.arange(-3, 4)
    for build in (
            lambda ns, **k: ns.V.from_lists([0, 3], [4, 5], 6, **k),
            lambda ns, **k: ns.V.from_lists([1, 2], size=4, **k),
            lambda ns, **k: ns.V.from_list([1.5, 2.5], **k),
            lambda ns, **k: ns.V.from_1_to_n(5, **k),
            lambda ns, **k: ns.V.dense(ns.t.INT16, 4, fill=3, **k),
            lambda ns, **k: ns.V.iso(2.0, 3, **k),
            lambda ns, **k: ns.V.random(ns.t.INT32, 4, 9, seed=3, **k),
            lambda ns, **k: ns.V.from_numpy(arr, **k),
            lambda ns, **k: ns.V.sparse(ns.t.UINT8, 5, **k)):
        want = build(JNS)
        got = build(TNS, device="cpu")
        assert got.type.__name__ == want.type.__name__
        assert got.size == want.size and got.nvals == want.nvals
        _check(got, want, False, "")


def test_cast_values():
    for tier_name in ("bitmap", "coo"):
        from test_torch_matrix import _set_tier

        _set_tier(tier_name)
        try:
            u = T.Vector.from_lists([0, 3], [4, -5], 6, device="cpu")
            for typ, want in ((T.types.FP32, [4.0, -5.0]),
                              (T.types.BOOL, [True, True]),
                              (T.types.UINT8, [4, 251])):
                c = u.cast(typ)
                assert c.type is typ and c.to_lists() == [[0, 3], want]
        finally:
            _set_tier("bitmap")


@pytest.mark.parametrize("engine", ["auto", "device"])
def test_huge_vectors_match_jax(engine):
    """Sizes past vector_max_cells keep sorted host COO (and iso O(1))
    in both packages; element-wise work takes the host merge or (forced)
    the device sort engine."""
    big = 1 << 40
    out = []
    for ns, pkg in ((JNS, J), (TNS, T)):
        kw = {"device": "cpu"} if pkg is T else {}
        pkg.options_set(ewise_engine=engine)
        try:
            u = ns.V.from_lists([3, 1 << 30], [1, 2], big, **kw)
            v = ns.V.from_lists([3, 7], [10, 20], big, **kw)
            it = ns.V.iso(4, big, **kw)
            out.append((u.eadd(v).to_lists(), u.emult(v).to_lists(),
                        u.apply(u.type.AINV).to_lists(), u.reduce(),
                        it.reduce(), it[12345], it.nvals,
                        u.select(">", 1).to_lists(), repr(u)))
        finally:
            pkg.options_set(ewise_engine="auto")
    assert out[0] == out[1]


def test_from_parts_keeps_the_tensors():
    import torch

    vals = torch.arange(4, dtype=torch.float32)
    v = T.Vector._from_parts(T.types.FP32, vals)
    assert v._vals is vals and bool(v._mask.all()) and v.nvals == 4
    m = torch.tensor([True, False, True, False])
    w = T.Vector._from_parts(T.types.FP32, vals, m)
    assert w.to_lists() == [[0, 2], [0.0, 2.0]]
