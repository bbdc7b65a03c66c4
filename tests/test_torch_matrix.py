"""Port parity for the Matrix container: every operation of the table
below runs on the same inputs (made from a numpy seed) through the JAX
package's Matrix and the port's, on the CPU, on the bitmap tier and on
the forced COO tier (``bitmap_max_cells`` = ``vector_max_cells`` = 1 in
both packages, restored after), and the results' ``to_arrays()`` are
compared: indices, patterns and integer or boolean values exactly, FP32
element-wise values exactly, FP32 folds (reduce, mxv, mxm) within rtol
1e-5 (another summation order)."""

import numpy as np
import pytest

import pygraphblas_tpu as J
from pygraphblas_tpu import descriptor as jdesc
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import convert, descriptor as tdesc
from pygraphblas_tpu_torch.base import DimensionMismatch as TDimMismatch

N = 7


class NS:
    """One package's names, so that one case body drives both."""

    def __init__(self, pkg, desc, port):
        self.M, self.V, self.t = pkg.Matrix, pkg.Vector, pkg.types
        self.d, self.port = desc, port

    def mat(self, tname, r, c, v, nrows=N, ncols=N):
        if self.port:
            return convert.matrix_from_arrays(tname, nrows, ncols, r, c, v,
                                              device="cpu")
        A = self.M.sparse(getattr(self.t, tname), nrows, ncols)
        A._build(np.asarray(r, np.int64), np.asarray(c, np.int64),
                 np.asarray(v).astype(getattr(self.t, tname)._numpy_t))
        return A

    def vec(self, tname, i, v, size=N):
        if self.port:
            return convert.vector_from_arrays(tname, size, i, v,
                                              device="cpu")
        x = self.V.sparse(getattr(self.t, tname), size)
        x._build(np.asarray(i, np.int64),
                 np.asarray(v).astype(getattr(self.t, tname)._numpy_t))
        return x


JNS = NS(J, jdesc, False)
TNS = NS(T, tdesc, True)


def _set_tier(tier):
    big = tier == "bitmap"
    for pkg in (J, T):
        pkg.options_set(bitmap_max_cells=(1 << 26) if big else 1,
                        vector_max_cells=(1 << 27) if big else 1)


@pytest.fixture(params=["bitmap", "coo"])
def tier(request):
    _set_tier(request.param)
    try:
        yield request.param
    finally:
        _set_tier("bitmap")


def _data(tname, seed):
    rng = np.random.RandomState(seed)

    def draw(k):
        if tname == "FP32":
            return rng.uniform(-4, 4, k).astype(np.float32)
        return rng.randint(-9, 10, k).astype(np.int64)

    def coo(k):
        cells = rng.choice(N * N, k, replace=False)
        return cells // N, cells % N, draw(k)

    A, B, M = coo(20), coo(18), coo(16)
    ui = np.sort(rng.choice(N, 4, replace=False))
    return dict(A=A, B=B, M=(M[0], M[1], M[2] > 0), u=(ui, draw(4)),
                w=(np.arange(N), draw(N)))


def _inputs(ns, tname, data):
    m = {k: ns.mat(tname, *data[k]) for k in ("A", "B")}
    m["M"] = ns.mat("BOOL", *data["M"])
    m["u"] = ns.vec(tname, *data["u"])
    m["w"] = ns.vec(tname, *data["w"])
    return m


# name -> (case, folds): folds says the FP32 result is a reduction
CASES = {
    "eadd": (lambda ns, A, B, M, u, w: A.eadd(B), False),
    "eadd_min": (lambda ns, A, B, M, u, w: A.eadd(B, A.type.MIN), False),
    "eadd_str": (lambda ns, A, B, M, u, w: A.eadd(B, "-"), False),
    "eadd_mask_accum": (lambda ns, A, B, M, u, w: A.eadd(
        B, out=A.dup(), mask=M, accum=A.type.PLUS), False),
    "eadd_mask_rc": (lambda ns, A, B, M, u, w: A.eadd(
        B, out=B.dup(), mask=M, desc=ns.d.RC), False),
    "emult": (lambda ns, A, B, M, u, w: A.emult(B), False),
    "emult_str": (lambda ns, A, B, M, u, w: A.emult(B, "+"), False),
    "emult_gt_bool": (lambda ns, A, B, M, u, w: A.emult(B, A.type.GT),
                      False),
    "emult_t0": (lambda ns, A, B, M, u, w: A.emult(B, desc=ns.d.T0),
                 False),
    "apply_ainv": (lambda ns, A, B, M, u, w: A.apply(A.type.AINV), False),
    "apply_abs_mask": (lambda ns, A, B, M, u, w: A.apply(
        A.type.ABS, mask=M, desc=ns.d.S), False),
    "apply_first": (lambda ns, A, B, M, u, w: A.apply_first(
        3, A.type.MINUS), False),
    "apply_second": (lambda ns, A, B, M, u, w: A.apply_second(
        A.type.TIMES, 2), False),
    "select_gt": (lambda ns, A, B, M, u, w: A.select(">", 1), False),
    "select_nonzero": (lambda ns, A, B, M, u, w: A.select("!=0"), False),
    "select_min": (lambda ns, A, B, M, u, w: A.select("min"), False),
    "tril": (lambda ns, A, B, M, u, w: A.tril(), False),
    "tril_m1": (lambda ns, A, B, M, u, w: A.tril(-1), False),
    "triu_1": (lambda ns, A, B, M, u, w: A.triu(1), False),
    "diag": (lambda ns, A, B, M, u, w: A.diag(), False),
    "offdiag": (lambda ns, A, B, M, u, w: A.offdiag(), False),
    "nonzero": (lambda ns, A, B, M, u, w: A.nonzero(), False),
    "transpose": (lambda ns, A, B, M, u, w: A.transpose(), False),
    "T": (lambda ns, A, B, M, u, w: A.T, False),
    "cast_fp64": (lambda ns, A, B, M, u, w: A.cast(ns.t.FP64), False),
    "pattern": (lambda ns, A, B, M, u, w: A.pattern(), False),
    "dup": (lambda ns, A, B, M, u, w: A.dup(), False),
    "reduce_vector": (lambda ns, A, B, M, u, w: A.reduce_vector(), True),
    "reduce_vector_max": (lambda ns, A, B, M, u, w: A.reduce_vector(
        A.type.MAX_MONOID), True),
    "reduce_vector_t0": (lambda ns, A, B, M, u, w: A.reduce_vector(
        desc=ns.d.T0), True),
    "reduce": (lambda ns, A, B, M, u, w: A.reduce(), True),
    "reduce_min": (lambda ns, A, B, M, u, w: A.reduce(A.type.MIN_MONOID),
                   True),
    "reduce_int": (lambda ns, A, B, M, u, w: A.reduce_int(), True),
    "reduce_float": (lambda ns, A, B, M, u, w: A.reduce_float(), True),
    "reduce_bool": (lambda ns, A, B, M, u, w: M.reduce_bool(), True),
    "mxm": (lambda ns, A, B, M, u, w: A.mxm(B), True),
    "mxm_min_plus": (lambda ns, A, B, M, u, w: A.mxm(
        B, semiring=A.type.MIN_PLUS), True),
    "mxm_mask": (lambda ns, A, B, M, u, w: A.mxm(B, mask=M), True),
    "mxm_mask_t1": (lambda ns, A, B, M, u, w: A.mxm(
        B, mask=M, desc=ns.d.T1), True),
    "mxm_t0": (lambda ns, A, B, M, u, w: A.mxm(B, desc=ns.d.T0), True),
    "mxm_accum": (lambda ns, A, B, M, u, w: A.mxm(
        B, out=A.dup(), accum=A.type.PLUS), True),
    "mxm_plus_pair": (lambda ns, A, B, M, u, w: A.mxm(
        B, semiring=ns.t.INT64.PLUS_PAIR, cast=ns.t.INT64), True),
    "mxm_identity": (lambda ns, A, B, M, u, w: A.mxm(
        ns.M.identity(A.type, N, value=2)), True),
    "matmul": (lambda ns, A, B, M, u, w: A @ B, True),
    "mxv": (lambda ns, A, B, M, u, w: A.mxv(w), True),
    "mxv_sparse_x": (lambda ns, A, B, M, u, w: A.mxv(u), True),
    "mxv_min_plus": (lambda ns, A, B, M, u, w: A.mxv(
        w, semiring=A.type.MIN_PLUS), True),
    "mxv_t0": (lambda ns, A, B, M, u, w: A.mxv(w, desc=ns.d.T0), True),
    "mxv_mask_accum": (lambda ns, A, B, M, u, w: A.mxv(
        w, out=u.dup(), mask=u, accum=A.type.PLUS), True),
    "vxm": (lambda ns, A, B, M, u, w: w.vxm(A), True),
    "vxm_sparse_x": (lambda ns, A, B, M, u, w: u.vxm(A), True),
    "vxm_minus": (lambda ns, A, B, M, u, w: w.vxm(
        A, semiring=A.type.PLUS_MINUS), True),
    "matvec": (lambda ns, A, B, M, u, w: A @ w, True),
    "add": (lambda ns, A, B, M, u, w: A + B, False),
    "add_scalar": (lambda ns, A, B, M, u, w: A + 1, False),
    "radd_scalar": (lambda ns, A, B, M, u, w: 1 + A, False),
    "sub": (lambda ns, A, B, M, u, w: A - B, False),
    "mul": (lambda ns, A, B, M, u, w: A * B, False),
    "neg": (lambda ns, A, B, M, u, w: -A, False),
    "abs": (lambda ns, A, B, M, u, w: abs(A), False),
    "and": (lambda ns, A, B, M, u, w: A & B, False),
    "or": (lambda ns, A, B, M, u, w: A | B, False),
    "gt_scalar": (lambda ns, A, B, M, u, w: A > 0, False),
    "lt_neg_scalar": (lambda ns, A, B, M, u, w: A < -1, False),
    "eq_matrix": (lambda ns, A, B, M, u, w: A == B, False),
    "iseq": (lambda ns, A, B, M, u, w: (A.iseq(A.dup()), A.iseq(B),
                                        A.isne(B)), False),
    "out_degree": (lambda ns, A, B, M, u, w: A.out_degree(), True),
    "binaryop_call": (lambda ns, A, B, M, u, w: A.type.PLUS(A, B), False),
    "monoid_call": (lambda ns, A, B, M, u, w: A.type.MAX_MONOID(A, B),
                    False),
    "semiring_mxm_call": (lambda ns, A, B, M, u, w: A.type.PLUS_TIMES(
        A, B), True),
    "semiring_mxv_call": (lambda ns, A, B, M, u, w: A.type.PLUS_TIMES(
        A, w), True),
    "semiring_vxm_call": (lambda ns, A, B, M, u, w: A.type.MIN_PLUS(
        w, A), True),
    "unaryop_call": (lambda ns, A, B, M, u, w: A.type.AINV(A), False),
    "attr_semiring": (lambda ns, A, B, M, u, w: A.min_plus(B), True),
    # extract over index sets (slices stop-inclusive)
    "extract_range": (lambda ns, A, B, M, u, w: A.extract_matrix(
        slice(1, 4), slice(2, 5)), False),
    "extract_list": (lambda ns, A, B, M, u, w: A.extract_matrix(
        [5, 0, 3, 3], [6, 1, 2]), False),
    "extract_backwards": (lambda ns, A, B, M, u, w: A.extract_matrix(
        slice(5, 1, -2), None), False),
    "extract_t0_mask": (lambda ns, A, B, M, u, w: A.extract_matrix(
        None, None, mask=M, desc=ns.d.T0), False),
    "extract_row": (lambda ns, A, B, M, u, w: A.extract_row(2), False),
    "extract_row_slice": (lambda ns, A, B, M, u, w: A.extract_row(
        3, slice(1, 4)), False),
    "extract_col": (lambda ns, A, B, M, u, w: A.extract_col(4), False),
    "extract_col_slice": (lambda ns, A, B, M, u, w: A.extract_col(
        1, slice(2, 6)), False),
    "getitem_col_slice": (lambda ns, A, B, M, u, w: A[1:3, 2], False),
    "getitem_row_all": (lambda ns, A, B, M, u, w: A[0, :], False),
    "getitem_row": (lambda ns, A, B, M, u, w: A[3], False),
    "getitem_slices": (lambda ns, A, B, M, u, w: A[2:5, 0:1], False),
    "getitem_mask": (lambda ns, A, B, M, u, w: A[M], False),
    # assign over index sets, into a copy of A
    "assign_row": (lambda ns, A, B, M, u, w: _do(A, lambda C: C.assign_row(
        2, w)), False),
    "assign_row_slice_accum": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_row(1, w[0:2], slice(3, 5),
                                  accum=A.type.PLUS)), False),
    "assign_row_mask": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_row(4, w, mask=M, desc=ns.d.RC)), False),
    "assign_col": (lambda ns, A, B, M, u, w: _do(A, lambda C: C.assign_col(
        3, u)), False),
    "assign_col_vmask_accum": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_col(0, w, mask=u, accum=A.type.MINUS)), False),
    "assign_col_slice": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_col(6, w[2:4], slice(0, 2))), False),
    "assign_matrix_range": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_matrix(B[0:2, 0:2], slice(1, 3),
                                     slice(2, 4))), False),
    "assign_matrix_mask_accum": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_matrix(B[4:6, 1:3], slice(1, 3), [6, 0, 2],
                                     mask=M, accum=A.type.PLUS)), False),
    "assign_alias_replace": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign(B, mask=M, desc=ns.d.R)), False),
    "assign_scalar_range": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_scalar(5, slice(1, 3), slice(0, 4))), False),
    "assign_scalar_mask_accum": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_scalar(2, slice(0, 5), None, mask=M,
                                     accum=A.type.TIMES)), False),
    "assign_scalar_row": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.assign_scalar(-3, 6)), False),
    "setitem_slices": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.__setitem__((slice(1, 2), slice(0, 3)),
                                   B[0:1, 0:3])), False),
    "setitem_row": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.__setitem__(2, w)), False),
    "setitem_col_slice": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.__setitem__((slice(1, 3), 4), w[0:2])), False),
    "setitem_scalar_slices": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.__setitem__((slice(0, 1), slice(2, 3)), 9)), False),
    "setitem_mask": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.__setitem__(M, 4)), False),
    # Kronecker products and powers
    "kronecker": (lambda ns, A, B, M, u, w: A.kronecker(B), False),
    "kronecker_minus": (lambda ns, A, B, M, u, w: A.kronecker(
        B, A.type.MINUS), False),
    "kronecker_t0": (lambda ns, A, B, M, u, w: A.kronecker(
        B, desc=ns.d.T0), False),
    "kronecker_t1": (lambda ns, A, B, M, u, w: A.kronecker(
        B, desc=ns.d.T1), False),
    "kronpow0": (lambda ns, A, B, M, u, w: A.kronpow(0), False),
    "kronpow1": (lambda ns, A, B, M, u, w: A.kronpow(1), False),
    "kronpow2": (lambda ns, A, B, M, u, w: A.kronpow(2), False),
    # diagonals, resize, gini
    "from_diag_m1": (lambda ns, A, B, M, u, w: ns.M.from_diag(u, -1), False),
    "from_diag_0": (lambda ns, A, B, M, u, w: ns.M.from_diag(w), False),
    "from_diag_2": (lambda ns, A, B, M, u, w: ns.M.from_diag(u, 2), False),
    "vector_diag_m1": (lambda ns, A, B, M, u, w: A.vector_diag(-1), False),
    "vector_diag_0": (lambda ns, A, B, M, u, w: A.vector_diag(), False),
    "vector_diag_2": (lambda ns, A, B, M, u, w: A.vector_diag(2), False),
    "resize_grow": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.resize(9, 10)), False),
    "resize_shrink": (lambda ns, A, B, M, u, w: _do(
        A, lambda C: C.resize(4, 5)), False),
    "gini": (lambda ns, A, B, M, u, w: (A.gini(),), False),
}


def _do(A, change):
    """A copy of A after `change` (an in-place operation) ran on it."""
    C = A.dup()
    change(C)
    return C


def _arrays(x):
    if hasattr(x, "to_arrays"):
        return [np.asarray(a) for a in x.to_arrays()]
    return [np.asarray(x)]


def _check(got, want, folds, tname):
    if isinstance(want, tuple):
        assert got == want
        return
    g, w = _arrays(got), _arrays(want)
    assert len(g) == len(w)
    for a, b in zip(g[:-1], w[:-1]):
        assert np.array_equal(a, b)
    a, b = g[-1], w[-1]
    assert a.shape == b.shape, (a, b)
    if folds and tname == "FP32" and b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tname", ["INT64", "FP32"])
def test_matrix_op_matches_jax(tier, tname, name):
    case, folds = CASES[name]
    data = _data(tname, 1 + sorted(CASES).index(name))
    want = case(JNS, **_inputs(JNS, tname, data))
    got = case(TNS, **_inputs(TNS, tname, data))
    _check(got, want, folds, tname)


def test_element_access_matches_jax(tier):
    data = _data("INT64", 99)
    out = []
    for ns in (JNS, TNS):
        A = ns.mat("INT64", *data["A"])
        r, c, _ = data["A"]
        A[3, 3] = 77
        A[int(r[0]), int(c[0])] = -5
        del A[int(r[1]), int(c[1])]
        seen = [A.get(i, j, "x") for i in range(N) for j in range(N)]
        seen += [(i, j) in A for i in range(N) for j in range(N)]
        seen.append(A[int(r[2]), int(c[2])])
        out.append((A.nvals, seen, A.to_lists(), sorted(iter(A)),
                    list(A.I), list(A.J), list(A.V), A.shape, A.square,
                    A.to_numpy().tolist(),
                    A.to_scipy_sparse().toarray().tolist()))
    assert out[0] == out[1]


def test_constructors_match_jax(tier):
    rng = np.random.RandomState(5)
    arr = rng.randint(-5, 5, (4, 3))
    import scipy.sparse as sp

    S = sp.random(6, 5, density=0.3, random_state=3, format="csr",
                  dtype=np.float64)
    for build in (
            lambda ns, **k: ns.M.from_lists([0, 1, 2], [1, 2, 0],
                                            [4, 5, 6], **k),
            lambda ns, **k: ns.M.from_lists([0, 2], [1, 1], **k),
            lambda ns, **k: ns.M.dense(ns.t.INT32, 3, 2, fill=7, **k),
            lambda ns, **k: ns.M.iso(3, 2, 2, **k),
            lambda ns, **k: ns.M.identity(ns.t.FP64, 4, value=2.5, **k),
            lambda ns, **k: ns.M.random(ns.t.INT64, 10, 6, 6, seed=4, **k),
            lambda ns, **k: ns.M.from_numpy(arr, **k),
            lambda ns, **k: ns.M.from_scipy_sparse(S, **k),
            lambda ns, **k: ns.M.sparse(ns.t.INT8, 3, 3, **k)):
        want = build(JNS)
        got = build(TNS, device="cpu")
        assert got.type.__name__ == want.type.__name__
        assert got.shape == want.shape and got.nvals == want.nvals
        _check(got, want, False, "")


def test_build_out_of_bounds_raises_dimension_mismatch():
    """An index at or past a dimension raises DimensionMismatch in both
    packages (the port raised IndexError before)."""
    for ns, err in ((JNS, J.base.DimensionMismatch),
                    (TNS, TDimMismatch)):
        for r, c in (([0, 3], [0, 0]), ([0, 0], [2, 5])):
            A = ns.M.sparse(ns.t.INT64, 3, 3)
            with pytest.raises(err):
                A._build(np.asarray(r), np.asarray(c), np.ones(2, np.int64))
    # a negative index keeps raising in the port (the JAX package does
    # not check for one)
    A = T.Matrix.sparse(T.types.INT64, 3, 3)
    with pytest.raises(IndexError):
        A._build(np.asarray([-1]), np.asarray([0]), np.ones(1, np.int64))


def test_matrix_lacks_only_io_and_shard():
    """The port's Matrix has every name of the JAX package's: the I/O
    constructors and, since the distributed tier, ``shard`` (the test
    keeps the name it had while those two were missing)."""
    assert set(dir(J.Matrix)) - set(dir(T.Matrix)) == set()


PRINT_VALUES = {"INT64": [-7, 42, 0, 123456], "FP32": [1.5, -0.25, 3.0, 1e6],
                "BOOL": [True, False, True, True],
                "UINT32": [3000000000, 1, 0, 4294967295]}


@pytest.mark.parametrize("tname", sorted(PRINT_VALUES))
def test_printers_match_jax(tier, tname):
    """to_string, str, the markdown and HTML tables, equal as strings;
    a bit view prints its unsigned value."""
    r, c = [0, 1, 2, 2], [1, 2, 0, 3]
    outs = []
    for ns in (JNS, TNS):
        A = ns.mat(tname, r, c, PRINT_VALUES[tname], nrows=3, ncols=4)
        outs.append((A.to_string(), str(A), A.to_markdown_table(),
                     A.to_html_table(), A.to_string(width=12, empty_char="."),
                     A.to_markdown_table(title="W")))
    assert outs[0] == outs[1]
    if tname == "UINT32":
        assert "3000000000" in outs[1][0] and "-1294967296" not in outs[1][0]


UINT_BIG = {"UINT16": 40000, "UINT32": 3000000000, "UINT64": 2**63 + 2048}


def _uint_selects(ns, tname, kw, vector=True):
    """Value selects and scalar comparisons with values past the sign bit
    of the signed bit view (each a to_lists())."""
    t = getattr(ns.t, tname)
    big = UINT_BIG[tname]
    A = ns.M.from_lists([0, 1, 2, 2], [0, 1, 2, 0], [big, 1, 0, 7], typ=t,
                        **kw)
    out = [A.select(">0"), A.select(">=", 2), A.select("<", big),
           A.select("<=", 1), A.select("<0"), A.select(">=0"), A > 0, A < 5,
           A.select(lambda i, j, x, th: x > th, 8),
           A.select(lambda i, j, x, th: x >= th, big),
           A.select(lambda i, j, x, th: (x < th) & (x != 0), big)]
    if vector:
        v = ns.V.from_lists([0, 1, 2, 4], [big, 1, 0, 7], typ=t, **kw)
        out += [v.select(">0"), v.select("<=", 1), v > 0, v < 5,
                v.select(lambda i, j, x, th: x > th, 8),
                v.select(lambda i, j, x, th: x <= th, big - 1)]
    return [x.to_lists() for x in out]


@pytest.mark.parametrize("tname", sorted(UINT_BIG))
def test_unsigned_selects_match_jax(tier, tname):
    """UINT16/32/64 are held as signed bit views: their value selects and
    comparisons read them as unsigned, as the JAX package does."""
    want = _uint_selects(JNS, tname, {})
    assert _uint_selects(TNS, tname, dict(device="cpu")) == want


@pytest.mark.parametrize("tname", sorted(UINT_BIG))
def test_unsigned_selects_device_engine_match_jax(tname):
    """The same on the COO tier through the device sort engine
    (core/dewise.select; ewise_engine="device" in both packages)."""
    _set_tier("coo")
    for pkg in (J, T):
        pkg.options_set(ewise_engine="device")
    try:
        want = _uint_selects(JNS, tname, {}, vector=False)
        assert _uint_selects(TNS, tname, dict(device="cpu"),
                             vector=False) == want
    finally:
        for pkg in (J, T):
            pkg.options_set(ewise_engine="auto")
        _set_tier("bitmap")


def test_devices_are_named_or_shared():
    """A container built without a device takes the device of its first
    device work's other operands; operands on different devices raise;
    with no card and no device anywhere, device work raises."""
    import torch

    A = T.Matrix.from_lists([0, 1], [1, 0], [1.0, 2.0])
    assert A.device is None and A.nvals == 2     # host staging only
    x = T.Vector.from_list([1.0, 2.0], device="cpu")
    y = A.mxv(x)
    assert str(A.device) == "cpu" and str(y.device) == "cpu"
    assert y.to_lists() == [[0, 1], [2.0, 2.0]]
    if not torch.cuda.is_available():
        B = T.Matrix.from_lists([0, 1], [1, 0], [1.0, 2.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            B.apply(T.types.FP32.AINV)
    C = T.Matrix.from_lists([0, 1], [1, 0], [1.0, 2.0], device="cpu")
    C._dev = torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        C.eadd(A)


def test_perf_report_counts_timed_ops():
    T.base.perf_counters.clear()
    T.options_set(op_timing=1)
    try:
        A = T.Matrix.from_lists([0, 1], [1, 0], [1, 2], device="cpu")
        A.mxm(A)
        A.eadd(A)
        rep = T.perf_report(reset=True)
    finally:
        T.options_set(op_timing=0)
    assert rep["Matrix.mxm"][0] == 1 and rep["Matrix.eadd"][0] == 1
    assert T.base.perf_counters == {}


@pytest.mark.parametrize("name", ["eadd", "eadd_min", "emult",
                                  "emult_gt_bool", "emult_t0", "tril",
                                  "select_gt", "add", "lt_neg_scalar"])
@pytest.mark.parametrize("tname", ["INT64", "FP32"])
def test_device_ewise_engine_matches_jax(tname, name):
    """The COO tier's element-wise operations through the device sort
    engine (core/dewise.py; ewise_engine="device" in both packages)."""
    _set_tier("coo")
    for pkg in (J, T):
        pkg.options_set(ewise_engine="device")
    try:
        case, folds = CASES[name]
        data = _data(tname, 200 + sorted(CASES).index(name))
        want = case(JNS, **_inputs(JNS, tname, data))
        got = case(TNS, **_inputs(TNS, tname, data))
        _check(got, want, folds, tname)
    finally:
        for pkg in (J, T):
            pkg.options_set(ewise_engine="auto")
        _set_tier("bitmap")


@pytest.mark.parametrize("pred, refused", [
    (lambda i, j, x, th: x + 1 > th, False),
    (lambda i, j, x, th: x.float() > 0, True),
    (lambda i, j, x, th: x > 0.5, True),
    (lambda i, j, x, th: x > -1, False)],
    ids=["add", "method", "float", "negative"])
def test_uint64_user_predicate_refuses_the_view(tier, pred, refused):
    """At UINT64 a user predicate gets values that compare and compute as
    unsigned, with Python ints (-1 read as 2^64 - 1): the JAX package's
    selection; a float operand or a tensor method, which would read the
    signed bit view, raises a TypeError that names UINT64."""
    vals = np.array([2**63 + 2048, 1], np.uint64)
    A = T.Matrix.from_lists([0, 1], [0, 1], vals, typ=T.types.UINT64,
                            device="cpu")
    v = T.Vector.from_lists([0, 1], vals, typ=T.types.UINT64, device="cpu")
    jA = J.Matrix.from_lists([0, 1], [0, 1], vals, typ=J.types.UINT64)
    jv = J.Vector.from_lists([0, 1], vals, typ=J.types.UINT64)
    for c, jc in ((A, jA), (v, jv)):
        if refused:
            with pytest.raises(TypeError, match="UINT64"):
                c.select(pred, 10)
            continue
        want = jc.select(J.selectop.select_op(J.types.UINT64)(pred), 10)
        assert c.select(pred, 10).to_lists() == want.to_lists()


@pytest.mark.parametrize("engine", ["auto", "csr8"])
def test_any_over_negative_rows_matches_jax(tier, engine, monkeypatch):
    """ANY over rows whose values are all negative (the COO tier folded
    ANY from its identity 0, which is none of the values): reduce_vector,
    mxv and vxm under ANY_TIMES equal the JAX package's at INT8, INT16,
    INT32, INT64 and FP32, under spmv_engine "auto" and "csr8"; also
    once the port's FP32.MAX_MONOID is rebound to identity 1, as making
    algorithms.relu_neuron_semiring() does (restored after)."""
    from pygraphblas_tpu_torch.algorithms import relu_neuron_semiring

    for name in ("MAX_MONOID", "max_monoid"):
        monkeypatch.setattr(T.types.FP32, name, T.types.FP32.MAX_MONOID)
    relu_neuron_semiring()
    assert T.types.FP32.MAX_MONOID.identity(np.float32) == 1
    rng = np.random.RandomState(16)
    r, c = rng.randint(0, 40, 300), rng.randint(0, 40, 300)
    v = rng.randint(-8, 0, 300)
    for pkg in (J, T):
        pkg.options_set(spmv_engine=engine)
    try:
        for tname in ("INT8", "INT16", "INT32", "INT64", "FP32"):
            got, want = [], []
            for ns, out in ((JNS, want), (TNS, got)):
                typ = getattr(ns.t, tname)
                A = ns.mat(tname, r, c, v, 40, 40)
                x = ns.vec(tname, np.arange(40), np.ones(40), 40)
                out += [A.reduce_vector(typ.ANY_MONOID),
                        A.mxv(x, typ.ANY_TIMES), x.vxm(A, typ.ANY_TIMES)]
            for g, w in zip(got, want):
                _check(g, w, False, tname)
                assert (np.asarray(g.to_arrays()[-1]) < 0).all()
    finally:
        for pkg in (J, T):
            pkg.options_set(spmv_engine="auto")


# user ops at UINT64 whose answers the signed bits do not give (the JAX
# package's uint64 closures); "/" by no zero: the JAX COO tier casts a
# float64 NaN or inf to uint64 through numpy, whose answer is undefined
_U64_OPS = {"floordiv": lambda x, y: x // y, "mod": lambda x, y: x % y,
            "truediv": lambda x, y: x / (y | 1), "rshift": lambda x, y: x >> y,
            "rshift3": lambda x, y: x >> 3, "pow": lambda x, y: x ** y,
            "rpow": lambda x, y: 3 ** y, "pow2": lambda x, y: x ** 2,
            "divmod": lambda x, y: divmod(x, y)[1] + (y >> 1)}


@pytest.mark.parametrize("tier_name", ["bitmap", "coo"])
def test_uint64_user_ops_match_jax(tier_name):
    """A.emult(B, op) at UINT64 for //, %, /, >> and ** (and their
    reflected forms): top-bit operands, zero divisors (x // 0 is
    2^64 - 1, x % 0 is 0), exponents past 2^63 (their low six bits),
    each equal to the JAX package's."""
    _set_tier(tier_name)
    try:
        a = np.array([2**63 + 5, 7, 0, 2**64 - 1, 2**62 + 3, 5, 2**40,
                      8, 2**63], np.uint64)
        b = np.array([7, 2**63 + 9, 0, 2**63, 3, 0, 2**40 + 1,
                      2**63 + 11, 2**64 - 1], np.uint64)
        ix = np.arange(len(a))
        jA, jB = (J.Matrix.from_lists(ix, ix, z, typ=J.types.UINT64)
                  for z in (a, b))
        A, B = (T.Matrix.from_lists(ix, ix, z, typ=T.types.UINT64,
                                    device="cpu") for z in (a, b))
        for name, fn in _U64_OPS.items():
            want = jA.emult(jB, J.binaryop.binary_op(J.types.UINT64)(fn))
            got = A.emult(B, T.binaryop.binary_op(T.types.UINT64)(fn))
            assert got.to_lists() == want.to_lists(), name
    finally:
        _set_tier("bitmap")
