"""Port parity: pygraphblas_tpu_torch.core.gustavson (the unmasked
SpGEMM and its tiers) against the JAX package and scipy, on the CPU.

Each engine ("auto", "dense", "esc", "scipy") is forced in both packages
on the same operands (made with numpy from one seed), and the results
must agree: rows and columns exactly, INT32 values exactly, FP32 values
within rtol 1e-5 (another fold or matmul order); the PLUS semirings also
equal scipy's product.  The diagonal-B fast path, the dims shortcut,
the dense tier's cell budget, the re-filled zeros of the scipy tier and
the host helpers (relabel, pattern, pair membership) are held to the
JAX package too.  Integer DIV is left out: the JAX package's diagonal
path computes it apart from its mul op (gustavson.py:212).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.base import options_set as joptions
from pygraphblas_tpu.core import coosem as jcs, gustavson as jg
from pygraphblas_tpu_torch import base, options_set, types
from pygraphblas_tpu_torch.core import coosem, dense, gustavson
from pygraphblas_tpu_torch.testing import SR_CASES, sr_values

CPU = torch.device("cpu")


@pytest.fixture
def engine():
    """Set the engine in both packages; back to "auto" after."""
    def set_engine(name):
        joptions(spgemm_engine=name)
        options_set(spgemm_engine=name)
    yield set_engine
    set_engine("auto")
    joptions(spgemm_dense_cells=1 << 24)
    options_set(spgemm_dense_cells=1 << 24)


def _coo(n, m, nnz, seed, dt):
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, n * m, nnz))
    r, c = (keys // m).astype(np.int64), (keys % m).astype(np.int64)
    v = (rng.rand(len(r)) + 0.5) if dt == np.float32 else \
        rng.randint(1, 9, len(r))
    return r, c, v.astype(dt)


def _operands(dt, n=300, nnz=2500):
    return _coo(n, n, nnz, 3, dt) + _coo(n, n, nnz, 4, dt)


def _same(got, want, dt):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2].dtype == np.asarray(want[2]).dtype
    if dt == np.float32:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    else:
        assert np.array_equal(got[2], want[2])


def _scipy(ops, n, mul):
    ra, ca, va, rb, cb, vb = ops
    if mul == "PAIR":
        va, vb = np.ones(len(ra)), np.ones(len(rb))
    C = (sp.csr_matrix((va.astype(np.float64), (ra, ca)), (n, n))
         @ sp.csr_matrix((vb.astype(np.float64), (rb, cb)), (n, n)))
    C.sort_indices()
    C = C.tocoo()
    return C.row, C.col, C.data


@pytest.mark.parametrize("eng", ["auto", "dense", "esc", "scipy"])
@pytest.mark.parametrize("sem,typ", [("PLUS_TIMES", "FP32"),
                                     ("PLUS_PAIR", "INT32"),
                                     ("MIN_PLUS", "INT32")])
def test_spgemm_engines_match_jax(sem, typ, eng, engine):
    """Every tier on the same operands; MIN_PLUS has no dense tier (it
    falls through in both packages) and takes the generic tier (the
    masked SpGEMM) under "scipy"."""
    dt = getattr(types, typ).numpy_dtype
    ops = _operands(dt)
    engine(eng)
    want = jg.spgemm(*ops, getattr(getattr(jtypes, typ), sem), dt)
    got = gustavson.spgemm(*ops, getattr(getattr(types, typ), sem), dt,
                           device=CPU)
    _same(got, want, dt)
    if sem.startswith("PLUS"):
        r, c, v = _scipy(ops, 300, sem.split("_")[1])
        assert np.array_equal(got[0], r) and np.array_equal(got[1], c)
        np.testing.assert_allclose(got[2], v, rtol=1e-5)


@pytest.mark.parametrize("mul", ["TIMES", "PLUS", "MINUS", "RMINUS", "MIN",
                                 "MAX", "FIRST", "SECOND", "PAIR"])
def test_diagonal_b_path_matches_jax(mul, engine):
    """B diagonal (some of its entries missing): C = A scaled column by
    column, whatever the engine."""
    ra, ca, va = _coo(200, 200, 3000, 5, np.float32)
    d = np.arange(0, 200, 3, dtype=np.int64)
    dv = np.random.RandomState(6).rand(len(d)).astype(np.float32) + 0.5
    engine("esc")
    sem = f"PLUS_{mul}"
    want = jg.spgemm(ra, ca, va, d, d, dv, getattr(jtypes.FP32, sem),
                     np.float32)
    got = gustavson.spgemm(ra, ca, va, d, d, dv, getattr(types.FP32, sem),
                           np.float32, device=CPU)
    _same(got, want, np.float32)
    assert len(got[0]) == np.isin(ca, d).sum()


@pytest.mark.parametrize("sem,typ", [("PLUS_TIMES", "FP32"),
                                     ("MAX_PLUS", "INT32")])
def test_dims_shortcut_matches_jax(sem, typ, engine):
    """dims given (no relabel in the host tiers) == no dims == the JAX
    package with dims."""
    dt = getattr(types, typ).numpy_dtype
    ops = _operands(dt)
    engine("scipy")
    jsem, tsem = getattr(getattr(jtypes, typ), sem), getattr(
        getattr(types, typ), sem)
    want = jg.spgemm(*ops, jsem, dt, dims=(300, 300, 300))
    got = gustavson.spgemm(*ops, tsem, dt, dims=(300, 300, 300),
                           device=CPU)
    _same(got, want, dt)
    _same(gustavson.spgemm(*ops, tsem, dt, device=CPU), got, dt)


def test_scipy_tier_refills_zeros(engine):
    """scipy prunes 1*1 + (-1)*1 = 0; the tier keeps it as a stored
    zero, as the JAX package does."""
    args = (np.array([5, 5, 6]), np.array([1, 2, 2]),
            np.array([1.0, -1.0, 2.0], np.float32), np.array([1, 2]),
            np.array([7, 7]), np.array([1.0, 1.0], np.float32))
    engine("scipy")
    want = jg.spgemm(*args, jtypes.FP32.PLUS_TIMES, np.float32)
    got = gustavson.spgemm(*args, types.FP32.PLUS_TIMES, np.float32,
                           device=CPU)
    _same(got, want, np.float32)
    assert got[2].tolist() == [0.0, 2.0]


def test_dense_tier_budget(engine):
    """Within spgemm_dense_cells the dense tier answers, equal to the
    JAX package's; with the budget lowered both return None."""
    ops = _operands(np.float32, n=120, nnz=900)
    want = jg.dense_spgemm(*ops, jtypes.FP32.PLUS_TIMES, np.float32)
    got = gustavson.dense_spgemm(*ops, types.FP32.PLUS_TIMES, np.float32,
                                 device=CPU)
    _same(got, want, np.float32)
    joptions(spgemm_dense_cells=1 << 10)
    options_set(spgemm_dense_cells=1 << 10)
    assert jg.dense_spgemm(*ops, jtypes.FP32.PLUS_TIMES, np.float32) is None
    assert gustavson.dense_spgemm(*ops, types.FP32.PLUS_TIMES, np.float32,
                                  device=CPU) is None


def test_dense_ok_and_matmul_rules():
    """The dense tier's algebra rules on the CPU equal the JAX
    package's; on the card only float32 (and float16) matmuls."""
    card = torch.device("cuda")
    for sem, typ in (("PLUS_TIMES", "FP32"), ("PLUS_PAIR", "INT32"),
                     ("MIN_PLUS", "INT32"), ("PLUS_TIMES", "INT64"),
                     ("MAX_TIMES", "FP32"), ("PLUS_FIRST", "FP32")):
        dt = getattr(types, typ).numpy_dtype
        assert gustavson._dense_ok(getattr(getattr(types, typ), sem), dt,
                                   64, CPU) == \
            jg._dense_ok(getattr(getattr(jtypes, typ), sem), dt, 64)
    assert dense._matmul_ok(np.float32, card)
    assert not dense._matmul_ok(np.int32, card)
    assert not gustavson._dense_ok(types.INT32.PLUS_PAIR, np.int32,
                                   (1 << 24) + 1, card)


def test_relabel_pattern_and_sample_equal_jax():
    ra, ca, _ = _coo(10 ** 6, 10 ** 6, 4000, 8, np.int32)
    rb, cb, _ = _coo(10 ** 6, 10 ** 6, 4000, 9, np.int32)
    # B rows that meet A's columns, so the product is not empty
    rb = np.concatenate([rb, ca[:500]])
    cb = np.concatenate([cb, ra[:500]])
    o = np.lexsort((cb, rb))
    rb, cb = rb[o], cb[o]
    for g, w in zip(gustavson._relabel(ra, ca, rb, cb),
                    jg._relabel(ra, ca, rb, cb)):
        for x, y in zip(g, w):
            assert np.array_equal(x, y)
    got = gustavson.pattern(ra, ca, rb, cb)
    assert len(got[0]) > 500
    for x, y in zip(got, jg.pattern(ra, ca, rb, cb)):
        assert np.array_equal(x, y)
    for arr in (ra, ca[:100]):
        assert gustavson._sample_distinct_lb(arr) == \
            jg._sample_distinct_lb(arr)


@pytest.mark.parametrize("hi", [5000, 1 << 40])
def test_in_sorted_and_pair_keys_equal_jax(hi):
    """Packed int64 keys (small ids) and structured pairs (ids past the
    packing width)."""
    rng = np.random.RandomState(hi % 89)
    key = np.unique(rng.randint(0, 300, 2000) * hi + rng.randint(0, hi, 2000))
    sr, sc = key // hi, key % hi
    r = np.concatenate([sr[::3], rng.randint(0, 300, 500)])
    c = np.concatenate([sc[::3], rng.randint(0, hi, 500)])
    for g, w in zip(coosem.pair_keys(r, c, sr, sc),
                    jcs.pair_keys(r, c, sr, sc)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    got = coosem.in_sorted(r, c, sr, sc)
    assert np.array_equal(got, jcs.in_sorted(r, c, sr, sc))
    assert 0 < got.sum() < len(r)


def test_options_validate_as_jax():
    with pytest.raises(ValueError, match="spgemm_engine"):
        options_set(spgemm_engine="gpu")
    options_set(spgemm_dense_cells=1 << 20)
    assert base.config.spgemm_dense_cells == 1 << 20
    options_set(spgemm_dense_cells=1 << 24)
    assert base.config.spgemm_engine == "auto"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ops = _operands(np.float32, n=50, nnz=200)
    with pytest.raises(RuntimeError, match="CUDA"):
        gustavson.spgemm(*ops, types.FP32.PLUS_TIMES, np.float32)


@pytest.mark.parametrize("sem,typ", SR_CASES + [("MAX_MINUS", "INT32")])
def test_dense_mxm_algebra_matches_jax(sem, typ):
    """core/dense.py's mxm on 16 x 16 operands, half their cells present:
    LOR_LAND over BOOL lowers to a matmul, the rest take the generic
    k-blocked broadcast-reduce (first present product initialises); the
    values and the pattern equal the JAX package's exactly."""
    from pygraphblas_tpu.core import dense as jdense
    from pygraphblas_tpu_torch import convert

    rng = np.random.RandomState(len(sem))
    T = convert.type_from_name(typ)
    dt = T.numpy_dtype
    vals = sr_values(typ, 512, 4) if typ != "INT32" else \
        rng.randint(-50, 50, 512).astype(np.int32)
    av, bv = vals[:256].reshape(16, 16), vals[256:].reshape(16, 16)
    am, bm = rng.rand(16, 16) < 0.5, rng.rand(16, 16) < 0.5
    jsem = getattr(getattr(jtypes, typ), sem)
    wv, wm = jdense.mxm(av, am, bv, bm, jsem, dt)
    gv, gm = dense.mxm(T.to_torch(av), torch.from_numpy(am),
                       T.to_torch(bv), torch.from_numpy(bm),
                       convert.semiring_from_name(jsem.name), dt)
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    m = np.asarray(wm)
    assert np.array_equal(T.to_numpy(gv)[m], np.asarray(wv)[m])


def test_dense_tier_takes_lor_land_over_bool(engine):
    """gustavson._dense_ok admits LOR/ANY with LAND, PAIR, FIRST, SECOND
    or TIMES into BOOL (gustavson.py:44-61): the dense tier runs BOOL
    LOR_LAND as a matmul in both packages."""
    ops = list(_operands(np.int32))
    ops[2] = ops[2] % 3 != 0
    ops[5] = ops[5] % 3 != 0
    assert gustavson._dense_ok(types.BOOL.LOR_LAND, np.bool_, 512, CPU)
    assert not gustavson._dense_ok(types.INT8.ANY_PAIR, np.int8, 512, CPU)
    engine("dense")
    want = jg.spgemm(*ops, jtypes.BOOL.LOR_LAND, np.bool_)
    got = gustavson.spgemm(*ops, types.BOOL.LOR_LAND, np.bool_, device=CPU)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
