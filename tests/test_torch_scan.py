"""Port parity: pygraphblas_tpu_torch.core.scan against the JAX package.

The plain version of kernel 12 (what ``segfold`` runs on CPU tensors)
must equal the JAX Pallas kernel ``_segfold_pallas`` run in interpret
mode, and ``segfold_scan``'s CPU path (``lax.associative_scan``), on the
same inputs: integer folds and MIN/MAX exactly, float32 PLUS within
rtol 1e-5 (another fold order).
"""

import functools

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygraphblas_tpu.core import scan as jscan
from pygraphblas_tpu_torch.core import scan

FOLDS = {"PLUS": lambda a, b: a + b, "MIN": jnp.minimum, "MAX": jnp.maximum}


def _ident(add, dt):
    if add == "PLUS":
        return dt(0)
    if dt == np.float32:
        return dt(np.inf if add == "MIN" else -np.inf)
    info = np.iinfo(dt)
    return dt(info.max if add == "MIN" else info.min)


def _inputs(m, dt, seed):
    """Values and start flags (about 1 in 20, the first one set, and a
    run longer than a 128-lane row)."""
    rng = np.random.RandomState(seed)
    v = (rng.randint(-1000, 1000, m).astype(dt) if dt == np.int32
         else (rng.rand(m) * 8 - 4).astype(dt))
    f = rng.rand(m) < 0.05
    f[0] = True
    f[300:600] = False
    return v, f


def _check(got, want, dt, add):
    got = got.numpy()
    assert got.dtype == want.dtype
    if dt == np.float32 and add == "PLUS":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dt", [np.int32, np.float32])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
@pytest.mark.parametrize("m", [1024, 2048])
def test_segfold_plain_matches_pallas(m, add, dt, monkeypatch):
    """Kernel 12 (_segfold_pallas) in interpret mode == segfold on CPU
    tensors."""
    v, f = _inputs(m, dt, m + len(add))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    want = np.asarray(jscan._segfold_pallas(
        jnp.asarray(v), jnp.asarray(f), FOLDS[add], _ident(add, dt)))
    got = scan.segfold(torch.from_numpy(v), torch.from_numpy(f), add)
    _check(got, want, dt, add)


@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_segfold_plain_matches_pallas_across_blocks(dt, monkeypatch):
    """M = 3072: the Pallas kernel runs a grid of three 1024-value blocks
    and carries across them in SMEM; PLUS, the plain version."""
    v, f = _inputs(3072, dt, 11)
    f[1000:2100] = False          # a segment that spans a block boundary
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    want = np.asarray(jscan._segfold_pallas(
        jnp.asarray(v), jnp.asarray(f), FOLDS["PLUS"], dt(0)))
    got = scan.segfold(torch.from_numpy(v), torch.from_numpy(f), "PLUS")
    _check(got, want, dt, "PLUS")


@pytest.mark.parametrize("dt", [np.int32, np.float32])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
def test_segfold_plain_matches_cpu_path(add, dt):
    """segfold_scan's CPU path (lax.associative_scan) == segfold on CPU
    tensors."""
    v, f = _inputs(4096, dt, 7)
    want = np.asarray(jscan.segfold_scan(jnp.asarray(v), jnp.asarray(f),
                                         FOLDS[add], _ident(add, dt)))
    got = scan.segfold(torch.from_numpy(v), torch.from_numpy(f), add)
    _check(got, want, dt, add)


def test_segfold_single_segment_and_every_start():
    """One segment (a plain prefix fold) and a start at every element
    (the values themselves)."""
    v = np.arange(1, 2049, dtype=np.int32)
    f = np.zeros(2048, bool)
    f[0] = True
    got = scan.segfold(torch.from_numpy(v), torch.from_numpy(f), "PLUS")
    assert np.array_equal(got.numpy(), np.cumsum(v).astype(np.int32))
    got = scan.segfold(torch.from_numpy(v), torch.ones(2048, dtype=bool),
                       "MAX")
    assert np.array_equal(got.numpy(), v)


def test_segfold_needs_1024_multiple():
    with pytest.raises(ValueError, match="1024"):
        scan.segfold(torch.zeros(1000, dtype=torch.int32),
                     torch.zeros(1000, dtype=torch.bool), "PLUS")


# the folds the algebra adds (logical, bitwise, ANY) and the narrow and
# unsigned types, each at one type
NEW_FOLDS = [("LOR", "BOOL"), ("LAND", "BOOL"), ("LXOR", "BOOL"),
             ("EQ", "BOOL"), ("ANY", "INT8"), ("BOR", "UINT32"),
             ("BAND", "UINT32"), ("BXOR", "UINT16"), ("BXNOR", "UINT8"),
             ("MIN", "UINT32"), ("MAX", "INT16"), ("TIMES", "INT8"),
             ("PLUS", "UINT16")]


@pytest.mark.parametrize("add,typ", NEW_FOLDS)
def test_segfold_new_folds_match_jax_monoid(add, typ):
    """segfold on CPU tensors with the port's monoid == the segmented
    fold, element by element, of the JAX monoid of the same name (its
    closure on scalars); ANY (the kernels fold it as MAX, the JAX package
    as SECOND) gives a value of the segment so far."""
    from pygraphblas_tpu import monoid as jmonoid
    from pygraphblas_tpu_torch import convert

    name = f"{add}_{typ}_monoid"
    jm, tm = getattr(jmonoid, name), convert.monoid_from_name(name)
    T = convert.type_from_name(typ)
    dt = T.numpy_dtype
    rng = np.random.RandomState(len(name))
    v = (rng.rand(1024) < 0.6 if dt == np.bool_ else
         rng.randint(0, 1 << 62, 1024, dtype=np.int64).astype(dt))
    f = rng.rand(1024) < 0.05
    f[0] = True
    got = T.to_numpy(scan.segfold(T.to_torch(v), torch.from_numpy(f), tm))
    assert got.dtype == dt
    if add == "ANY":
        start = np.maximum.accumulate(np.where(f, np.arange(1024), 0))
        assert all(got[i] in v[start[i]:i + 1] for i in range(1024))
        return
    want = np.empty_like(v)
    acc = None
    with np.errstate(over="ignore"):      # the integer folds wrap
        for i in range(1024):
            acc = v[i] if f[i] else np.asarray(jm.binaryop.apply(acc, v[i]))
            want[i] = acc
    assert np.array_equal(got, want)
