"""The port's ESC engine (``core/esc.esc_spgemm``) against the JAX
package's on the CPU: A @ A on RMAT graphs under four semirings and a
product of rectangular, hypersparse operands.  The slowest cases of
tests/test_torch_esc.py, in a file of their own so that the suite's
workers run them beside its longest file.  Rows and columns exact,
values exact or within rtol 1e-5 for float32."""

import numpy as np
import pytest
import torch

from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.core import esc as jesc
from pygraphblas_tpu_torch import generators, types
from pygraphblas_tpu_torch.core import esc

CPU = torch.device("cpu")


def _kron(scale, seed=7):
    rows, cols, _ = generators.rmat_edges(scale, 8)
    vals = np.random.RandomState(seed).rand(len(rows)) * 3 + 0.25
    return rows, cols, vals


def _same(got, want, rtol=None):
    assert got is not None and want is not None
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2].dtype == np.asarray(want[2]).dtype
    if rtol is None:
        assert np.array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=rtol)


@pytest.mark.parametrize("sem,typ,scale", [("PLUS_TIMES", "FP32", 10),
                                           ("PLUS_PAIR", "INT32", 9),
                                           ("MIN_PLUS", "INT32", 9),
                                           ("MAX_TIMES", "INT32", 9)])
def test_esc_spgemm_matches_jax(sem, typ, scale):
    """A @ A on an RMAT graph (integer values 1..4 for INT32)."""
    r, c, v = _kron(scale)
    dt = getattr(types, typ).numpy_dtype
    v = v.astype(dt) if dt == np.float32 else (v + 1).astype(dt)
    want = jesc.esc_spgemm(r, c, v, r, c, v,
                           getattr(getattr(jtypes, typ), sem), dt)
    got = esc.esc_spgemm(r, c, v, r, c, v,
                         getattr(getattr(types, typ), sem), dt, device=CPU)
    assert len(want[0]) > 10000
    _same(got, want, 1e-5 if dt == np.float32 else None)


def test_esc_rectangular_operands_match_jax():
    """A (rows of one kron graph) times B (another), hypersparse ids."""
    r, c, v = _kron(9, seed=1)
    rb, cb, vb = _kron(9, seed=2)
    big = 10 ** 12
    ra, cb2 = r * 1_000_003 % big, cb * 7 + big
    o = np.lexsort((c, ra))
    ra, ca, va = ra[o], c[o], v[o].astype(np.float32)
    vb = vb.astype(np.float32)
    want = jesc.esc_spgemm(ra, ca, va, rb, cb2, vb, jtypes.FP32.PLUS_TIMES,
                           np.float32)
    got = esc.esc_spgemm(ra, ca, va, rb, cb2, vb, types.FP32.PLUS_TIMES,
                         np.float32, device=CPU)
    _same(got, want, 1e-5)
