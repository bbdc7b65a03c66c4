"""Port parity: pygraphblas_tpu_torch.core.esc against the JAX package.

The plain version of kernel 13 (what ``esc_gather`` runs on CPU tensors)
must equal the JAX Pallas kernel ``_esc_gw_gather`` run in interpret
mode (with the JAX module's TPU test made true inside the test only),
exactly.  ``esc_spgemm`` with ``device="cpu"`` must give the JAX
package's ``esc_spgemm`` on the same operands (RMAT kron-9 and kron-10,
values from one seed): rows and columns exactly, INT32 values exactly,
FP32 PLUS_TIMES values within rtol 1e-5 (another fold order), and
return None where the JAX package's does.
"""

import functools

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.core import esc as jesc
from pygraphblas_tpu_torch import (_kernels, binaryop, convert, generators,
                                   monoid, semiring, types)
from pygraphblas_tpu_torch.core import esc
from pygraphblas_tpu_torch.testing import SR_CASES, sr_values

CPU = torch.device("cpu")


def _gather_inputs(S, rows_src, span_max, seed):
    """A group-window gather as the ESC engine encodes it: per 8-row
    group a base row qg and a span, per slot dm with dm >> 7 in
    [0, span)."""
    rng = np.random.RandomState(seed)
    G = S // 8
    span = rng.randint(1, span_max + 1, G).astype(np.int32)
    qg = rng.randint(0, rows_src - span_max, G).astype(np.int32)
    dm = (rng.randint(0, 1 << 20, (S, 128))
          % (np.repeat(span, 8)[:, None] * 128)).astype(np.int32)
    cols = rng.randint(0, 1 << 20, (rows_src, 128)).astype(np.int32)
    vals = rng.rand(rows_src, 128).astype(np.float32)
    return cols, vals, qg, span, dm


@pytest.mark.parametrize("span_max", [2, 16])
def test_esc_gather_plain_matches_pallas(span_max, monkeypatch):
    """Kernel 13 (_esc_gw_gather) in interpret mode == esc_gather on CPU
    tensors at every slot; span_max 16 runs its dynamic span loop."""
    cols, vals, qg, span, dm = _gather_inputs(32, 64, span_max, span_max)
    monkeypatch.setattr(jesc, "_on_tpu", lambda: True)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    wc, wv = jesc._esc_gw_gather(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(qg), jnp.asarray(span),
                                 jnp.asarray(dm), span_max)
    gc, gv = esc.esc_gather(*[torch.from_numpy(x)
                              for x in (cols, vals, qg, dm)])
    assert gc.dtype == torch.int32 and gv.dtype == torch.float32
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


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


def test_esc_explicit_zero_kept():
    """1*1 + (-1)*1 = 0 stays a stored entry (test_spgemm_engines.py:111)."""
    args = (np.array([5, 5]), np.array([1, 2]),
            np.array([1.0, -1.0], np.float32), np.array([1, 2]),
            np.array([7, 7]), np.array([1.0, 1.0], np.float32))
    want = jesc.esc_spgemm(*args, jtypes.FP32.PLUS_TIMES, np.float32)
    got = esc.esc_spgemm(*args, types.FP32.PLUS_TIMES, np.float32,
                         device=CPU)
    _same(got, want)
    assert got[0].tolist() == [5] and got[1].tolist() == [7]
    assert got[2].tolist() == [0.0]


def test_esc_heavy_multiplicity():
    """One inner index shared by 500 A entries, empty B rows between
    (test_spgemm_engines.py:127)."""
    rng = np.random.RandomState(7)
    m = 500
    ra = np.arange(m, dtype=np.int64)
    ca = np.zeros(m, np.int64)
    va = rng.rand(m).astype(np.float32)
    rb = np.concatenate([np.zeros(40, np.int64), [3], [9]])
    cb = np.concatenate([np.arange(40, dtype=np.int64), [2], [4]])
    vb = rng.rand(len(rb)).astype(np.float32)
    o = np.argsort(rb * 10**6 + cb, kind="stable")
    rb, cb, vb = rb[o], cb[o], vb[o]
    want = jesc.esc_spgemm(ra, ca, va, rb, cb, vb, jtypes.FP32.PLUS_TIMES,
                           np.float32)
    got = esc.esc_spgemm(ra, ca, va, rb, cb, vb, types.FP32.PLUS_TIMES,
                         np.float32, device=CPU)
    _same(got, want, 1e-5)
    assert len(got[0]) == m * 40


@pytest.mark.parametrize("cap", ["MAX_F", "_SPAN_CAP"])
def test_esc_falls_back_where_jax_does(cap, monkeypatch):
    """With MAX_F or _SPAN_CAP lowered in both packages, both return
    None (the caller then takes the host tiers)."""
    r, c, v = _kron(9)
    v = v.astype(np.float32)
    low = {"MAX_F": 1 << 12, "_SPAN_CAP": 4}[cap]
    monkeypatch.setattr(jesc, cap, low)
    monkeypatch.setattr(esc, cap, low)
    assert jesc.esc_spgemm(r, c, v, r, c, v, jtypes.FP32.PLUS_TIMES,
                           np.float32) is None
    assert esc.esc_spgemm(r, c, v, r, c, v, types.FP32.PLUS_TIMES,
                          np.float32, device=CPU) is None


def test_esc_supported_dtype_rules():
    """8-byte dtypes are refused on the card (as on a TPU) and taken on
    the CPU; on the card every dtype of 4 bytes or less is taken (as on
    a TPU), a user add monoid that lowers to a generated fold is taken
    (as the JAX kernel folds with any traced monoid), and one that does
    not lower (a value-dependent branch) is refused, with its reason in
    ``_kernels.unlowered``."""
    sem = types.INT64.PLUS_TIMES
    card = torch.device("cuda")
    for dt in (np.int64, np.float64):
        assert esc.esc_supported(sem, dt, dt, dt, CPU)
        assert not esc.esc_supported(sem, dt, dt, dt, card)
    assert esc.esc_supported(sem, np.float32, np.int32, np.bool_, card)
    assert esc.esc_supported(sem, np.bool_, np.bool_, np.bool_, card)
    for dt in (np.int8, np.int16, np.uint8, np.uint16, np.uint32):
        assert esc.esc_supported(sem, dt, dt, dt, card)
    assert not esc.esc_supported(sem, np.float32, np.int64, np.int32, card)
    user = monoid.Monoid("PLUS", "INT32", op_obj=binaryop.binary_op(
        types.INT32)(lambda x, y: x + y), identity=0, attach=False)
    usr = semiring.Semiring("PLUS", "TIMES", "INT32", add=user,
                            attach=False)
    assert esc.esc_supported(usr, np.int32, np.int32, np.int32, CPU)
    assert esc.esc_supported(usr, np.int32, np.int32, np.int32, card)

    def branchy(x, y):
        return x + y if bool((x > 0).all()) else x - y

    lost = monoid.Monoid("PLUS", "INT32", op_obj=binaryop.binary_op(
        types.INT32)(branchy), identity=0, attach=False)
    usr = semiring.Semiring("PLUS", "TIMES", "INT32", add=lost,
                            attach=False)
    assert esc.esc_supported(usr, np.int32, np.int32, np.int32, CPU)
    assert not esc.esc_supported(usr, np.int32, np.int32, np.int32, card)
    assert "tracing failed" in _kernels.unlowered["branchy_INT32"]


def test_esc_empty_operands():
    e = np.empty(0, np.int64)
    got = esc.esc_spgemm(e, e, np.empty(0, np.float32), np.array([1]),
                         np.array([2]), np.ones(1, np.float32),
                         types.FP32.PLUS_TIMES, np.float32, device=CPU)
    assert all(len(x) == 0 for x in got) and got[2].dtype == np.float32


def _same_any(got, want, products):
    """ANY: the pattern as the JAX package's, each value one of its
    cell's products (`products`: the set of all of them, here all 1)."""
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2].dtype == np.asarray(want[2]).dtype
    assert np.isin(got[2], products).all()


@pytest.mark.parametrize("sem,typ", SR_CASES)
def test_esc_algebra_matches_jax(sem, typ):
    """A @ A at kron-8 under each of the algebra's cases (semirings
    carried across by name): ESC on the CPU gives the JAX package's
    product (its generic tier: scipy's pattern, then the masked SpGEMM;
    one XLA compile a case, where its ESC takes two), the same pattern
    and values (exact; ANY: one of the cell's products)."""
    from pygraphblas_tpu.base import options_set as joptions
    from pygraphblas_tpu.core import gustavson as jg

    r, c, _ = _kron(8)
    v = sr_values(typ, len(r), 8)
    jsem = getattr(getattr(jtypes, typ), sem)
    dt = v.dtype
    joptions(spgemm_engine="scipy")
    try:
        want = jg.spgemm(r, c, v, r, c, v, jsem, dt)
    finally:
        joptions(spgemm_engine="auto")
    got = esc.esc_spgemm(r, c, v, r, c, v,
                         convert.semiring_from_name(jsem.name), dt,
                         device=CPU)
    assert len(want[0]) > 1000
    if sem.startswith("ANY"):
        _same_any(got, want, [1])
    else:
        _same(got, want)
