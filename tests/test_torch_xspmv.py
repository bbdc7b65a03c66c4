"""Port parity: pygraphblas_tpu_torch.core.xspmv against the JAX package.

The JAX plan is flattened here (jax.tree_util.tree_flatten + np.asarray)
and carried into the port by convert.py, so both packages run the very
same plan; patterns must match exactly and values within rtol 1e-5.
The port's own plan must give the same y, and its monotone plans must
equal the JAX ones array for array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygraphblas_tpu.core.xspmv as JX
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu_torch import convert, types as ttypes
from pygraphblas_tpu_torch.core import xspmv as TX

MONO_STATIC = ("S", "blk", "src_n", "src_rows", "max_w", "stream", "xb",
               "xblk_max", "ok", "wva")


def _mono_dict(p):
    leaves, _ = jax.tree_util.tree_flatten(p)
    d = dict(zip(("q0", "dm", "xblk", "qg"), map(np.asarray, leaves)))
    d.update(zip(MONO_STATIC, p._aux()))
    return d


def _perm_dict(p):
    leaves = [np.asarray(a) for a in jax.tree_util.tree_flatten(p)[0]]
    d = {k: getattr(p, k) for k in ("n", "trivial", "D", "S", "R0", "K")}
    if p.trivial:
        d["src_idx"] = leaves[0]
        return d
    nst = len(p.a_stages)
    d["a_stages"] = leaves[:nst]
    d["c_stages"] = leaves[nst:2 * nst]
    d["ssel"] = leaves[2 * nst] if len(leaves) > 2 * nst else None
    return d


def xspmv_dict(p):
    d = {k: getattr(p, k) for k in ("nrows", "ncols", "nnz", "dtype",
                                    "n_perm", "m1", "s1")}
    d["pre"] = _mono_dict(p.pre)
    d["decode"] = _mono_dict(p.decode)
    d["perm"] = _perm_dict(p.perm)
    d["vals_col"] = np.asarray(p.vals_col)
    d["levels"] = [_mono_dict(lp) for lp in p.levels]
    d["places"] = [_mono_dict(pp) for pp in p.places]
    d["row_present"] = np.asarray(p.row_present)
    return d


def _rand_coo(n_r, n_c, nnz, seed):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, n_r, nnz)
    c = rng.randint(0, n_c, nnz)
    _, ui = np.unique(r.astype(np.int64) * n_c + c, return_index=True)
    r, c = r[ui], c[ui]
    v = rng.rand(len(r)).astype(np.float32) + 0.5
    return r, c, v, rng


GRID = [
    ("PLUS_TIMES", 300, 400, 5000, False),
    ("MIN_PLUS", 1000, 1000, 30000, False),
    ("MAX_FIRST", 50, 60, 300, False),
    ("PLUS_SECOND", 512, 512, 8000, False),
    ("PLUS_PAIR", 200, 200, 2000, False),
    ("PLUS_FIRST", 700, 700, 9000, True),
    ("PLUS_SECOND", 700, 700, 9000, True),
    ("MIN_FIRST", 700, 700, 9000, True),
    ("MAX_SECOND", 700, 700, 9000, True),
]


@pytest.mark.parametrize("sem_name,n_r,n_c,nnz,flip", GRID)
def test_xspmv_matches_jax(sem_name, n_r, n_c, nnz, flip, monkeypatch):
    monkeypatch.setattr(JX, "MIN_NNZ", 1)
    monkeypatch.setattr(TX, "MIN_NNZ", 1)
    r, c, v, rng = _rand_coo(n_r, n_c, nnz, 77 if flip else
                             sum(map(ord, sem_name)))
    jsem = getattr(jtypes.FP32, sem_name)
    tsem = getattr(ttypes.FP32, sem_name)
    assert TX.supported(tsem, np.float32, len(r))
    jplan = JX.XSpmvPlan.build(r, c, v, n_r, n_c, np.float32, cache=False)
    x = rng.rand(n_c).astype(np.float32)
    yj, pj = JX.xspmv(jplan, jnp.asarray(x), jsem, np.float32,
                      flip_mul=flip)
    yj, pj = np.asarray(yj), np.asarray(pj)

    # the same plan, carried across
    tplan = convert.xspmv_plan_from_arrays(xspmv_dict(jplan), "cpu")
    y, pres = TX.xspmv(tplan, torch.from_numpy(x), tsem, np.float32,
                       flip_mul=flip)
    y, pres = y.numpy(), pres.numpy()
    assert np.array_equal(pres, pj)
    assert np.allclose(y[pj], yj[pj], rtol=1e-5)

    # the port's own plan
    own = TX.XSpmvPlan.build(r, c, v, n_r, n_c, np.float32, cache=False)
    for name in ("pre", "decode"):
        a, b = getattr(own, name), getattr(jplan, name)
        assert np.array_equal(a.dm, np.asarray(b.dm))
        assert np.array_equal(a.qg, np.asarray(b.qg))
    assert len(own.levels) == len(jplan.levels)
    assert (own.n_perm, own.m1) == (jplan.n_perm, jplan.m1)
    y2, pres2 = TX.xspmv(own.to("cpu"), torch.from_numpy(x), tsem,
                         np.float32, flip_mul=flip)
    assert np.array_equal(pres2.numpy(), pj)
    assert np.allclose(y2.numpy()[pj], yj[pj], rtol=1e-5)


def test_int32_plus_times(monkeypatch):
    monkeypatch.setattr(JX, "MIN_NNZ", 1)
    r, c, _, rng = _rand_coo(400, 400, 6000, 5)
    v = rng.randint(-5, 6, len(r)).astype(np.int32)
    x = rng.randint(-9, 10, 400).astype(np.int32)
    jplan = JX.XSpmvPlan.build(r, c, v, 400, 400, np.int32, cache=False)
    yj, pj = JX.xspmv(jplan, jnp.asarray(x), jtypes.INT32.PLUS_TIMES,
                      np.int32)
    tplan = TX.XSpmvPlan.build(r, c, v, 400, 400, np.int32,
                               cache=False).to("cpu")
    y, p = TX.xspmv(tplan, torch.from_numpy(x), ttypes.INT32.PLUS_TIMES,
                    np.int32)
    assert np.array_equal(p.numpy(), np.asarray(pj))
    assert np.array_equal(y.numpy(), np.asarray(yj))


def test_plan_state_roundtrip(tmp_path):
    """The disk-cache format (numpy arrays only) restores the plan."""
    r, c, v, rng = _rand_coo(600, 600, 9000, 3)
    plan = TX.XSpmvPlan.build(r, c, v, 600, 600, np.float32, cache=False)
    path = tmp_path / "p.npz"
    np.savez(path, **TX._flatten(plan.state()))
    with np.load(path) as z:
        back = TX.XSpmvPlan.from_state(TX._unflatten(z), "cpu")
    x = torch.from_numpy(rng.rand(600).astype(np.float32))
    sem = ttypes.FP32.PLUS_TIMES
    y1, p1 = TX.xspmv(plan.to("cpu"), x, sem, np.float32)
    y2, p2 = TX.xspmv(back, x, sem, np.float32)
    assert torch.equal(y1, y2) and torch.equal(p1, p2)
    assert TX.PLAN_CACHE_DIR != JX.PLAN_CACHE_DIR


def test_min_nnz_gate():
    assert not TX.supported(ttypes.FP32.PLUS_SECOND, np.float32,
                            TX.MIN_NNZ - 1)
    assert TX.supported(ttypes.FP32.PLUS_SECOND, np.float32, TX.MIN_NNZ)


@pytest.mark.parametrize("route", ["per_row", "streamed"])
def test_convert_carries_perrow_and_streamed_monoplans(route, monkeypatch):
    """Per-row (wva == 0) and streamed MonoPlans carry across from the
    JAX arrays: q0, dm (int16 or int32), xblk, xb, xblk_max, and gather
    as the JAX plain path does."""
    import pygraphblas_tpu.core.mono as jmono
    from pygraphblas_tpu_torch.core import mono as tmono

    rng = np.random.RandomState(9)
    if route == "per_row":
        monkeypatch.setattr(jmono, "_SPAN_MAX_WVA", 0)
        src_n = 2_500_000          # resident; rows span > 32767: int32 dm
        idx = np.sort(rng.randint(0, src_n, 64 * 128))
    else:
        src_n = 3_000_000
        idx = np.sort(rng.randint(0, 1_500_000, 3 * 64 * 128))
    jp = jmono.MonoPlan.build(idx, src_n)
    d = _mono_dict(jp)
    tp = convert.mono_plan_from_arrays(d, "cpu")
    assert tp.wva == 0 and tp.ok and tp.stream == (route == "streamed")
    if route == "per_row":
        assert tp.dm.dtype == torch.int32
    else:
        assert tp.xblk_max > 0 and tp.xb > 0
    for k in MONO_STATIC:
        assert getattr(tp, k) == d[k], k
    for k in ("q0", "dm", "xblk", "qg"):
        assert np.array_equal(getattr(tp, k).numpy(), d[k]), k
    src = rng.rand(src_n).astype(np.float32)
    want = np.asarray(jmono.mono_gather(jp, jnp.asarray(src), 0.0,
                                        fold=lambda a, b: a + b))
    got = tmono.mono_gather(tp, torch.from_numpy(src), 0.0, fold="PLUS")
    assert np.allclose(got.numpy(), want, rtol=1e-6)
