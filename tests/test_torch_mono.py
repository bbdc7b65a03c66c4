"""Port parity: pygraphblas_tpu_torch.core.mono against the JAX package.

MonoPlan arrays must equal exactly; the plain version of the span
kernel (what the port runs on CPU tensors) must equal the JAX Pallas
span kernel run in interpret mode: gathers and products exactly, PLUS
folds within rtol 1e-6 (the same s = 0..7 order, so in practice equal).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pygraphblas_tpu.core import mono as jmono
from pygraphblas_tpu_torch.core import mono as tmono

ARRAYS = ("q0", "dm", "qg", "xblk")
STATIC = ("S", "blk", "src_n", "src_rows", "max_w", "stream", "xb",
          "xblk_max", "ok", "wva")


def _sorted_with_invalid(idx, every):
    idx = np.array(idx)
    idx[::every] = -1
    return np.concatenate([np.sort(idx[idx >= 0]),
                           np.full((idx < 0).sum(), -1)])


def _idx_cases():
    """The index sets of tests/test_mono.py:9-90, plus a streamed one."""
    rng = np.random.RandomState(3)
    a = np.sort(rng.randint(0, 5000, 1000))
    a[::7] = -1
    rng = np.random.RandomState(4)
    b = np.sort(rng.randint(0, 3000, 2000))
    rng = np.random.RandomState(5)
    c = np.sort(rng.randint(0, 4000, 64 * 128))
    rng = np.random.RandomState(6)
    d = _sorted_with_invalid(rng.randint(0, 1000, 16 * 128), 9)
    rng = np.random.RandomState(7)
    e = _sorted_with_invalid(rng.randint(0, 9000, 64 * 128), 11)
    rng = np.random.RandomState(8)
    f = np.sort(rng.randint(0, 4 << 20, 30000))     # > _RESIDENT_BYTES
    return [("invalid", a, 5000), ("mul", b, 3000), ("fold8", c, 4000),
            ("min_tail", d, 1000), ("span", e, 9000), ("stream", f, 4 << 20)]


@pytest.mark.parametrize("case", [c[0] for c in _idx_cases()])
@pytest.mark.parametrize("span_max", [None, 0])
def test_monoplan_arrays_equal(case, span_max, monkeypatch):
    _, idx, src_n = next(c for c in _idx_cases() if c[0] == case)
    if span_max is not None:
        monkeypatch.setattr(jmono, "_SPAN_MAX_WVA", span_max)
        monkeypatch.setattr(tmono, "_SPAN_MAX_WVA", span_max)
    jp = jmono.MonoPlan.build(idx, src_n)
    tp = tmono.MonoPlan.build(idx, src_n)
    for k in STATIC:
        assert getattr(tp, k) == getattr(jp, k), k
    for k in ARRAYS:
        want = np.asarray(getattr(jp, k))
        got = getattr(tp, k)
        assert got.dtype == want.dtype, k
        assert np.array_equal(got, want), k
    if span_max == 0:
        assert tp.wva == 0
    # the torch copy keeps dtypes and values
    tt = tp.to("cpu")
    for k in ARRAYS:
        assert np.array_equal(getattr(tt, k).numpy(), getattr(tp, k))


def _span_inputs(dtype=np.float32):
    _, idx, src_n = _idx_cases()[4]
    rng = np.random.RandomState(17)
    if dtype == np.float32:
        src = rng.rand(src_n).astype(dtype)
    else:
        src = rng.randint(-1000, 1000, src_n).astype(dtype)
    plan_j = jmono.MonoPlan.build(idx, src_n)
    assert plan_j.wva > 0
    plan_t = tmono.MonoPlan.build(idx, src_n).to("cpu")
    vals = rng.randint(1, 5, plan_j.S * 128).astype(dtype)
    return plan_j, plan_t, src, vals


_J_FOLD = {"PLUS": lambda a, b: a + b, "MIN": jnp.minimum,
           "MAX": jnp.maximum, "TIMES": lambda a, b: a * b}
_J_MUL = {"TIMES": lambda a, b: a * b, "PLUS": lambda a, b: a + b,
          "MINUS": lambda a, b: a - b, "MAX": jnp.maximum}


@pytest.mark.parametrize("mode,dtype", [
    ("plain", np.float32), ("mul:TIMES", np.float32),
    ("mul:MINUS", np.float32), ("fold:PLUS", np.float32),
    ("fold:MIN", np.float32), ("plain", np.int32), ("mul:MAX", np.int32),
    ("fold:TIMES", np.int32),
])
def test_span_plain_matches_pallas_interpret(mode, dtype, monkeypatch):
    """Kernel 1's plain version == _mono_pallas_span in interpret mode."""
    plan_j, plan_t, src, vals = _span_inputs(dtype)
    kind, _, op = mode.partition(":")
    fill = np.dtype(dtype).type(0)
    if op in ("MIN",):
        fill = np.dtype(dtype).type(np.inf if dtype == np.float32
                                    else np.iinfo(dtype).max)
    if op == "TIMES" and kind == "fold":
        fill = np.dtype(dtype).type(1)
    jkw, tkw = {}, {}
    if kind == "mul":
        jkw = dict(vals=jnp.asarray(vals), mul=_J_MUL[op])
        tkw = dict(vals=torch.from_numpy(vals), mul=op)
    elif kind == "fold":
        jkw = dict(fold=_J_FOLD[op])
        tkw = dict(fold=op)
    monkeypatch.setattr(jmono, "_FORCE_INTERPRET", True)
    want = np.asarray(jmono.mono_gather(plan_j, jnp.asarray(src), fill,
                                        **jkw))
    got = tmono.mono_gather(plan_t, torch.from_numpy(src), fill, **tkw)
    assert got.numpy().dtype == want.dtype
    if kind == "fold" and dtype == np.float32:
        assert np.allclose(got.numpy(), want, rtol=1e-6)
    else:
        assert np.array_equal(got.numpy(), want)


def test_perrow_plain_matches_jax_plain(monkeypatch):
    """The plain version also covers per-row and streamed plans (the
    port runs them on CPU tensors only)."""
    for case, idx, src_n in (_idx_cases()[0], _idx_cases()[5]):
        monkeypatch.setattr(jmono, "_SPAN_MAX_WVA", 0)
        monkeypatch.setattr(tmono, "_SPAN_MAX_WVA", 0)
        src = np.random.RandomState(1).rand(src_n).astype(np.float32)
        pj = jmono.MonoPlan.build(idx, src_n)
        pt = tmono.MonoPlan.build(idx, src_n).to("cpu")
        want = np.asarray(jmono.mono_gather(pj, jnp.asarray(src), 0.0))
        got = tmono.mono_gather(pt, torch.from_numpy(src), 0.0).numpy()
        assert np.array_equal(got, want), case


def test_mono_span_wrapper_rejects_other_devices():
    _, plan_t, src, _ = _span_inputs()
    with pytest.raises(ValueError):
        tmono.mono_span(plan_t, torch.from_numpy(src).to("meta"), 0.0)


def _stream_case():
    """A streamed plan with ok == True: a source past _RESIDENT_BYTES
    (3M float32) and S = 192 rows in blocks of 64 whose windows fit two
    source blocks of xb rows."""
    rng = np.random.RandomState(21)
    idx = rng.randint(0, 1_500_000, 3 * 64 * 128)
    return _sorted_with_invalid(np.sort(idx), 13), 3_000_000


@pytest.mark.parametrize("route", ["resident", "streamed"])
@pytest.mark.parametrize("mode", ["plain", "mul:TIMES", "fold:PLUS",
                                  "fold:MAX"])
def test_rows_plain_matches_pallas_interpret(route, mode, monkeypatch):
    """Kernel 3 (_mono_pallas, per-row windows) in interpret mode against
    the port's mono_rows on CPU tensors (its plain version): resident
    per-row plans (span encoding off) and a streamed plan."""
    monkeypatch.setattr(jmono, "_SPAN_MAX_WVA", 0)
    monkeypatch.setattr(tmono, "_SPAN_MAX_WVA", 0)
    if route == "resident":
        _, idx, src_n = _idx_cases()[4]
    else:
        idx, src_n = _stream_case()
    plan_j = jmono.MonoPlan.build(idx, src_n)
    plan_t = tmono.MonoPlan.build(idx, src_n).to("cpu")
    assert plan_j.wva == 0 and plan_j.ok
    assert plan_j.stream == (route == "streamed") == plan_t.stream
    rng = np.random.RandomState(5)
    src = rng.rand(src_n).astype(np.float32)
    vals = rng.rand(plan_j.S * 128).astype(np.float32)
    kind, _, op = mode.partition(":")
    fill = np.float32(-np.inf if op == "MAX" else 0.0)
    jkw, tkw = {}, {}
    if kind == "mul":
        jkw = dict(vals=jnp.asarray(vals), mul=_J_MUL[op])
        tkw = dict(vals=torch.from_numpy(vals), mul=op)
    elif kind == "fold":
        jkw = dict(fold=_J_FOLD[op])
        tkw = dict(fold=op)
    monkeypatch.setattr(jmono, "_FORCE_INTERPRET", True)
    want = np.asarray(jmono.mono_gather(plan_j, jnp.asarray(src), fill,
                                        **jkw))
    got = tmono.mono_rows(plan_t, torch.from_numpy(src), fill, **tkw)
    if mode == "fold:PLUS":
        assert np.allclose(got.numpy(), want, rtol=1e-6)
    else:
        assert np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _cascade_plans(seed):
    """The same multi-level fold cascade (skewed degrees, as
    tests/test_mono.py:_cascade_case) built by both packages."""
    from pygraphblas_tpu.core.xspmv import XSpmvPlan as JPlan
    from pygraphblas_tpu_torch.core.xspmv import XSpmvPlan as TPlan

    rng = np.random.RandomState(seed)
    n, nnz = 3000, 30000
    rows = np.concatenate([rng.randint(0, 50, nnz // 2),
                           rng.randint(0, n, nnz - nnz // 2)])
    key = np.unique(rows * n + rng.randint(0, n, nnz))
    rows, cols = key // n, key % n
    vals = rng.rand(len(rows)).astype(np.float32)
    jp = JPlan._build(rows, cols, vals, n, n, np.dtype(np.float32))
    tp = TPlan._build(rows, cols, vals, n, n, np.dtype(np.float32))
    assert len(jp.levels) >= 2 and len(tp.levels) == len(jp.levels)
    return jp, tp.to("cpu")


@pytest.mark.parametrize("fold", ["PLUS", "MIN"])
def test_cascade_plain_matches_pallas_interpret(fold, monkeypatch):
    """Kernel 2 (mono_cascade) in interpret mode against the port's
    mono_cascade on CPU tensors (the chain of plain gathers)."""
    jp, tp = _cascade_plans(3 if fold == "PLUS" else 11)
    cur0 = np.random.RandomState(7).rand(jp.m1).astype(np.float32)
    fill = np.float32(0.0 if fold == "PLUS" else np.inf)
    monkeypatch.setattr(jmono, "_FORCE_INTERPRET", True)
    want = jmono.mono_cascade(jp.levels, jp.places[0], jnp.asarray(cur0),
                              fill, _J_FOLD[fold])
    got = tmono.mono_cascade(tp.levels, tp.places[0],
                             torch.from_numpy(cur0), fill, fold)
    assert want is not None and got is not None
    want = np.asarray(want)
    assert got.shape == want.shape
    if fold == "PLUS":
        assert np.allclose(got.numpy(), want, rtol=1e-6)
    else:
        assert np.array_equal(got.numpy(), want)


def test_cascade_dispatch_rules():
    """mono_cascade returns None exactly where the JAX package's does:
    no levels, 8-byte dtypes, per-row or streamed plans."""
    _, tp = _cascade_plans(3)
    x = torch.zeros(tp.m1)
    assert tmono.mono_cascade([], tp.places[0], x, 0.0, "PLUS") is None
    assert tmono.mono_cascade(tp.levels, tp.places[0], x.double(), 0.0,
                              "PLUS") is None
    _, idx, src_n = _idx_cases()[5]
    streamed = tmono.MonoPlan.build(idx, src_n).to("cpu")
    assert streamed.stream
    assert tmono.mono_cascade(tp.levels + [streamed], tp.places[0], x, 0.0,
                              "PLUS") is None
    assert tmono.mono_cascade(tp.levels, tp.places[0], x, 0.0,
                              "PLUS") is not None


def test_cascade_flags_epochs(monkeypatch):
    """The cascade kernel's flag buffer: one new epoch a call, never 0,
    and a fresh zeroed buffer (epochs from 1 again) when a call needs
    more tiles or the epoch would overflow int32."""
    monkeypatch.setattr(tmono, "_FLAGS", {})
    dev = torch.device("cpu")
    f1, e1 = tmono._cascade_flags(dev, 10)
    f2, e2 = tmono._cascade_flags(dev, 4096)
    assert (e1, e2) == (1, 2) and f2 is f1 and f1.dtype == torch.int32
    assert f1.numel() >= 4096 and not f1.any()
    f3, e3 = tmono._cascade_flags(dev, 5000)
    assert e3 == 1 and f3.numel() == 5000 and f3 is not f1
    tmono._FLAGS[dev][1] = (1 << 31) - 1
    f4, e4 = tmono._cascade_flags(dev, 10)
    assert e4 == 1 and f4 is not f3 and not f4.any()
