"""Port parity: pygraphblas_tpu_torch.core.mono against the JAX package.

MonoPlan arrays must equal exactly; the plain version of the span
kernel (what the port runs on CPU tensors) must equal the JAX Pallas
span kernel run in interpret mode: gathers and products exactly, PLUS
folds within rtol 1e-6 (the same s = 0..7 order, so in practice equal).
"""

import functools
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pygraphblas_tpu.core import mono as jmono
from pygraphblas_tpu_torch import _kernels
from pygraphblas_tpu_torch.core import mono as tmono
from pygraphblas_tpu_torch import types as gbtypes
from pygraphblas_tpu_torch.testing import (MONO_ROWS_CASES, cascade_runs_case,
                                           mono_rows_case)

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


@pytest.mark.parametrize("kind", list(MONO_ROWS_CASES))
@pytest.mark.parametrize("mode,dtype", [
    ("plain", np.float32), ("mul:TIMES", np.float32),
    ("fold:PLUS", np.float32), ("fold:MIN", np.int32)])
def test_rows_cases_plain_match_pallas_interpret(kind, mode, dtype,
                                                 monkeypatch):
    """mono_rows' hand-made index vectors (testing.mono_rows_case): each
    builds the plan its kind names (streamed or resident, int16 or int32
    dm; a row block straddling two source blocks; whole groups invalid;
    fewer groups than a block of the kernel), and the port's mono_rows
    on CPU tensors equals _mono_pallas in interpret mode."""
    monkeypatch.setattr(jmono, "_SPAN_MAX_WVA", 0)
    monkeypatch.setattr(tmono, "_SPAN_MAX_WVA", 0)
    idx, src_n = mono_rows_case(kind)
    plan_j = jmono.MonoPlan.build(idx, src_n)
    plan_t = tmono.MonoPlan.build(idx, src_n).to("cpu")
    want_plan = MONO_ROWS_CASES[kind]
    assert plan_j.wva == 0 and plan_j.ok
    assert plan_t.stream == plan_j.stream == want_plan["stream"]
    assert str(plan_t.dm.dtype) == "torch." + want_plan["dm"]
    dm = np.asarray(plan_j.dm)
    if kind == "stream_straddle":
        nb = plan_j.S // plan_j.blk
        q = (np.asarray(plan_j.q0, np.int64) + np.repeat(
            np.asarray(plan_j.xblk, np.int64) * plan_j.xb, plan_j.blk))
        lo = q.reshape(nb, plan_j.blk).min(1)
        hi = (q + dm.max(1) // 128 + 1).reshape(nb, plan_j.blk).max(1)
        assert ((lo // plan_j.xb) != (hi - 1) // plan_j.xb).any()
    if kind == "wide_rows":
        assert plan_j.max_w >= 8
    if kind == "empty_groups":
        assert (dm.reshape(-1, 8 * 128) < 0).all(1).sum() >= 5
    if kind == "few_groups":
        assert plan_j.S // 8 == 8
    rng = np.random.RandomState(len(kind))
    if dtype == np.float32:
        src = rng.rand(src_n).astype(dtype)
    else:
        src = rng.randint(-1000, 1000, src_n).astype(dtype)
    vals = rng.randint(1, 5, plan_j.S * 128).astype(dtype)
    kind_, _, op = mode.partition(":")
    fill = dtype(np.iinfo(dtype).max if op == "MIN" else 0)
    jkw, tkw = {}, {}
    if kind_ == "mul":
        jkw = dict(vals=jnp.asarray(vals), mul=_J_MUL[op])
        tkw = dict(vals=torch.from_numpy(vals), mul=op)
    elif kind_ == "fold":
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


# -- the cascade kernel's per-row tree fold ---------------------------------


def _emulate_cascade(runs, src, fold, fill):
    """Plain-torch model of csrc/cascade.cu's per-row tree fold, step by
    step (a test helper; the port's plain version is the chain): a run
    of 1..64 cells is folded by one thread, one of up to 1024 by a warp
    in 256-cell steps (a level-1 cell a lane, level-2 cells by lanes
    8q .. 8q + 7), a longer one by the block in 2048-cell rounds (8 warps'
    steps, then level-3 cells by 8 lanes), then level by level with one
    pending group a level, the last partial groups filled at the end."""
    f = getattr(gbtypes.from_torch_dtype(src.dtype), fold + "_MONOID").apply
    start = np.asarray(runs.start, np.int64)
    L = runs.levels
    n = np.diff(start)
    fl = torch.tensor(fill, dtype=src.dtype)
    out = torch.full((len(n),), fill, dtype=src.dtype)
    # the thread path, every short row at once
    rows = np.flatnonzero((n >= 1) & (n <= 64))
    st = torch.from_numpy(start[rows])
    nn = torch.from_numpy(n[rows])
    g = (nn + 7) // 8

    def cell(k):
        return torch.where(k < nn, src[(st + k).clamp(max=len(src) - 1)], fl)

    b = None
    for j in range(8):
        a = cell(torch.full_like(nn, 8 * j))
        for s in range(1, 8):
            a = f(a, cell(torch.full_like(nn, 8 * j + s)))
        if j == 0:
            b = a
        elif L >= 2:
            b = torch.where(j < g, f(b, a), f(b, fl))
    for _ in range(2, L):
        for _ in range(7):
            b = f(b, fl)
    out[torch.from_numpy(rows)] = b
    # the warp path, row by row: 256 cells a step, a level-1 cell a lane,
    # level-2 cells by lanes 8q .. 8q + 7, then one pending group a level
    for r in np.flatnonzero(n > 64):
        acc, cnt = [None] * L, [0] * L
        res = [fl]

        def feed(x, k):
            while k < L:
                acc[k] = x if cnt[k] == 0 else f(acc[k], x)
                cnt[k] += 1
                if cnt[k] < 8:
                    return
                x, cnt[k], k = acc[k], 0, k + 1
            res[0] = x

        def level2(c0):
            # a step's level-2 cells: a level-1 cell a lane, then 8 lanes
            m = min(256, int(n[r]) - c0)
            n1 = -(-m // 8)
            v = torch.full((256,), fill, dtype=src.dtype)
            v[:m] = src[start[r] + c0:start[r] + c0 + m]
            v = v.reshape(32, 8)
            a1 = v[:, 0]
            for s in range(1, 8):
                a1 = f(a1, v[:, s])
            a1 = torch.where(torch.arange(32) < n1, a1, fl)
            out2 = []
            for q in range(-(-n1 // 8)):
                c2 = a1[8 * q]
                for s in range(1, 8):
                    c2 = f(c2, a1[8 * q + s] if 8 * q + s < n1 else fl)
                out2.append(c2)
            return out2

        if n[r] <= 1024:        # a warp: level-2 cells onward one by one
            for c0 in range(0, int(n[r]), 256):
                for c2 in level2(c0):
                    feed(c2, 2)
        else:                   # the block: 2048 cells a round
            for c0 in range(0, int(n[r]), 2048):
                l2 = [c for w in range(8) if c0 + 256 * w < n[r]
                      for c in level2(c0 + 256 * w)]
                for q in range(-(-len(l2) // 8)):
                    c3 = l2[8 * q]
                    for s in range(1, 8):
                        c3 = f(c3, l2[8 * q + s] if 8 * q + s < len(l2)
                               else fl)
                    feed(c3, 3)
        for k in range(2, L):
            if cnt[k]:
                a = acc[k]
                for _ in range(cnt[k], 8):
                    a = f(a, fl)
                cnt[k] = 0
                feed(a, k + 1)
        out[r] = res[0]
    return out


def _chain(levels, place, src, fold, fill):
    cur = src
    for lp in levels:
        cur = tmono.mono_gather_plain(lp, cur.reshape(-1), fill,
                                      fold=fold).reshape(-1)
    return tmono.mono_gather_plain(place, cur, fill).reshape(-1)


def _runs_case():
    nrows, present, counts = cascade_runs_case()
    return tmono.fold_plans(counts, nrows, present)


_FOLD_FILLS = {("PLUS", torch.float32): 0.0, ("MIN", torch.float32): np.inf,
               ("MAX", torch.float32): -np.inf, ("PLUS", torch.int32): 0,
               ("MIN", torch.int32): np.iinfo(np.int32).max,
               ("MAX", torch.int32): np.iinfo(np.int32).min}


def _source(n, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, n,
                                            dtype=np.int64).astype(np.int32))
    v = rng.randn(n).astype(np.float32)
    v[::5] = -0.0                      # PLUS folds turn -0.0 into +0.0
    return torch.from_numpy(v)


# PLUS with a fill that is not its identity counts every empty slot the
# chain folds (an identity fill folded twice gives what it gives once)
_ODD_FILLS = [("PLUS", torch.float32, 0.25), ("PLUS", torch.int32, 3)]


@pytest.mark.parametrize("case", ["xspmv", "runs"])
@pytest.mark.parametrize("fold,dtype,fill", [
    k + (v,) for k, v in _FOLD_FILLS.items()] + _ODD_FILLS)
def test_cascade_tree_fold_matches_chain(case, fold, dtype, fill):
    """The kernel's per-row tree fold, on the table fold_plans attaches,
    equals the chain of plain gathers bit for bit: xspmv's skewed plans
    (every run at most 64 cells) and hand-made runs of every length
    class; float32 sources hold -0.0."""
    if case == "xspmv":
        _, tp = _cascade_plans(3)
        levels, place = tp.levels, tp.places[0]
    else:
        levels, place = _runs_case()
        levels = [lp.to("cpu") for lp in levels]
        place = place.to("cpu")
    runs = place.cascade
    assert runs is not None and runs.levels == len(levels)
    src = _source(runs.cells, dtype, 5)
    want = _chain(levels, place, src, fold, fill)
    got = _emulate_cascade(runs, src, fold, fill)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.numpy().view(np.uint32))


def test_cascade_table():
    """The table fold_plans attaches: one run a placed cell, the counts
    at the present rows and empty runs elsewhere, one after another
    from cell 0; xspmv's plans carry it."""
    nrows, present, counts = cascade_runs_case()
    levels, place = tmono.fold_plans(counts, nrows, present)
    runs = place.cascade
    n = np.diff(runs.start)
    assert len(n) == place.S * 128
    assert runs.start[0] == 0 and runs.start[-1] == runs.cells
    assert np.array_equal(n[present], counts) and n.sum() == counts.sum()
    assert sorted(n[n > 64]) == [65, 600, 1024, 1025, 2100, 4096, 5000]
    assert runs.levels == len(levels) == 5
    assert runs.cells == levels[0].src_n
    _, tp = _cascade_plans(3)
    assert tp.places[0].cascade.cells == tp.levels[0].src_n
    assert tp.places[0].cascade.levels == len(tp.levels)


def test_cascade_table_in_plan_cache():
    """The table goes through the plan cache's format (state, npz,
    from_state) unchanged, and no level carries one."""
    import io

    from pygraphblas_tpu_torch.core import xspmv as tx

    _, tp = _cascade_plans(3)
    buf = io.BytesIO()
    np.savez(buf, **tx._flatten(tp.state()))
    buf.seek(0)
    back = tx.XSpmvPlan.from_state(tx._unflatten(np.load(buf)))
    a, b = tp.places[0].cascade, back.places[0].cascade
    assert (b.levels, b.cells) == (a.levels, a.cells)
    assert np.array_equal(np.asarray(b.start), np.asarray(a.start))
    assert all(lp.cascade is None for lp in back.levels)


@pytest.mark.parametrize("fault", ["empty_run", "present_order", "lengths"])
def test_fold_plans_rejects_bad_runs(fault):
    """Runs that are not xspmv's shape (a present row with no cell, rows
    out of order, or as many runs as rows not given) make fold_plans
    raise rather than build a table another fold would read."""
    rng = np.random.RandomState(2)
    counts = rng.randint(1, 30, 200)
    nrows = 250
    present = np.sort(rng.choice(nrows, len(counts), replace=False))
    tmono.fold_plans(counts, nrows, present)      # the good runs build
    if fault == "empty_run":
        counts[7] = 0
    elif fault == "present_order":
        present[[3, 4]] = present[[4, 3]]
    else:
        present = present[:-1]
    with pytest.raises(ValueError):
        tmono.fold_plans(counts, nrows, present)


def _fake(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("device,dtype,ok,wva,route", [
    ("cuda", torch.float32, True, 3, "mono_span"),
    ("cuda", torch.int32, True, 0, "mono_rows"),
    ("cuda", torch.float32, False, 0, None),
    ("cuda", torch.float64, True, 3, None),
    ("cuda", torch.int64, True, 0, None),
    ("cuda", torch.int16, True, 3, "mono_span"),
    ("cpu", torch.float32, True, 3, None),
])
def test_gather_dispatch_rule(device, dtype, ok, wva, route):
    """mono_gather's route reads plan.ok, plan.wva, the device and the
    dtype's size alone: on the card, ok == False and 8-byte values take
    the plain version, as the JAX package's XLA gather takes them
    (a 2-byte dtype reaches the kernel wrapper, which raises TypeError);
    the perm, span and row wrappers launch exactly where on_card."""
    plan = types.SimpleNamespace(ok=ok, wva=wva)
    assert tmono.gather_route(plan, _fake(device, dtype)) == route
    on = _kernels.on_card(_fake(device, dtype), "x")
    assert on == (device == "cuda" and dtype.itemsize <= 4)
    with pytest.raises(ValueError):
        _kernels.on_card(_fake("meta", dtype), "x")
