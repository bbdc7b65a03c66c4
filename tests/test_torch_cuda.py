"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import).  Run on a machine with one:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pygraphblas_tpu_torch import (_kernels, algorithms, fused, generators,
                                   options_set, types)
from pygraphblas_tpu_torch.core import (esc, gustavson, mono, perm, scan,
                                        spgemm, xspmv)
from pygraphblas_tpu_torch.testing import (MONO_ROWS_CASES, PAIR_COUNT_CASES,
                                           cascade_runs_case, mono_rows_case,
                                           pair_count_case, pair_fold_case,
                                           PAIR_FOLD_CODES, POW_EXTREME_CODES,
                                           SEGFOLD_CODES,
                                           typed_plains, typed_values,
                                           typed_wrappers, wrapper_cases)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _span_plan(card):
    rng = np.random.RandomState(7)
    idx = np.sort(rng.randint(0, 9000, 64 * 128))
    idx[::11] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    return mono.MonoPlan.build(idx, 9000).to(card), rng


@pytest.mark.parametrize("kw", [{}, {"fold": "PLUS"}, {"fold": "MIN"},
                                {"mul": "TIMES"}, {"mul": "RDIV"}])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mono_span_kernel(card, kw, dtype):
    plan, rng = _span_plan(card)
    src = torch.from_numpy(rng.randint(1, 99, 9000)).to(card, dtype)
    kw = dict(kw)
    if "mul" in kw:
        kw["vals"] = torch.from_numpy(
            rng.randint(1, 9, plan.S * 128)).to(card, dtype)
    fill = 0 if kw.get("fold") != "MIN" else (
        np.inf if dtype == torch.float32 else np.iinfo(np.int32).max)
    got = mono.mono_span(plan, src, fill, **kw)
    want = mono.mono_gather_plain(plan, src, fill, **kw)
    assert torch.equal(got, want)


def test_mono_span_rejects_int64(card):
    """int64 values take the plain version on the card (the JAX
    package's XLA rule), with no launch; a 2-byte dtype is widened to
    4-byte words and launches the kernel (as the TPU takes it)."""
    plan, rng = _span_plan(card)
    src = torch.from_numpy(rng.randint(-2 ** 40, 2 ** 40, 9000)).to(card)
    _kernels.reset_launches()
    got = mono.mono_span(plan, src, 0, fold="MAX")
    assert torch.equal(got, mono.mono_gather_plain(plan, src, 0, fold="MAX"))
    assert sum(_kernels.launches.values()) == 0
    small = src.to(torch.int16)
    got = mono.mono_span(plan, small, 0, fold="MAX")
    assert got.dtype == torch.int16 and _kernels.launches["mono_span"] == 1
    assert torch.equal(got, mono.mono_gather_plain(plan, small, 0,
                                                   fold="MAX"))


def test_mono_gather_plan_not_ok(card):
    """A streamed plan whose window span passes _MAX_XB rows (ok ==
    False) gives mono_gather_plain's answer on the card, no launch."""
    rng = np.random.RandomState(13)
    src_n = 4_000_000
    idx = np.sort(rng.randint(0, src_n, 64 * 128))
    plan = mono.MonoPlan.build(idx, src_n).to(card)
    assert plan.stream and not plan.ok
    src = torch.from_numpy(rng.rand(src_n).astype(np.float32)).to(card)
    for kw in ({}, {"fold": "PLUS"}):
        _kernels.reset_launches()
        got = mono.mono_gather(plan, src, 0.0, **kw)
        torch.cuda.synchronize()
        assert sum(_kernels.launches.values()) == 0
        assert torch.equal(got, mono.mono_gather_plain(plan, src, 0.0, **kw))


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_wide_values_take_the_plain_versions(card, dtype):
    """8-byte values into every gather and permutation wrapper: the plain
    version's answer on the card and no launch, as the JAX package sends
    them to XLA."""
    rng = np.random.RandomState(4)

    def vals(*shape):
        return torch.from_numpy(rng.randint(-2 ** 40, 2 ** 40, shape)).to(
            card, dtype)

    def lanes(*shape):
        return torch.from_numpy(rng.randint(0, 128, shape)
                                .astype(np.int8)).to(card)

    plan, _ = _span_plan(card)
    src = vals(9000)
    g, S = 2, 3
    r_l = S * 128
    x = vals(g * r_l, 128)
    ix = [lanes(g * r_l, 128) for _ in range(4)]
    ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                            .astype(np.int8)).to(card)
    x3 = x.reshape(g * 128, S, 128)
    inner = (ix[0], ix[1], ssel, ix[2], ix[3], g, S)
    cases = [
        (lambda: mono.mono_gather(plan, src, 0, fold="PLUS"),
         lambda: mono.mono_gather_plain(plan, src, 0, fold="PLUS")),
        (lambda: mono.mono_span(plan, src, 0),
         lambda: mono.mono_gather_plain(plan, src, 0)),
        (lambda: perm._lane_gather(x, ix[0]),
         lambda: perm._lane_gather_plain(x, ix[0])),
        (lambda: perm._lane_gather_tdesc(x, ix[0], g, r_l),
         lambda: perm._tdesc_plain(x, ix[0], g, r_l)),
        (lambda: perm._lane_gather_tasc(x, ix[1], g, r_l, "PLUS"),
         lambda: perm._tasc_plain(x, ix[1], g, r_l, "PLUS")),
        (lambda: perm._lane_gather_tasc(x, ix[1], g, r_l),
         lambda: perm._tasc_plain(x, ix[1], g, r_l)),
        (lambda: perm._inner3(x, *inner),
         lambda: perm._inner3_plain(x, *inner)),
        (lambda: perm._mid_pass(x3, ix[2], ssel, ix[3]),
         lambda: perm._mid_pass_plain(x3, ix[2], ssel, ix[3])),
    ]
    old = mono._SPAN_MAX_WVA
    mono._SPAN_MAX_WVA = 0
    try:
        rows = mono.MonoPlan.build(np.sort(rng.randint(0, 9000, 64 * 128)),
                                   9000).to(card)
    finally:
        mono._SPAN_MAX_WVA = old
    assert rows.wva == 0
    cases.append((lambda: mono.mono_rows(rows, src, 0, fold="MIN"),
                  lambda: mono.mono_gather_plain(rows, src, 0, fold="MIN")))
    for kfn, pfn in cases:
        _kernels.reset_launches()
        got = kfn()
        torch.cuda.synchronize()
        assert sum(_kernels.launches.values()) == 0
        assert got.dtype == dtype and torch.equal(got, pfn())


@pytest.mark.parametrize("g,rb", [(1, 1), (3, 1), (1, 5), (2, 3)])
@pytest.mark.parametrize("fold", [None, "PLUS", "MIN", "MAX", "TIMES"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_tasc_kernel(card, g, rb, fold, dtype):
    """The banded ascend, bit-exact: one tile (rb = 1), g > 1 groups,
    several tiles a group, every fold op and none, both dtypes; rows
    0..7 of each tile's idx hold 128 values equal mod 32 (4 distinct
    source rows of one bank class), the rest random."""
    rng = np.random.RandomState(g * 10 + rb)
    r_l = rb * 128
    if dtype == torch.float32:
        x = rng.randn(g * r_l, 128).astype(np.float32)
    else:
        x = rng.randint(-2 ** 31, 2 ** 31 - 1, (g * r_l, 128),
                        dtype=np.int64).astype(np.int32)
    idx = rng.randint(0, 128, (g * rb, 128, 128)).astype(np.int8)
    idx[:, :8, :] = (5 + 32 * rng.randint(0, 4, (g * rb, 8, 128))).astype(
        np.int8)
    x = torch.from_numpy(x).to(card)
    idx = torch.from_numpy(idx.reshape(g * r_l, 128)).to(card)
    _kernels.reset_launches()
    got = perm._lane_gather_tasc(x, idx, g, r_l, fold)
    torch.cuda.synchronize()
    assert _kernels.launches["lane_gather_tasc"] == 1
    want = perm._tasc_plain(x, idx, g, r_l, fold)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_perm_kernels(card):
    rng = np.random.RandomState(3)
    for g, S in ((2, 1), (3, 3), (2, 9)):
        r_l = S * 128
        x = torch.from_numpy(rng.rand(g * r_l, 128).astype(np.float32)).to(
            card)
        ix = [torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                               .astype(np.int8)).to(card) for _ in range(4)]
        ssel = (torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                                 .astype(np.int8)).to(card)
                if S > 1 else None)
        assert torch.equal(perm._lane_gather_tdesc(x, ix[0], g, r_l),
                           perm._tdesc_plain(x, ix[0], g, r_l))
        for fold in (None, "PLUS", "MAX"):
            assert torch.equal(
                perm._lane_gather_tasc(x, ix[1], g, r_l, fold),
                perm._tasc_plain(x, ix[1], g, r_l, fold))
        args = (ix[0], ix[1], ssel, ix[2], ix[3], g, S)
        assert torch.equal(perm._inner3(x, *args),
                           perm._inner3_plain(x, *args))


@pytest.mark.parametrize("S", [1, 2, 3, 9, 16, 18, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_inner3_kernel(card, S, dtype):
    """The fused middle (one 8-block cluster a group, the slab in
    distributed shared memory) bit-exact for random index slabs."""
    rng = np.random.RandomState(S)
    g, r_l = 3, S * 128
    x = (rng.rand(g * r_l, 128).astype(np.float32) if dtype == torch.float32
         else rng.randint(-2 ** 31, 2 ** 31 - 1, (g * r_l, 128),
                          dtype=np.int64).astype(np.int32))
    x = torch.from_numpy(x).to(card)
    ix = [torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                           .astype(np.int8)).to(card) for _ in range(4)]
    ssel = (torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                             .astype(np.int8)).to(card) if S > 1 else None)
    args = (ix[0], ix[1], ssel, ix[2], ix[3], g, S)
    _kernels.reset_launches()
    got = perm._inner3(x, *args)
    torch.cuda.synchronize()
    assert _kernels.launches["inner3"] == 1
    assert torch.equal(got, perm._inner3_plain(x, *args))


def test_pagerank_goes_through_the_kernels(card):
    # kron-19 is the smallest kron graph whose permutation takes the
    # fused kernels (D = 3, K = 128 after the n_perm pad)
    rows, cols, n = generators.rmat_edges(19, 16)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    ref = fused.pagerank(A, itermax=10, tol=-1.0, device="cpu")
    _kernels.reset_launches()
    got = fused.pagerank(A, itermax=10, tol=-1.0)
    torch.cuda.synchronize()
    # the kron-19 path: span gathers, descend, fused middle, fold8
    # ascend and the cascade (no per-row plan, no _mid_pass)
    path = ("mono_span", "mono_cascade", "lane_gather_tdesc", "inner3",
            "lane_gather_tasc")
    assert all(_kernels.launches[k] > 0 for k in path)
    assert all(c == 0 for k, c in _kernels.launches.items()
               if k not in path)
    err = (got._vals.cpu() - ref._vals).abs().max()
    assert err <= 1e-5 * ref._vals.abs().max()


@pytest.mark.parametrize("kw", [{}, {"fold": "PLUS"}, {"fold": "MAX"},
                                {"mul": "TIMES"}])
@pytest.mark.parametrize("route", ["resident16", "resident32", "streamed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mono_rows_kernel(card, kw, route, dtype, monkeypatch):
    monkeypatch.setattr(mono, "_SPAN_MAX_WVA", 0)
    rng = np.random.RandomState(11)
    if route == "streamed":
        src_n = 3_000_000
        idx = np.sort(rng.randint(0, 1_500_000, 3 * 64 * 128))
    else:
        src_n = 9000 if route == "resident16" else 2_500_000
        idx = np.sort(rng.randint(0, src_n, 64 * 128))
    idx[::7] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    plan = mono.MonoPlan.build(idx, src_n).to(card)
    assert plan.wva == 0 and plan.ok
    assert plan.stream == (route == "streamed")
    assert plan.dm.dtype == (torch.int32 if route == "resident32"
                             else torch.int16)
    src = torch.from_numpy(rng.randint(-99, 99, src_n)).to(card, dtype)
    kw = dict(kw)
    if "mul" in kw:
        kw["vals"] = torch.from_numpy(
            rng.randint(1, 9, plan.S * 128)).to(card, dtype)
    fill = -99 if kw.get("fold") == "MAX" else 0
    _kernels.reset_launches()
    got = mono.mono_gather(plan, src, fill, **kw)
    assert _kernels.launches["mono_rows"] == 1
    want = mono.mono_gather_plain(plan, src, fill, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", list(MONO_ROWS_CASES))
@pytest.mark.parametrize("kw", [{}, {"fold": "PLUS"}, {"fold": "MIN"},
                                {"fold": "MAX"}, {"mul": "TIMES"},
                                {"mul": "PLUS", "fold": "MIN"}])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mono_rows_kernel_cases(card, kind, kw, dtype, monkeypatch):
    """mono_rows on testing.mono_rows_case's plans (streamed blocks that
    straddle two source blocks, int32 dm streamed and resident, rows
    over several windows, invalid groups, fewer groups than a block):
    one launch, equal to the plain version."""
    monkeypatch.setattr(mono, "_SPAN_MAX_WVA", 0)
    idx, src_n = mono_rows_case(kind)
    plan = mono.MonoPlan.build(idx, src_n).to(card)
    assert plan.wva == 0 and plan.ok
    assert plan.stream == MONO_ROWS_CASES[kind]["stream"]
    rng = np.random.RandomState(len(kind))
    src = torch.from_numpy(rng.randint(-99, 99, src_n)).to(card, dtype)
    kw = dict(kw)
    if "mul" in kw:
        kw["vals"] = torch.from_numpy(
            rng.randint(1, 9, plan.S * 128)).to(card, dtype)
    fill = {"MIN": 999, "MAX": -99}.get(kw.get("fold"), 0)
    _kernels.reset_launches()
    got = mono.mono_gather(plan, src, fill, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["mono_rows"] == 1
    assert torch.equal(got, mono.mono_gather_plain(plan, src, fill, **kw))


def _cascade_plan(card, seed=3):
    rng = np.random.RandomState(seed)
    n, nnz = 3000, 30000
    rows = np.concatenate([rng.randint(0, 50, nnz // 2),
                           rng.randint(0, n, nnz - nnz // 2)])
    key = np.unique(rows * n + rng.randint(0, n, nnz))
    rows, cols = key // n, key % n
    plan = xspmv.XSpmvPlan._build(rows, cols, np.ones(len(rows)), n, n,
                                  np.dtype(np.float32)).to(card)
    assert len(plan.levels) >= 2
    return plan, rng


@pytest.mark.parametrize("fold", ["PLUS", "MIN", "MAX"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mono_cascade_kernel(card, fold, dtype):
    plan, rng = _cascade_plan(card)
    cur = torch.from_numpy(rng.randint(-999, 999, plan.m1)).to(card, dtype)
    fill = 0 if fold == "PLUS" else (
        np.iinfo(np.int32).max if fold == "MIN" else np.iinfo(np.int32).min)
    if dtype == torch.float32 and fold != "PLUS":
        fill = np.inf if fold == "MIN" else -np.inf
    _kernels.reset_launches()
    got = mono.mono_cascade(plan.levels, plan.places[0], cur, fill, fold)
    assert _kernels.launches["mono_cascade"] == 1
    assert _kernels.launches["mono_span"] == 0
    want = cur
    for lp in plan.levels:
        want = mono.mono_gather_plain(lp, want.reshape(-1), fill,
                                      fold=fold).reshape(-1)
    want = mono.mono_gather_plain(plan.places[0], want, fill)
    assert torch.equal(got, want)


def test_mono_cascade_kernel_repeated(card):
    """Calls after calls on two plans (kron-14's runs reach past a
    block's staged cells): each equals the chain."""
    small, rng = _cascade_plan(card)
    rows, cols, n = generators.rmat_edges(14, 16)
    big = generators.to_matrix(rows, cols, n, types.FP32)._xspmv_plan(
        True, np.float32, device=card)
    for _ in range(3):
        for plan in (small, big):
            cur = torch.from_numpy(rng.rand(plan.m1).astype(np.float32)).to(
                card)
            got = mono.mono_cascade(plan.levels, plan.places[0], cur, 0.0,
                                    "PLUS")
            want = cur
            for lp in plan.levels:
                want = mono.mono_gather_plain(lp, want.reshape(-1), 0.0,
                                              fold="PLUS").reshape(-1)
            want = mono.mono_gather_plain(plan.places[0], want, 0.0)
            assert torch.equal(got, want)


@pytest.mark.parametrize("fold,fill", [("PLUS", 0), ("MIN", "max"),
                                       ("MAX", "min"), ("PLUS", 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mono_cascade_kernel_run_lengths(card, fold, fill, dtype):
    """Runs of every length class of the kernel (1 .. 64 cells by a
    thread, 65 .. 1024 by a warp, 1025 .. 5000 by the block, past its
    staged cells) against the chain, bit for bit; PLUS with a
    fill that is not its identity counts every empty slot folded;
    float32 PLUS sources hold -0.0."""
    nrows, present, counts = cascade_runs_case()
    levels, place = mono.fold_plans(counts, nrows, present)
    levels = [lp.to(card) for lp in levels]
    place = place.to(card)
    rng = np.random.RandomState(6)
    m = int(counts.sum())
    if dtype == torch.float32:
        v = rng.randn(m).astype(np.float32)
        if fold == "PLUS":
            v[::5] = -0.0
        big = np.inf
    else:
        v = rng.randint(-2 ** 31, 2 ** 31 - 1, m, dtype=np.int64).astype(
            np.int32)
        big = np.iinfo(np.int32).max
    fill = {"max": big, "min": -big if dtype == torch.float32
            else np.iinfo(np.int32).min}.get(fill, fill)
    cur = torch.from_numpy(v).to(card)
    _kernels.reset_launches()
    got = mono.mono_cascade(levels, place, cur, fill, fold)
    torch.cuda.synchronize()
    assert _kernels.launches["mono_cascade"] == 1
    want = cur
    for lp in levels:
        want = mono.mono_gather_plain(lp, want.reshape(-1), fill,
                                      fold=fold).reshape(-1)
    want = mono.mono_gather_plain(place, want, fill)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_mono_cascade_needs_the_table(card):
    """A placement plan with no row table (not made by fold_plans), or
    one whose table is for other levels, raises rather than folding
    another way."""
    nrows, present, counts = cascade_runs_case()
    levels, place = mono.fold_plans(counts, nrows, present)
    levels = [lp.to(card) for lp in levels]
    cur = torch.zeros(int(counts.sum()), device=card)
    pos = np.full(nrows, -1, np.int64)
    pos[present] = np.arange(len(present))
    bare = mono.MonoPlan.build(pos, len(present))
    with pytest.raises(ValueError):
        mono.mono_cascade(levels, bare.to(card), cur, 0.0, "PLUS")
    with pytest.raises(ValueError):
        mono.mono_cascade(levels[1:], place.to(card), cur, 0.0, "PLUS")


@pytest.mark.parametrize("S", [1, 3, 124])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mid_pass_and_lane_gather_kernels(card, S, dtype):
    rng = np.random.RandomState(S)
    nsub = 3 if S == 124 else 50
    x = torch.from_numpy(rng.randint(-999, 999, (nsub, S, 128))).to(
        card, dtype)
    a, c = (torch.from_numpy(rng.randint(0, 128, (nsub * S, 128))
                             .astype(np.int8)).to(card) for _ in range(2))
    ssel = (torch.from_numpy(rng.randint(0, S, (nsub, S, 128))
                             .astype(np.int8)).to(card) if S > 1 else None)
    _kernels.reset_launches()
    got = perm._mid_pass(x, a, ssel, c)
    assert _kernels.launches["mid_pass"] == 1
    assert torch.equal(got, perm._mid_pass_plain(x, a, ssel, c))
    x2 = x.reshape(-1, 128)
    got = perm._lane_gather(x2, a)
    assert _kernels.launches["lane_gather"] == 1
    assert torch.equal(got, perm._lane_gather_plain(x2, a))


@pytest.mark.parametrize("S,nsubs", [(1, (53, 40000)), (2, (53, 20000)),
                                     (3, (53, 16384)), (24, (53, 2000)),
                                     (124, (3, 300)), (128, (3, 300))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_mid_pass_kernel(card, S, nsubs, dtype):
    """The persistent ring: chunk counts that are not a multiple of the
    tiles a stage holds (1024 // (S * 128), at least 1) and chunks past
    one a block; selects out of [0, S) give 0: bit-exact, one launch."""
    rng = np.random.RandomState(S)
    for nsub in nsubs:
        x = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                         (nsub, S, 128), dtype=np.int64)
                             .astype(np.int32)).to(card)
        if dtype == torch.float32:
            x = torch.randn((nsub, S, 128), device=card)
        a, c = (torch.from_numpy(rng.randint(0, 128, (nsub * S, 128))
                                 .astype(np.int8)).to(card)
                for _ in range(2))
        ssel = (torch.from_numpy(rng.randint(-3, S + 3, (nsub, S, 128))
                                 .astype(np.int8)).to(card)
                if S > 1 else None)
        _kernels.reset_launches()
        got = perm._mid_pass(x, a, ssel, c)
        torch.cuda.synchronize()
        assert _kernels.launches["mid_pass"] == 1
        assert torch.equal(got, perm._mid_pass_plain(x, a, ssel, c))


def test_mid_pass_rejects_misaligned(card):
    x = torch.zeros(3 * 128 * 2 + 1, device=card)[1:].reshape(2, 3, 128)
    a = torch.zeros((6, 128), dtype=torch.int8, device=card)
    ssel = torch.zeros((2, 3, 128), dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        perm._mid_pass(x, a, ssel, a)


def _kron12(sym):
    rows, cols, n = generators.rmat_edges(12, 16)
    if sym:
        r = np.concatenate([rows, cols])
        c = np.concatenate([cols, rows])
        keep = r != c
        key = np.unique(r[keep] * n + c[keep])
        rows, cols = key // n, key % n
    return rows, cols, n


@pytest.mark.parametrize("sym", [False, True])
def test_xspmv_launches_on_kron12(card, sym):
    """One xspmv on kron-12 A^T (D=2, S=5, K=106) and kron-12
    symmetrised (D=2, S=7, K=128): 2 span gathers, 1 descend, the
    mid pass, 1 ascend, 1 cascade, and the JAX package's values."""
    rows, cols, n = _kron12(sym)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    plan = A._xspmv_plan(True, np.float32, device=card)
    assert (plan.perm.D, plan.perm.S) == ((2, 7) if sym else (2, 5))
    x = torch.from_numpy(np.random.RandomState(1).rand(n)
                         .astype(np.float32)).to(card)
    sem = types.FP32.PLUS_TIMES
    _kernels.reset_launches()
    y, _ = xspmv.xspmv(plan, x, sem, np.float32)
    torch.cuda.synchronize()
    assert _kernels.launches == dict(
        _kernels.launches, mono_span=2, mono_cascade=1, lane_gather_tdesc=1,
        mid_pass=1, lane_gather_tasc=1, mono_rows=0, inner3=0,
        lane_gather=0)
    cplan = A._xspmv_plan(True, np.float32, device="cpu")
    want, _ = xspmv.xspmv(cplan, x.cpu(), sem, np.float32)
    assert torch.allclose(y.cpu(), want, rtol=1e-6)


def test_bfs_sssp_bc_on_card(card):
    rows, cols, n = _kron12(False)
    A = generators.to_matrix(rows, cols, n, types.BOOL)
    _kernels.reset_launches()
    lv = fused.bfs_level(A, 0)
    assert _kernels.launches["mid_pass"] > 0
    assert _kernels.launches["mono_cascade"] > 0
    assert np.array_equal(lv.to_numpy(),
                          fused.bfs_level(A, 0, device="cpu").to_numpy())
    batch = fused.bfs_batch(A, [0, 5])
    assert torch.equal(batch[0].cpu(), lv._vals.cpu().to(torch.int32))
    w = np.random.RandomState(1).randint(1, 256, len(rows)).astype(
        np.float32)
    Aw = generators.to_matrix(rows, cols, n, types.FP32, vals=w)
    d = fused.sssp(Aw, 0)
    assert np.array_equal(d.to_numpy(),
                          fused.sssp(Aw, 0, device="cpu").to_numpy())
    rs, cs, _ = _kron12(True)
    As = generators.to_matrix(rs, cs, n, types.FP32)
    got = fused.bc(As, [0, 1, 2, 3]).to_numpy()
    want = fused.bc(As, [0, 1, 2, 3], device="cpu").to_numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _intersect_inputs(card, W, seed, vdt=None):
    """512 mask edges over two sorted lists of unique ids; B windows near
    A's so that they meet.  Edge 0 has wa = 0, edge 1 wb = 0, edge 2
    fills the width from both lists, edge 3 from A alone."""
    rng = np.random.RandomState(seed)
    nnz, E = 1 << 16, 512
    a, b = (np.sort(rng.choice(3 * nnz, nnz, replace=False)).astype(np.int32)
            for _ in range(2))
    ast = rng.randint(0, nnz - W, E)
    bst = np.clip(ast + rng.randint(-200, 200, E), 0, nnz - W)
    wa = rng.randint(0, W // 2 + 1, E)
    wb = np.minimum(rng.randint(0, W, E), W - wa)
    wa[0], wb[1] = 0, 0
    wa[2], wb[2] = W // 2, W - W // 2
    wa[3], wb[3] = W, 0
    arrs = [a, b] + [x.astype(np.int32) for x in (ast, wa, bst, wb)]
    if vdt is not None:
        # float values in [0.5, 4.5): no zero divisor for RDIV
        arrs += [(rng.rand(nnz) * 4 + 0.5).astype(vdt) if vdt == np.float32
                 else rng.randint(-9, 10, nnz).astype(vdt)
                 for _ in range(2)]
    return [torch.from_numpy(x).to(card) for x in arrs]


@pytest.mark.parametrize("W", [128, 4096])
def test_pair_count_and_fill_keys_kernels(card, W):
    a, b, ast, wa, bst, wb = _intersect_inputs(card, W, W)
    _kernels.reset_launches()
    got = spgemm.pair_count(a, b, ast, wa, bst, wb, W)
    keys = spgemm.fill_keys(a, b, ast, wa, bst, wb, W)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_count"] == 1
    assert _kernels.launches["fill_keys"] == 1
    want = spgemm._pair_count_plain(a, b, ast, wa, bst, wb, W)
    assert torch.equal(got, want) and int(want.max()) > 0
    assert torch.equal(keys,
                       spgemm._fill_plain(a, b, ast, wa, bst, wb, W))


@pytest.mark.parametrize("kind", PAIR_COUNT_CASES)
def test_pair_count_kernel_cases(card, kind):
    """pair_count's runs: across blocks, of one edge, alternating, a
    32768-id longer list, ids past one bitmap window, B lists over 8x
    a shared A list, empty lists, the longer list on B's side, no common
    id."""
    *arrs, W = pair_count_case(kind)
    a, b, ast, wa, bst, wb = (torch.from_numpy(x).to(card) for x in arrs)
    _kernels.reset_launches()
    got = spgemm.pair_count(a, b, ast, wa, bst, wb, W)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_count"] == 1
    want = spgemm._pair_count_plain(a, b, ast, wa, bst, wb, W)
    assert torch.equal(got, want)
    assert (int(want.max()) == 0) == (kind == "disjoint")


@pytest.mark.parametrize("add,mul,vdt", [("PLUS", "TIMES", np.float32),
                                         ("MIN", "PLUS", np.int32),
                                         ("PLUS", "MINUS", np.int32),
                                         ("MAX", "RDIV", np.float32)])
@pytest.mark.parametrize("W", [128, 4096])
def test_pair_fold_kernel(card, W, add, mul, vdt):
    a, b, ast, wa, bst, wb, av, bv = _intersect_inputs(card, W, W + 1, vdt)
    _kernels.reset_launches()
    cnt, vals = spgemm.pair_fold(a, av, b, bv, ast, wa, bst, wb, W, mul, add)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_fold"] == 1
    wcnt, wvals = spgemm._pair_fold_plain(a, av, b, bv, ast, wa, bst, wb, W,
                                          mul, add)
    assert torch.equal(cnt, wcnt)
    if vdt == np.float32 and add == "PLUS":
        assert torch.allclose(vals, wvals, rtol=1e-5)
    else:
        assert torch.equal(vals, wvals)


@pytest.mark.parametrize("add,mul,vdt", [("PLUS", "TIMES", np.float32),
                                         ("MIN", "PLUS", np.int32),
                                         ("PLUS", "MINUS", np.int32),
                                         ("MAX", "RDIV", np.float32)])
@pytest.mark.parametrize("kind", PAIR_COUNT_CASES)
@pytest.mark.parametrize("path", ["search", "runs"])
def test_pair_fold_kernel_cases(card, kind, add, mul, vdt, path,
                                monkeypatch):
    """pair_fold on testing.pair_fold_case's edge lists (pair_count's
    runs, with values), through each kernel (the rule moved so that the
    case takes it): one launch; counts exact, values exact but float32
    PLUS (within rtol 1e-5: another fold order)."""
    monkeypatch.setattr(spgemm, "_RUNS_WIDTH", 0 if path == "runs" else 1)
    monkeypatch.setattr(spgemm, "_RUNS_EDGES", 0 if path == "runs"
                        else 1 << 40)
    a, av, b, bv, ast, wa, bst, wb, W = (
        torch.from_numpy(x).to(card) if isinstance(x, np.ndarray) else x
        for x in pair_fold_case(kind, vdt))
    assert spgemm.fold_path(W, ast.numel()) == path
    _kernels.reset_launches()
    cnt, vals = spgemm.pair_fold(a, av, b, bv, ast, wa, bst, wb, W, mul, add)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_fold"] == 1
    wcnt, wvals = spgemm._pair_fold_plain(a, av, b, bv, ast, wa, bst, wb, W,
                                          mul, add)
    assert torch.equal(cnt, wcnt)
    if vdt == np.float32 and add == "PLUS":
        assert torch.allclose(vals, wvals, rtol=1e-5)
    else:
        assert torch.equal(vals, wvals)


def test_spgemm_wrappers_raise(card):
    a, b, ast, wa, bst, wb, av, bv = _intersect_inputs(card, 128, 1,
                                                       np.float32)
    with pytest.raises(TypeError):
        spgemm.pair_count(a.long(), b, ast, wa, bst, wb, 128)
    with pytest.raises(ValueError):
        spgemm.fill_keys(a, b.cpu(), ast, wa, bst, wb, 128)
    with pytest.raises(TypeError):
        spgemm.pair_fold(a, av.double(), b, bv.double(), ast, wa, bst, wb,
                         128, "TIMES", "PLUS")


def test_triangle_count_and_k_truss_on_card(card, monkeypatch):
    import scipy.sparse as sp

    rows, cols, n = _kron12(True)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    L = sp.tril(sp.csr_matrix((np.ones(len(rows)), (rows, cols)), (n, n)),
                -1).tocsr()
    _kernels.reset_launches()
    assert algorithms.triangle_count(A) == int((L @ L).multiply(L).sum())
    assert _kernels.launches["pair_count"] > 0
    want = algorithms.k_truss(A, 4, device="cpu")._coo()
    for fused_env in ("1", "0"):
        monkeypatch.setenv("PYGB_PAIR_FUSED", fused_env)
        _kernels.reset_launches()
        got = algorithms.k_truss(A, 4)._coo()
        assert _kernels.launches["fill_keys" if fused_env == "0"
                                 else "pair_count"] > 0
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _scan_inputs(card, m, dtype, flags, seed):
    rng = np.random.RandomState(seed)
    # float values k / 8, |k| <= 32: every partial sum is exact in
    # float32, so any fold order gives the same bits
    v = (rng.randint(-1000, 1000, m) if dtype == torch.int32
         else rng.randint(-32, 33, m) / 8)
    f = {"none": np.zeros(m, bool), "all": np.ones(m, bool),
         "sparse": rng.rand(m) < 0.02}[flags]
    return (torch.from_numpy(v).to(card, dtype),
            torch.from_numpy(f).to(card))


@pytest.mark.parametrize("flags", ["none", "all", "sparse"])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("m", [1024, 3 * 2048 + 1024, 5 * 4096 + 1024,
                               1 << 20, 1 << 26])
def test_segfold_kernel(card, m, dtype, add, flags):
    """Lengths that are not a multiple of the kernel's 4096-value tile
    (partial last tiles), esc14's 2^26, one segment over every tile (at
    2^20 and 2^26 it spans more tiles than one 32-tile look-back window),
    a start at every value, and sparse starts: exact."""
    v, f = _scan_inputs(card, m, dtype, flags, m % 97)
    _kernels.reset_launches()
    got = scan.segfold(v, f, add)
    torch.cuda.synchronize()
    assert _kernels.launches["segfold"] == 1
    assert torch.equal(got, scan._segfold_plain(v, f, add))


def test_segfold_kernel_float_plus(card):
    """Random float32 values, PLUS: within rtol 1e-5 of the plain
    version (another fold order)."""
    rng = np.random.RandomState(3)
    m = 1 << 16
    v = torch.from_numpy(rng.rand(m).astype(np.float32)).to(card)
    f = torch.from_numpy(rng.rand(m) < 0.01).to(card)
    f[0] = True
    assert torch.allclose(scan.segfold(v, f, "PLUS"),
                          scan._segfold_plain(v, f, "PLUS"), rtol=1e-5)


def test_segfold_kernel_repeated(card):
    """Calls on one status buffer (the epoch) and growing lengths."""
    for i, m in enumerate([1 << 16, 1 << 12, 1 << 22, 1 << 16] * 3):
        v, f = _scan_inputs(card, m, torch.int32, "sparse", i)
        assert torch.equal(scan.segfold(v, f, "PLUS"),
                           scan._segfold_plain(v, f, "PLUS"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_esc_gather_kernel(card, dtype):
    """In-range slots equal the plain version; a row past the source is
    clamped to its last row, lane kept, as the TPU kernel clamps it."""
    rng = np.random.RandomState(5)
    S, rows = 64, 300
    qg = torch.from_numpy(rng.randint(0, rows - 20, S // 8)
                          .astype(np.int32)).to(card)
    dm = torch.from_numpy(rng.randint(0, 20 * 128, (S, 128))
                          .astype(np.int32)).to(card)
    cols = torch.from_numpy(rng.randint(0, 1 << 30, (rows, 128))
                            .astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.randint(-99, 99, (rows, 128))).to(card,
                                                                   dtype)
    _kernels.reset_launches()
    got = esc.esc_gather(cols, vals, qg, dm)
    torch.cuda.synchronize()
    assert _kernels.launches["esc_gather"] == 1
    for g, w in zip(got, esc._esc_gather_plain(cols, vals, qg, dm)):
        assert torch.equal(g, w)
    qg[0] = rows - 1
    dm[:8] = 3 * 128 + 5
    gc, gv = esc.esc_gather(cols, vals, qg, dm)
    assert bool((gc[:8] == cols[rows - 1, 5]).all())
    assert bool((gv[:8] == vals[rows - 1, 5]).all())


@pytest.mark.parametrize("sem,typ", [("PLUS_TIMES", "FP32"),
                                     ("PLUS_PAIR", "INT32"),
                                     ("MIN_PLUS", "INT32")])
def test_esc_spgemm_on_card(card, sem, typ):
    """A @ A at kron-12 (integer values 1..4): through ESC under "auto"
    (the dense tier's budget lowered below kron-12's 2^24 cells),
    four segfold launches and one esc_gather, equal to the same call on
    the CPU exactly (every sum is an integer below 2^24)."""
    rows, cols, _ = _kron12(False)
    dt = getattr(types, typ).numpy_dtype
    v = np.random.RandomState(7).randint(1, 5, len(rows)).astype(dt)
    semiring = getattr(getattr(types, typ), sem)
    options_set(spgemm_dense_cells=1 << 20)     # kron-12 fits 2^24 cells
    try:
        _kernels.reset_launches()
        got = gustavson.spgemm(rows, cols, v, rows, cols, v, semiring, dt)
    finally:
        options_set(spgemm_dense_cells=1 << 24)
    assert _kernels.launches["segfold"] == 4
    assert _kernels.launches["esc_gather"] == 1
    want = esc.esc_spgemm(rows, cols, v, rows, cols, v, semiring, dt,
                          device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_scan_and_gather_wrappers_raise(card):
    v = torch.zeros(1024, dtype=torch.int64, device=card)
    f = torch.zeros(1024, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        scan.segfold(v, f, "PLUS")
    with pytest.raises(TypeError):
        scan.segfold(v.int(), f.int(), "PLUS")
    c = torch.zeros((4, 128), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        esc.esc_gather(c, c.double(), c[0, :1], c[:8].contiguous())


# -- the algebra on the card: the types of 4 bytes or less, the new codes,
# -- and the redesigned lane_gather ------------------------------------------


@pytest.mark.parametrize("rows", [1, 7, 49152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lane_gather_redesigned(card, rows, dtype):
    """The redesigned lane_gather (a warp a row, 16-byte loads and
    stores) against its plain version, bit for bit: indices 0..127 and
    values with the top bit set (negative floats and ints); one launch."""
    rng = np.random.RandomState(rows)
    bits = rng.randint(-2 ** 31, 2 ** 31, (rows, 128), dtype=np.int64)
    x = torch.from_numpy(bits.astype(np.int32)).to(card)
    if dtype == torch.float32:
        x = x.view(torch.float32)
    idx = torch.from_numpy(rng.randint(0, 128, (rows, 128))
                           .astype(np.int8)).to(card)
    _kernels.reset_launches()
    got = perm._lane_gather(x, idx)
    torch.cuda.synchronize()
    assert _kernels.launches["lane_gather"] == 1
    assert torch.equal(got.view(torch.int32),
                       perm._lane_gather_plain(x, idx).view(torch.int32))


@pytest.mark.parametrize("typ", ["INT8", "UINT16", "UINT32", "BOOL"])
def test_every_wrapper_at_narrow_and_unsigned_types(card, typ):
    """Every kernel wrapper at INT8, UINT16, UINT32 (and BOOL), on
    testing.wrapper_cases: the kernel launches once (1- and 2-byte values
    as 4-byte words, UINT32 words with the unsigned code) and equals its
    plain version bit for bit, folds in the type's own order (MIN, MAX)."""
    wrappers, plains = typed_wrappers(), typed_plains()
    for name, case, call in wrapper_cases(typ, card):
        kfn = wrappers[name]
        _kernels.reset_launches()
        got = call(kfn)
        torch.cuda.synchronize()
        assert _kernels.launches[name] == 1, case
        want = call(plains[kfn])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), case


@pytest.mark.parametrize("add,typ", SEGFOLD_CODES)
def test_segfold_kernel_new_folds(card, add, typ):
    """segfold at every fold code the algebra adds and at the types of
    the algebra's paths, 2^16 values in about 1000 segments across many
    tiles: one launch, equal to its plain version bit for bit."""
    T = getattr(types, typ)
    m = getattr(T, add + "_MONOID")
    rng = np.random.RandomState(len(add) + len(typ))
    v = typed_values(rng, T, 1 << 16).to(card)
    f = torch.from_numpy(rng.rand(1 << 16) < 0.015).to(card)
    f[5000:40000] = False         # a segment over several tiles
    _kernels.reset_launches()
    got = scan.segfold(v, f, m)
    torch.cuda.synchronize()
    assert _kernels.launches["segfold"] == 1
    assert got.dtype == v.dtype
    assert torch.equal(got, scan._segfold_plain(v, f, m))


@pytest.mark.parametrize("add,mul,typ", POW_EXTREME_CODES + [
    ("PLUS", "user x ** y", "INT32")])
def test_pair_fold_pow_bshift_at_the_jax_rule(card, add, mul, typ):
    """Integer POW and BSHIFT at exponents of 64 and more, the type's
    minimum and -2^31 (testing.pow_operands), through pair_fold's codes
    (csrc/ops.cuh) and the generated kernel of the user op x ** y
    (csrc/gen.cuh's ipow): one launch, equal to the plain version, which
    the CPU tests hold to the JAX package's closures."""
    from pygraphblas_tpu_torch.testing import int_pow32, pow_operands
    T = getattr(types, typ)
    a, av, b, bv, ast, wa, bst, wb, W = pair_fold_case("run_across_blocks",
                                                       np.int32)
    av, bv = pow_operands(T, len(av), len(bv))
    av, bv = (T.to_torch(x).to(card) for x in (av, bv))
    a, b, ast, wa, bst, wb = (torch.from_numpy(x).to(card)
                              for x in (a, b, ast, wa, bst, wb))
    mop = int_pow32() if mul.startswith("user") else getattr(T, mul)
    fop = getattr(T, add + "_MONOID")
    _kernels.reset_launches()
    cnt, vals = spgemm.pair_fold(a, av, b, bv, ast, wa, bst, wb, W, mop, fop)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_fold"] == 1
    wcnt, wvals = spgemm._pair_fold_plain(a, av, b, bv, ast, wa, bst, wb, W,
                                          mop, fop)
    assert torch.equal(cnt, wcnt) and torch.equal(vals, wvals)


@pytest.mark.parametrize("add,mul,typ", PAIR_FOLD_CODES)
@pytest.mark.parametrize("path", ["search", "runs"])
def test_pair_fold_new_codes(card, add, mul, typ, path, monkeypatch):
    """pair_fold at the mul codes the algebra adds (ISEQ .. ISLE, LOR,
    LAND, LXOR: the warp kernel at every width; DIV with zero divisors
    saturating at the narrow type) and the ANY fold, at 1-, 2- and
    4-byte types, through each kernel: one launch, counts and values
    equal to the plain version (ANY folds as MAX in both)."""
    monkeypatch.setattr(spgemm, "_RUNS_WIDTH", 0 if path == "runs" else 1)
    monkeypatch.setattr(spgemm, "_RUNS_EDGES", 0 if path == "runs"
                        else 1 << 40)
    T = getattr(types, typ)
    a, av, b, bv, ast, wa, bst, wb, W = pair_fold_case("run_across_blocks",
                                                       np.int32)
    av, bv = (T.to_torch(x.astype(T.numpy_dtype)).to(card) for x in (av, bv))
    a, b, ast, wa, bst, wb = (torch.from_numpy(x).to(card)
                              for x in (a, b, ast, wa, bst, wb))
    mop, fop = getattr(T, mul), getattr(T, add + "_MONOID")
    _kernels.reset_launches()
    cnt, vals = spgemm.pair_fold(a, av, b, bv, ast, wa, bst, wb, W, mop, fop)
    torch.cuda.synchronize()
    assert _kernels.launches["pair_fold"] == 1
    wcnt, wvals = spgemm._pair_fold_plain(a, av, b, bv, ast, wa, bst, wb, W,
                                          mop, fop)
    assert torch.equal(cnt, wcnt) and vals.dtype == T.torch_dtype
    if typ == "FP32":
        # 0 / 0 is NaN; PLUS within rtol 1e-5 (another fold order)
        assert torch.allclose(vals, wvals, rtol=1e-5 if add == "PLUS" else 0,
                              atol=0, equal_nan=True)
    else:
        assert torch.equal(vals, wvals)


@pytest.fixture
def coo_tier():
    """Matrices of kron-12 on the COO tier (the container's sparse
    engines), vectors on the bitmap tier."""
    options_set(bitmap_max_cells=1 << 20)
    yield
    options_set(bitmap_max_cells=1 << 26, spmv_engine="auto",
                spgemm_engine="auto")


def test_container_pagerank_on_card(card, coo_tier):
    """algorithms.pagerank through Matrix.mxv: with spmv_engine="xspmv"
    every iteration is one xspmv of the hand kernels; with "csr8" no
    kernel runs; both equal the CPU run of the same call."""
    rows, cols, n = _kron12(False)
    want = algorithms.pagerank(generators.to_matrix(
        rows, cols, n, types.FP32, device="cpu"), itermax=5,
        tol=-1.0).to_numpy()
    A = generators.to_matrix(rows, cols, n, types.FP32)
    for engine, kernels in (("xspmv", True), ("csr8", False)):
        options_set(spmv_engine=engine)
        _kernels.reset_launches()
        got = algorithms.pagerank(A, itermax=5, tol=-1.0).to_numpy()
        torch.cuda.synchronize()
        L = _kernels.launches
        if kernels:
            assert L["mono_span"] == 10 and L["mono_cascade"] == 5
            assert L["lane_gather_tdesc"] == 5 and L["mid_pass"] == 5
        else:
            assert not any(L.values())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_container_sssp_bfs_on_card(card, coo_tier):
    """algorithms.sssp and bfs_level_vxm (vxm: SpMSpV, then the csr8
    plan; torch ops, no kernel of the port) equal the fused loops."""
    rows, cols, n = _kron12(False)
    w = np.random.RandomState(1).randint(1, 256, len(rows)).astype(
        np.float32)
    Aw = generators.to_matrix(rows, cols, n, types.FP32, vals=w)
    A = generators.to_matrix(rows, cols, n, types.BOOL)
    _kernels.reset_launches()
    d = algorithms.sssp(Aw, 0)
    lv = algorithms.bfs_level_vxm(A, 0)
    torch.cuda.synchronize()
    assert not any(_kernels.launches.values())
    assert d.to_lists() == fused.sssp(Aw, 0).to_lists()
    assert lv.to_lists() == fused.bfs_level(A, 0).to_lists()


def test_container_triangle_methods_on_card(card, coo_tier):
    """triangle_count "cohen" and "sandia_dot" through the containers
    launch pair_count (a masked Matrix.mxm) and give the sandia count."""
    rows, cols, n = _kron12(True)
    A = generators.to_matrix(rows, cols, n, types.INT64)
    want = algorithms.triangle_count(A)
    for method in ("cohen", "sandia_dot"):
        _kernels.reset_launches()
        assert algorithms.triangle_count(A, method=method) == want > 0
        assert _kernels.launches["pair_count"] > 0


def test_container_mxm_esc_on_card(card, coo_tier):
    """Matrix.mxm on the COO tier through ESC: 4 segfold launches and 1
    esc_gather, the product equal to scipy's exactly."""
    import scipy.sparse as sp

    rows, cols, n = _kron12(False)
    w = np.random.RandomState(7).randint(1, 5, len(rows)).astype(
        np.float32)
    A = generators.to_matrix(rows, cols, n, types.FP32, vals=w)
    options_set(spgemm_engine="esc")
    _kernels.reset_launches()
    C = A.mxm(A, semiring=types.FP32.PLUS_TIMES)
    torch.cuda.synchronize()
    assert _kernels.launches["segfold"] == 4
    assert _kernels.launches["esc_gather"] == 1
    S = sp.csr_matrix((w.astype(np.float64), (rows, cols)), (n, n))
    P = (S @ S).tocoo()
    order = np.lexsort((P.col, P.row))
    r, c, v = C._coo()
    assert np.array_equal(r, P.row[order]) and np.array_equal(c, P.col[order])
    assert np.array_equal(v, P.data[order].astype(np.float32))


UINT_CARD = {"UINT16": 40000, "UINT32": 3000000000, "UINT64": 2**63 + 2048}


@pytest.mark.parametrize("tname", sorted(UINT_CARD))
@pytest.mark.parametrize("cells", [1 << 26, 1])
def test_unsigned_selects_on_card(card, tname, cells):
    """UINT16/32/64 value selects and comparisons on the card, bitmap and
    COO tiers: values past the sign bit of the signed view read as
    unsigned (the expected lists are the JAX package's answers)."""
    t, big = getattr(types, tname), UINT_CARD[tname]
    options_set(bitmap_max_cells=cells, vector_max_cells=cells)
    try:
        from pygraphblas_tpu_torch import Matrix, Vector

        A = Matrix.from_lists([0, 1, 2], [0, 1, 2], [big, 1, 0], typ=t,
                              device="cuda")
        v = Vector.from_lists([0, 1, 2], [big, 1, 0], typ=t, device="cuda")
        assert A.select(">0").to_lists() == [[0, 1], [0, 1], [big, 1]]
        assert A.select(">=", 2).to_lists() == [[0], [0], [big]]
        assert (A > 0).to_lists() == [[0, 1], [0, 1], [True, True]]
        assert A.select("<", big).to_lists() == [[1, 2], [1, 2], [1, 0]]
        assert v.select(">0").to_lists() == [[0, 1], [big, 1]]
        assert (v > 0).to_lists() == [[0, 1], [True, True]]
        assert v.select("<=", 1).to_lists() == [[1, 2], [1, 0]]
    finally:
        options_set(bitmap_max_cells=1 << 26, vector_max_cells=1 << 27)


def test_extract_assign_kronecker_on_card(card, coo_tier):
    """Extract and assign over ranges and Kronecker products on the card,
    on the COO tier and the bitmap tier, equal to the CPU runs."""
    rows, cols, n = _kron12(True)
    w = np.random.RandomState(2).randint(1, 9, len(rows)).astype(np.int32)
    outs = []
    for dev in ("cuda", "cpu"):
        A = generators.to_matrix(rows, cols, n, types.INT32, vals=w,
                                 device=dev)
        S = A.extract_matrix(slice(0, 63), slice(0, 63))
        C = A.dup()
        C.assign_matrix(S, slice(100, 163), slice(200, 263),
                        accum=types.INT32.PLUS)
        C.assign_scalar(7, slice(5, 9), None, mask=A)
        outs.append([A.extract_matrix([9, 3, 3, 4000]).to_lists(),
                     A.extract_row(17).to_lists(),
                     A.extract_col(5, slice(0, 99)).to_lists(),
                     C.to_lists(), S.kronecker(S[0:7, 0:7]).to_lists(),
                     A[0:15, 0:15].kronecker(A[0:3, 0:3]).to_lists()])
    assert outs[0] == outs[1]


def test_louvain_on_card(card, coo_tier):
    """louvain_cluster at kron-12 symmetrised on the card (the products
    through ESC): labels equal to the CPU run; every ESC call launches 4
    segfold and 1 esc_gather."""
    rows, cols, n = _kron12(True)
    want = algorithms.louvain_cluster(generators.to_matrix(
        rows, cols, n, types.FP32, device="cpu"), max_levels=2).to_lists()
    A = generators.to_matrix(rows, cols, n, types.FP32)
    options_set(spgemm_engine="esc")   # kron-12's products fit the dense
    esc.reset_stats()                  # tier's cells
    _kernels.reset_launches()
    got = algorithms.louvain_cluster(A, max_levels=2)
    torch.cuda.synchronize()
    calls = esc.stats["calls"]
    assert got.to_lists() == want
    assert calls > 0 and _kernels.launches["segfold"] == 4 * calls
    assert _kernels.launches["esc_gather"] == calls


@pytest.mark.parametrize("tier", ["bitmap", "coo"])
def test_uint64_user_predicate_on_card(card, tier):
    """A user select predicate at UINT64 compares and computes unsigned
    values on the card, Matrix and Vector, on both tiers; a float
    operand raises."""
    from pygraphblas_tpu_torch import Matrix, Vector

    big = 2**63 + 2048
    if tier == "coo":
        options_set(bitmap_max_cells=1, vector_max_cells=1)
    try:
        A = Matrix.from_lists([0, 1, 2], [0, 1, 2], [big, 1, 0],
                              typ=types.UINT64, device="cuda")
        v = Vector.from_lists([0, 1, 2], [big, 1, 0], typ=types.UINT64,
                              device="cuda")
        for c, want in ((A, [[0], [0], [big]]), (v, [[0], [big]])):
            assert c.select(lambda i, j, x, t: x > t, 8).to_lists() == want
            assert c.select(lambda i, j, x, t: x >= t, big).to_lists() == \
                want
            assert c.select(lambda i, j, x, t: x + 1 > t, 8).to_lists() \
                == want
            with pytest.raises(TypeError, match="UINT64"):
                c.select(lambda i, j, x, t: x > 0.5, 8)
    finally:
        options_set(bitmap_max_cells=1 << 26, vector_max_cells=1 << 27)


def test_bfs_frontier_on_card(card):
    """fused.bfs_frontier on a 300 x 300 4-neighbour lattice from its
    centre: levels equal the closed form and the CPU run's; a frontier
    CSR built for "cuda" is the one the call reuses; a p_bits of 4
    takes the dense fallback (the xspmv kernels) with equal levels."""
    from pygraphblas_tpu_torch import Matrix

    s = 300
    idx = np.arange(s * s).reshape(s, s)
    r = np.concatenate([idx[:, :-1].ravel(), idx[:, 1:].ravel(),
                        idx[:-1, :].ravel(), idx[1:, :].ravel()])
    c = np.concatenate([idx[:, 1:].ravel(), idx[:, :-1].ravel(),
                        idx[1:, :].ravel(), idx[:-1, :].ravel()])
    A = Matrix.sparse(types.BOOL, s * s, s * s, device="cuda")
    A._build(r, c, np.ones(len(r), np.bool_))
    start = 150 * s + 150
    fused._frontier_csr(A, "cuda")
    got = fused.bfs_frontier(A, start)
    assert fused.last_frontier["route"] == "frontier"
    assert len([k for k in A._cache() if isinstance(k, tuple)
                and k[0] == "frontier_csr"]) == 1
    i, j = np.divmod(np.arange(s * s), s)
    want = np.abs(i - 150) + np.abs(j - 150) + 1
    assert np.array_equal(got._vals.cpu().numpy(), want)
    B = Matrix.sparse(types.BOOL, s * s, s * s, device="cpu")
    B._build(r, c, np.ones(len(r), np.bool_))
    assert got.to_lists() == fused.bfs_frontier(B, start,
                                                device="cpu").to_lists()
    _kernels.reset_launches()
    dense = fused.bfs_frontier(A, start, p_bits=4)
    torch.cuda.synchronize()
    assert fused.last_frontier["route"] == "dense"
    assert dense.to_lists() == got.to_lists()
    assert sum(_kernels.launches.values()) > 0


def test_fused_dnn_on_card(card):
    """fused.dnn and algorithms.dnn on a 256-neuron RadiX net of 12
    layers on the card: equal to each other, to the CPU run and to the
    scipy oracle of the recurrence (every value a binary fraction)."""
    from pygraphblas_tpu_torch import Matrix, testing

    radices, w = testing.fullscale_radices(256)
    n, W = testing.radix_net(radices, 12, weight=w, seed=7, device="cuda")
    _, Wc = testing.radix_net(radices, 12, weight=w, seed=7, device="cpu")
    r, c, v = testing.fullscale_images(500, n, seed=7)
    outs = []
    for dev, L in (("cuda", W), ("cpu", Wc)):
        Bs = testing.build_biases(n, 12, -0.25, device=dev)
        Y = Matrix.sparse(types.FP32, 500, n, device=dev)
        Y._build(r, c, v)
        outs.append(fused.dnn(L, Bs, Y, device=dev).to_lists())
        outs.append(algorithms.dnn(L, Bs, Y).to_lists())
    assert outs[0] == outs[1] == outs[2] == outs[3]
    truth = testing.scipy_dnn_oracle(r, c, v, [x._coo() for x in Wc], 500,
                                      n, -0.25)
    truth.sort_indices()
    truth = truth.tocoo()
    assert outs[0] == [truth.row.tolist(), truth.col.tolist(),
                       truth.data.tolist()]


# the distributed tier in a world of one over NCCL: a (1, 1) mesh on the
# card, every collective to a group of one


@pytest.fixture
def mesh(card):
    from pygraphblas_tpu_torch.parallel import make_mesh

    m = make_mesh()
    assert m.device_type == "cuda" and tuple(m.shape) == (1, 1)
    return m


def _dist_graph(scale=10, sym=True):
    rows, cols, n = generators.rmat_edges(scale, 8, seed=5)
    if sym:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols,
                                                                   rows])
    keys = np.unique(rows.astype(np.int64) * n + cols)
    return keys // n, keys % n, n


@pytest.mark.parametrize("add,mul,dt", [
    ("PLUS", "TIMES", "float32"), ("MIN", "PLUS", "int32"),
    ("BOR", "BAND", "uint32"), ("MIN", "FIRSTI1", "int64"),
    ("PLUS", "TIMES", "int16"), ("LOR", "LAND", "bool"),
    ("TIMES", "PLUS", "int64"), ("BXOR", "MINUS", "int8")])
def test_dist_spmv_world_of_one(mesh, add, mul, dt):
    """DistSpMV on the card over NCCL (the per-bit, widened and gathered
    collectives too) equal to the same executor on the CPU's plain
    torch ops: the fold and the collective of a group of one."""
    from pygraphblas_tpu_torch.parallel import dist as pdist

    r, c, n = _dist_graph()
    rng = np.random.RandomState(3)
    v = rng.randint(1, 9, len(r))
    x = rng.randint(1, 9, n)
    s = pdist.DistSpMV(mesh, n, n, r, c, v.astype(dt), add=add, mul=mul,
                       dtype=dt)
    got = s.to_numpy(s.gather(s(x.astype(dt))))
    xt = pdist._to_work(x.astype(dt), np.dtype(dt), "cpu")
    vt = pdist._to_work(v.astype(dt), np.dtype(dt), "cpu")
    prod = (s._mul(vt, xt[torch.from_numpy(c)]) if s._mul is not None
            else torch.from_numpy(r + 1))
    want = pdist._ADDS[add](prod.to(vt.dtype), torch.from_numpy(r), n)
    assert np.array_equal(got[:n], s.to_numpy(want))


def test_dist_matrix_world_of_one(mesh):
    """Matrix.shard on the card: mxv, BFS, SSSP, triangles, k-truss and
    masked mxm equal to the single-device container results; PageRank
    (on the pattern) within 1e-5 of algorithms.pagerank."""
    from pygraphblas_tpu_torch import Matrix

    r, c, n = _dist_graph()
    w = np.random.RandomState(4).randint(1, 9, len(r)).astype(np.float32)
    A = Matrix.sparse(types.FP32, n, n)
    A._build(r, c, w)
    D = A.shard(mesh)
    x = np.random.RandomState(5).rand(n).astype(np.float32)
    from pygraphblas_tpu_torch import Vector

    xv = Vector.from_lists(list(range(n)), list(x), n)
    want = A.mxv(xv, semiring=types.FP32.PLUS_TIMES)
    got = D.mxv(x, semiring=types.FP32.PLUS_TIMES)
    gi, gv = got._coo()
    wi, wv = want._coo()
    assert np.array_equal(gi, wi) and np.allclose(gv, wv, rtol=1e-5)
    B = A.pattern(types.BOOL)
    for a, b in ((D.bfs_level(3), algorithms.bfs_level(B, 3)),
                 (D.sssp(3), algorithms.sssp(A, 3))):
        assert all(np.array_equal(p, q) for p, q in zip(a._coo(), b._coo()))
    I = Matrix.sparse(types.INT64, n, n)
    I._build(r, c, np.ones(len(r), np.int64))
    DI = I.shard(mesh)
    assert DI.triangle_count() == algorithms.triangle_count(I)
    kt_got, kt_want = DI.k_truss(4)._coo(), algorithms.k_truss(I, 4)._coo()
    assert all(np.array_equal(p, q) for p, q in zip(kt_got, kt_want))
    got = D.mxm(A, semiring=types.FP32.PLUS_TIMES, mask=A)._coo()
    want = A.mxm(A, semiring=types.FP32.PLUS_TIMES, mask=A)._coo()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert np.allclose(got[2], want[2], rtol=1e-5)
    P = Matrix.sparse(types.FP32, n, n)
    P._build(r, c, np.ones(len(r), np.float32))
    pr = P.shard(mesh).pagerank(itermax=20, tol=0).to_numpy()
    assert np.allclose(pr, algorithms.pagerank(P, itermax=20,
                                               tol=0).to_numpy(), atol=1e-5)


def test_dist_pagerank_checkpoint_world_of_one(mesh, tmp_path):
    """An interrupted run on the card resumed from its snapshot equals
    the uninterrupted run bit for bit: the tiles' float folds run each
    row in order (segment_reduce), not by atomic adds."""
    from pygraphblas_tpu_torch.parallel import dist as pdist

    r, c, n = _dist_graph(sym=False)
    full = pdist.dist_pagerank(mesh, n, r, c, itermax=20, tol=0)
    ck = str(tmp_path / "pr.npz")
    pdist.dist_pagerank(mesh, n, r, c, itermax=10, tol=0,
                        checkpoint_path=ck, checkpoint_every=5)
    resumed = pdist.dist_pagerank(mesh, n, r, c, itermax=20, tol=0,
                                  checkpoint_path=ck, checkpoint_every=5)
    assert np.array_equal(resumed, full)


def test_frontier_all_to_all_world_of_one(mesh):
    """At P == 1 every packet stays: the first cap slots in order."""
    from pygraphblas_tpu_torch.parallel import dist as pdist

    idx = torch.arange(16, device="cuda")
    val = torch.arange(16, device="cuda", dtype=torch.float32) / 2
    dest = torch.zeros(16, dtype=torch.int32, device="cuda")
    dest[::3] = -1
    ri, rv = pdist.frontier_all_to_all(mesh, idx, val, dest, 16)
    keep = (dest >= 0).cpu().numpy()
    want = np.full(16, -1)
    want[:keep.sum()] = np.arange(16)[keep]
    assert np.array_equal(ri.cpu().numpy()[0], want)
    assert np.array_equal(rv.cpu().numpy()[0][:keep.sum()],
                          np.arange(16)[keep] / 2)


def test_run_doctests_on_the_card(card):
    """The docstring examples with the card as their default device."""
    import pygraphblas_tpu_torch as T

    assert T.run_doctests() == 0


_DEMOS = sorted((Path(__file__).resolve().parent.parent / "demo_torch")
                .glob("[0-9]*.py"))


@pytest.mark.parametrize("script", _DEMOS, ids=[d.name for d in _DEMOS])
def test_demo_on_the_card(card, script, capsys):
    """Each gallery script's main on the card prints OK last."""
    spec = importlib.util.spec_from_file_location(
        "demo_torch_" + script.stem, script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cuda"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"
