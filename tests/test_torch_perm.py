"""Port parity: pygraphblas_tpu_torch.core.perm against the JAX package.

Both routing routes of the port's PermPlan.build are checked:
  - the greedy route (no native code), which must give the very stage
    arrays the JAX package's greedy route gives for the same seed;
  - the native K == 128 route (csrc/benes.cpp, built here with g++),
    at n = 2 * 128^3 (D = 3, S = 2), which takes the fused middle and
    the fold8-fused ascend.
The plain versions of kernels 5-7 must equal the JAX Pallas kernels in
interpret mode: moves exactly, PLUS folds within rtol 1e-6.  The
library call chip_smoke times beside the moving kernels (one torch.take
at testing.take_index's index) must equal the JAX functions too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pygraphblas_tpu.io.native as jnative
from pygraphblas_tpu.core import perm as jperm
from pygraphblas_tpu_torch import _native
from pygraphblas_tpu_torch.core import perm as tperm
from pygraphblas_tpu_torch.testing import take_index, take_source


def test_choose_shape_equal():
    for n in [16400, 100000, 1 << 21, 1 << 24, 18694144, 75 * 10 ** 6]:
        for fill in (112, 128):
            assert tperm._choose_shape(n, fill) == \
                jperm._choose_shape(n, fill)


def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "HAVE_NATIVE", False)
    monkeypatch.setattr(_native, "available", lambda: False)


@pytest.mark.parametrize("n", [5, 1000, 16385, 40000])
def test_greedy_route_equals_jax(n, monkeypatch):
    _no_native(monkeypatch)
    rng = np.random.RandomState(n)
    src = rng.permutation(n)
    jp = jperm.PermPlan.build(src)
    tp = tperm.PermPlan.build(src)
    for k in ("n", "trivial", "D", "S", "R0", "K"):
        assert getattr(tp, k) == getattr(jp, k), k
    if tp.trivial:
        assert np.array_equal(tp.src_idx, np.asarray(jp.src_idx))
    else:
        for a, b in zip(tp.a_stages + tp.c_stages,
                        jp.a_stages + jp.c_stages):
            assert a.dtype == np.int8
            assert np.array_equal(a, np.asarray(b))
        assert (tp.ssel is None) == (jp.ssel is None)
        if tp.ssel is not None:
            assert np.array_equal(tp.ssel, np.asarray(jp.ssel))
    pt = tp.to("cpu")
    x = (np.arange(n, dtype=np.float32) * 2.0 + 1.0)
    assert np.array_equal(pt.apply(torch.from_numpy(x)).numpy(), x[src])
    xi = np.arange(n, dtype=np.int32)
    assert np.array_equal(pt.apply(torch.from_numpy(xi)).numpy(), xi[src])


@pytest.mark.parametrize("fold", ["PLUS", "MAX"])
def test_greedy_route_apply_fold8(fold, monkeypatch):
    _no_native(monkeypatch)
    n = 1 << 15
    rng = np.random.RandomState(5)
    src = rng.permutation(n)
    pt = tperm.PermPlan.build(src).to("cpu")
    assert pt.K < 128
    x = rng.rand(n).astype(np.float32)
    out, folded = pt.apply_fold8(torch.from_numpy(x), np.float32(0), fold)
    assert folded
    f3 = x[src].reshape(-1, 8, 128)
    want = f3.sum(axis=1) if fold == "PLUS" else f3.max(axis=1)
    assert np.allclose(out.numpy()[:want.size], want.reshape(-1),
                       rtol=1e-6)


def test_native_route_fused_plan():
    """n == 2*128^3: the port's own native K == 128 plan, D == 3, runs
    tdesc -> inner3 -> tasc(fold8) (their plain versions here)."""
    assert _native.available()
    n = 2 * 128 ** 3
    rng = np.random.RandomState(7)
    src = rng.permutation(n)
    p = tperm.PermPlan.build(src)
    assert (p.D, p.S, p.K) == (3, 2, 128)
    pt = p.to("cpu")
    x = rng.rand(n).astype(np.float32)
    assert np.array_equal(pt.apply(torch.from_numpy(x)).numpy(), x[src])
    folded, ok = pt.apply_fold8(torch.from_numpy(x), np.float32(0), "PLUS")
    assert ok
    want = x[src].reshape(-1, 8, 128).sum(axis=1).reshape(-1)
    assert np.allclose(folded.numpy()[:want.size], want, rtol=1e-6)


def test_native_color_is_exact():
    rng = np.random.RandomState(3)
    rows = 40
    u = np.repeat(np.arange(rows), 128)
    v = rng.permutation(u)
    col = _native.benes_color(u, v, rows, rows)
    assert len(np.unique(u * 128 + col)) == len(u)
    assert len(np.unique(v * 128 + col)) == len(u)


def _rand(rng, shape, dtype):
    if dtype == np.float32:
        return rng.rand(*shape).astype(dtype)
    return rng.randint(-1000, 1000, shape).astype(dtype)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jperm, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize("g,rb,dtype", [(1, 2, np.float32),
                                        (2, 3, np.float32),
                                        (1, 8, np.int32)])
def test_tdesc_tasc_plain_match_interpret(g, rb, dtype, interpret):
    """Kernels 5 and 6 (with and without the fold8)."""
    rng = np.random.RandomState(g * 10 + rb)
    r_l = rb * 128
    x = _rand(rng, (g * r_l, 128), dtype)
    idx = rng.randint(0, 128, (g * r_l, 128)).astype(np.int8)
    want = np.asarray(jperm._lane_gather_tdesc(jnp.asarray(x),
                                               jnp.asarray(idx), g, r_l))
    got = tperm._lane_gather_tdesc(torch.from_numpy(x),
                                   torch.from_numpy(idx), g, r_l)
    assert np.array_equal(got.numpy(), want)
    for fold, jfold in ((None, None), ("PLUS", jnp.add),
                        ("MIN", jnp.minimum)):
        want = np.asarray(jperm._lane_gather_tasc(
            jnp.asarray(x), jnp.asarray(idx), g, r_l, fold8=jfold))
        got = tperm._lane_gather_tasc(torch.from_numpy(x),
                                      torch.from_numpy(idx), g, r_l,
                                      fold8=fold).numpy()
        if fold == "PLUS" and dtype == np.float32:
            assert np.allclose(got, want, rtol=1e-6)
        else:
            assert np.array_equal(got, want), fold


@pytest.mark.parametrize("g,S,dtype", [(2, 1, np.float32),
                                       (3, 3, np.float32),
                                       (2, 9, np.float32),
                                       (2, 3, np.int32)])
def test_inner3_plain_matches_interpret(g, S, dtype, interpret):
    """Kernel 7 for any index content."""
    rng = np.random.RandomState(g * 100 + S)
    r_l = 128 * S
    x = _rand(rng, (g * r_l, 128), dtype)
    ix = [rng.randint(0, 128, (g * S * 128, 128)).astype(np.int8)
          for _ in range(4)]
    ssel = (rng.randint(0, S, (g * 128, S, 128)).astype(np.int8)
            if S > 1 else None)
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    want = np.asarray(jperm._inner3(J(x), J(ix[0]), J(ix[1]), J(ssel),
                                    J(ix[2]), J(ix[3]), g, S))
    got = tperm._inner3(T(x), T(ix[0]), T(ix[1]), T(ssel), T(ix[2]),
                        T(ix[3]), g, S)
    assert np.array_equal(got.numpy(), want)


def test_wrappers_reject_other_devices():
    x = torch.zeros((128, 128), device="meta")
    idx = torch.zeros((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tperm._lane_gather_tdesc(x, idx, 1, 128)
    with pytest.raises(ValueError):
        tperm._lane_gather_tasc(x, idx, 1, 128)
    with pytest.raises(ValueError):
        tperm._inner3(x, idx, idx, None, idx, idx, 1, 1)


@pytest.mark.parametrize("nsub,S,dtype", [(64, 1, np.float32),
                                          (40, 3, np.int32),
                                          (4, 124, np.float32)])
def test_mid_pass_plain_matches_jax(nsub, S, dtype):
    """Kernel 8 (_mid_pass) at S = 1 (no select), 3 (kron-18's bottom
    level) and 124 (kron-16's), against the JAX function, whose CPU path
    is XLA's take_along_axis."""
    rng = np.random.RandomState(nsub + S)
    x = _rand(rng, (nsub, S, 128), dtype)
    a = rng.randint(0, 128, (nsub * S, 128)).astype(np.int8)
    c = rng.randint(0, 128, (nsub * S, 128)).astype(np.int8)
    ssel = (rng.randint(0, S, (nsub, S, 128)).astype(np.int8)
            if S > 1 else None)
    want = np.asarray(jperm._mid_pass(
        jnp.asarray(x), jnp.asarray(a),
        None if ssel is None else jnp.asarray(ssel), jnp.asarray(c), S))
    T = lambda v: None if v is None else torch.from_numpy(v)
    got = tperm._mid_pass(T(x), T(a), T(ssel), T(c))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lane_gather_plain_matches_jax(dtype):
    """Kernel 4 (_lane_gather) against the JAX function (XLA on the
    CPU): out[r, l] = x[r, idx[r, l]]."""
    rng = np.random.RandomState(4)
    x = _rand(rng, (384, 128), dtype)
    idx = rng.randint(0, 128, (384, 128)).astype(np.int8)
    want = np.asarray(jperm._lane_gather(jnp.asarray(x), jnp.asarray(idx)))
    got = tperm._lane_gather(torch.from_numpy(x), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,K", [(3 * 128 ** 2, 128), (40000, 105)])
def test_native_route_mid_pass_plans(n, K):
    """The port's native plans that take _mid_pass (D == 2, S == 3):
    K == 128, with the fold8 fused into the ascend after it, and K < 128,
    with the fold run after the permutation."""
    assert _native.available()
    rng = np.random.RandomState(n)
    src = rng.permutation(n)
    p = tperm.PermPlan.build(src)
    assert (p.D, p.S, p.R0, p.K) == (2, 3, 384, K)
    pt = p.to("cpu")
    x = rng.rand(n).astype(np.float32)
    assert np.array_equal(pt.apply(torch.from_numpy(x)).numpy(), x[src])
    folded, _ = pt.apply_fold8(torch.from_numpy(x), np.float32(0), "MAX")
    f = x[src]
    f = np.concatenate([f, np.zeros(-len(f) % 1024, np.float32)])
    want = f.reshape(-1, 8, 128).max(axis=1).reshape(-1)
    assert np.array_equal(folded.numpy()[:want.size], want)


def _take(plain, x, fill=0):
    """One torch.take at the recipe's premade index (testing.take_index)
    in place of `plain` on x."""
    idx = take_index(plain, x.shape)
    return torch.take(take_source(x, fill), idx).reshape(plain(x).shape)


@pytest.mark.parametrize("nsub,S", [(64, 1), (40, 3), (4, 124)])
def test_take_index_mid_pass_matches_jax(nsub, S):
    """The library call beside kernel 8: torch.take at the index built
    from _mid_pass_plain over 1..n equals the JAX function on the CPU."""
    rng = np.random.RandomState(nsub + S)
    x = _rand(rng, (nsub, S, 128), np.float32)
    a = rng.randint(0, 128, (nsub * S, 128)).astype(np.int8)
    c = rng.randint(0, 128, (nsub * S, 128)).astype(np.int8)
    ssel = (rng.randint(0, S, (nsub, S, 128)).astype(np.int8)
            if S > 1 else None)
    want = np.asarray(jperm._mid_pass(
        jnp.asarray(x), jnp.asarray(a),
        None if ssel is None else jnp.asarray(ssel), jnp.asarray(c), S))
    T = lambda v: None if v is None else torch.from_numpy(v)
    got = _take(lambda v: tperm._mid_pass_plain(v, T(a), T(ssel), T(c)),
                T(x))
    assert np.array_equal(got.numpy(), want)


def test_take_index_mid_pass_select_out_of_range():
    """A select outside [0, S) gives 0 in the plain version (as in the
    TPU and CUDA kernels), and the recipe maps it to the pad cell."""
    rng = np.random.RandomState(5)
    nsub, S = 6, 3
    x = torch.from_numpy(_rand(rng, (nsub, S, 128), np.int32))
    a, c = (torch.from_numpy(rng.randint(0, 128, (nsub * S, 128))
                             .astype(np.int8)) for _ in range(2))
    ssel = torch.from_numpy(rng.randint(-4, S + 4, (nsub, S, 128))
                            .astype(np.int8))
    plain = lambda v: tperm._mid_pass_plain(v, a, ssel, c)
    want = plain(x)
    cl = c.long().reshape(nsub, S, 128)
    dead = ~torch.gather((ssel >= 0) & (ssel < S), 2, cl)
    assert bool(dead.any()) and bool((want[dead] == 0).all())
    assert torch.equal(_take(plain, x), want)


@pytest.mark.parametrize("kernel", ["tdesc", "tasc", "inner3"])
def test_take_index_matches_interpret(kernel, interpret):
    """The library call beside kernels 5, 6 (without the fold) and 7:
    torch.take at the index built from the port's plain version equals
    the JAX Pallas kernel in interpret mode."""
    rng = np.random.RandomState(11)
    if kernel == "inner3":
        g, S = 2, 3
        x = _rand(rng, (g * S * 128, 128), np.int32)
        ix = [rng.randint(0, 128, (g * S * 128, 128)).astype(np.int8)
              for _ in range(4)]
        ssel = rng.randint(0, S, (g * 128, S, 128)).astype(np.int8)
        want = jperm._inner3(*map(jnp.asarray, (x, ix[0], ix[1], ssel,
                                                ix[2], ix[3])), g, S)
        T = [torch.from_numpy(v) for v in (ix[0], ix[1], ssel, ix[2],
                                           ix[3])]
        plain = lambda v: tperm._inner3_plain(v, *T, g, S)
    else:
        g, r_l = 1, 2 * 128
        x = _rand(rng, (g * r_l, 128), np.float32)
        idx = rng.randint(0, 128, (g * r_l, 128)).astype(np.int8)
        jfn = jperm._lane_gather_tdesc if kernel == "tdesc" else \
            jperm._lane_gather_tasc
        want = jfn(jnp.asarray(x), jnp.asarray(idx), g, r_l)
        pfn = tperm._tdesc_plain if kernel == "tdesc" else tperm._tasc_plain
        plain = lambda v: pfn(v, torch.from_numpy(idx), g, r_l)
    got = _take(plain, torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
