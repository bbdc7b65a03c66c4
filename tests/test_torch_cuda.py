"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import).  Run on a machine with one:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from pygraphblas_tpu_torch import _kernels, fused, generators, types
from pygraphblas_tpu_torch.core import mono, perm

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
    plan, _ = _span_plan(card)
    with pytest.raises(TypeError):
        mono.mono_span(plan, torch.zeros(9000, dtype=torch.int64,
                                         device=card), 0)


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


def test_pagerank_goes_through_the_kernels(card):
    # kron-19 is the smallest kron graph whose permutation takes the
    # fused kernels (D = 3, K = 128 after the n_perm pad)
    rows, cols, n = generators.rmat_edges(19, 16)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    ref = fused.pagerank(A, itermax=10, tol=-1.0, device="cpu")
    _kernels.reset_launches()
    got = fused.pagerank(A, itermax=10, tol=-1.0)
    torch.cuda.synchronize()
    assert all(c > 0 for c in _kernels.launches.values())
    err = (got._vals.cpu() - ref._vals).abs().max()
    assert err <= 1e-5 * ref._vals.abs().max()
