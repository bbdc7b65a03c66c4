"""CPU tests of the benchmark's parts: the graph generators, the plain
references, the yardstick, the trace reduction and the answer sampler.

    python -m pytest portbench -q
"""

import numpy as np
import pytest
import torch

from portbench import graphs, harness, tracing, yardstick
from portbench.reference import bfs as rbfs
from portbench.reference import pagerank as rpr

KRON = dict(family="kron", scale=10, edge_factor=16, a=0.57, b=0.19,
            c=0.19, permute_ids=True, undirected=True, drop_self_loops=True,
            drop_duplicates=True)
URAND = dict(family="urand", scale=12, edge_factor=16, undirected=True,
             drop_self_loops=True, drop_duplicates=True)


def _make(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return graphs.make(cfg, gen, torch.device("cpu"))


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_generator_reproducible_from_seed(cfg):
    r1, c1, n = _make(cfg, 2**31 + 11)
    r2, c2, _ = _make(cfg, 2**31 + 11)
    r3, _, _ = _make(cfg, 2**31 + 12)
    assert n == 1 << cfg["scale"]
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert r3.numel() != r1.numel() or not torch.equal(r3, r1)


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_generator_counts_against_numpy(cfg):
    """The device pipeline keeps exactly the distinct unordered pairs of
    distinct endpoints of the raw draws, both ways, sorted."""
    import importlib

    fam = importlib.import_module(f"portbench.graphs.{cfg['family']}")
    gen = torch.Generator().manual_seed(7)
    raw_r, raw_c = fam.draw(cfg, gen, torch.device("cpu"))
    m = cfg["edge_factor"] << cfg["scale"]
    assert raw_r.numel() == raw_c.numel() == m
    n = 1 << cfg["scale"]
    assert int(raw_r.max()) < n and int(raw_c.min()) >= 0
    rows, cols = graphs.undirected(raw_r, raw_c, cfg["scale"])
    a, b = raw_r.numpy(), raw_c.numpy()
    keep = a != b
    pairs = {(min(x, y), max(x, y)) for x, y in zip(a[keep], b[keep])}
    assert rows.numel() == 2 * len(pairs)
    r, c = rows.numpy(), cols.numpy()
    assert np.all(r != c)
    key = r * n + c
    assert np.all(np.diff(key) > 0)                # sorted, no duplicates
    assert set(zip(r.tolist(), c.tolist())) == set(zip(c.tolist(),
                                                       r.tolist()))


def test_urand_count_near_expectation():
    """2m draws over n(n-1)/2 pairs: about m^2 / (n^2) repeats and m / n
    self-loops are dropped."""
    rows, _, n = _make(URAND, 3)
    m = URAND["edge_factor"] << URAND["scale"]
    expect = 2 * (m - m / n - m * m / (n * (n - 1)))
    assert abs(rows.numel() - expect) < 0.01 * expect


def test_kron_degrees_are_skewed():
    rows, _, n = _make(dict(KRON, scale=12), 5)
    deg = torch.bincount(rows, minlength=n)
    assert int(deg.max()) > 20 * float(deg[deg > 0].float().mean())
    assert int((deg == 0).sum()) > n // 10      # GAP's kron has isolates


# a directed 5-cycle-free graph worked by hand: edges u -> v
#   0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 2; vertex 4 isolated
HAND = (torch.tensor([0, 0, 1, 2, 3]), torch.tensor([1, 2, 2, 0, 2]), 5)


def test_reference_pagerank_by_hand():
    rows, cols, n = HAND
    d = 0.85
    r, it = rpr.pagerank(rows, cols, n, d, 1, -1.0)
    assert it == 1
    # one step from 1/5: out-degrees 2, 1, 1, 1, 0
    w = np.array([0.5, 1, 1, 1, 0]) * d / 5
    want = np.full(5, 0.15 / 5)
    want[1] += w[0]
    want[2] += w[0] + w[1] + w[3]
    want[0] += w[2]
    np.testing.assert_allclose(r.numpy(), want, rtol=1e-12)
    r2, it2 = rpr.pagerank(rows, cols, n, d, 100, 1e-4)
    assert 1 < it2 < 100
    # stopped at the first iteration whose L1 change was <= 1e-4
    r3, _ = rpr.pagerank(rows, cols, n, d, it2 - 1, -1.0)
    assert float((r2 - r3).abs().sum()) <= 1e-4


def test_reference_pagerank_accepts_a_near_tie():
    """r_k alone, unless the change at the stop (or one before it) lies
    within `tie` of tol: then the iterate after (or before) it too."""
    rows, cols, n = HAND
    d = 0.85
    _, k = rpr.pagerank(rows, cols, n, d, 100, 1e-4)
    diffs = [c for _, c in zip(range(k + 1), (
        c for _, c in rpr.iterates(rows, cols, n, d)))]
    rk = rpr.pagerank(rows, cols, n, d, k, -1.0)[0]
    rprev = rpr.pagerank(rows, cols, n, d, k - 1, -1.0)[0]
    rnext = rpr.pagerank(rows, cols, n, d, k + 1, -1.0)[0]
    answers, k2, prev = rpr.accepted(rows, cols, n, d, 100, 1e-4, 1e-9)
    assert k2 == k and len(answers) == 1
    assert torch.equal(answers[0], rk) and torch.equal(prev, rprev)
    # tol just above the change at k: the run stops at k, and r_(k+1)
    # is accepted too
    answers, k2, _ = rpr.accepted(rows, cols, n, d, 100,
                                  diffs[k - 1] * (1 + 1e-3), 1e-2)
    assert k2 == k and len(answers) == 2
    assert torch.equal(answers[0], rk) and torch.equal(answers[1], rnext)
    # tol just below it: the run stops at k + 1, and r_k is accepted too
    answers, k3, _ = rpr.accepted(rows, cols, n, d, 100,
                                  diffs[k - 1] * (1 - 1e-3), 1e-2)
    assert k3 == k + 1 and len(answers) == 2
    assert torch.equal(answers[0], rnext) and torch.equal(answers[1], rk)


def test_reference_pagerank_bfloat16_differs():
    rows, cols, n = _make(KRON, 1)
    hi, _ = rpr.pagerank(rows, cols, n, 0.85, 20, 1e-4)
    lo, _ = rpr.pagerank(rows, cols, n, 0.85, 20, 1e-4, torch.bfloat16)
    assert rpr.rel_l1(lo.float(), hi) > 1e-3
    assert rpr.rel_l1(hi.float(), hi) < 1e-6


def test_reference_bfs_by_hand():
    rows, cols, n = HAND
    assert rbfs.levels(rows, cols, n, 0).tolist() == [1, 2, 2, 0, 0]
    assert rbfs.levels(rows, cols, n, 3).tolist() == [3, 4, 2, 1, 0]
    assert rbfs.levels(rows, cols, n, 4).tolist() == [0, 0, 0, 0, 1]
    # the control: a level keeps its lowest-numbered new vertex only
    assert rbfs.levels(rows, cols, n, 0, cap=1).tolist() == [1, 2, 3, 0, 0]


def test_reference_components_and_work():
    # undirected: 0-1-2 path, 3-4 edge, 5 isolated
    r = torch.tensor([0, 1, 1, 2, 3, 4])
    c = torch.tensor([1, 0, 2, 1, 4, 3])
    lab, entries = rbfs.component_entries(r, c, 6)
    assert lab.tolist() == [0, 0, 0, 3, 3, 5]
    assert entries[lab].tolist() == [4, 4, 4, 2, 2, 0]


def test_spmv_roofline_bytes():
    """One int32 column index an entry, one int32 row pointer a row, x
    and y once in fp32: 68.2 MB for gap-kron19's 15,481,412 entries."""
    assert yardstick.spmv_bytes(15_481_412, 2**19, 2**19) == 68_217_104
    assert yardstick.spmv_bytes(16_776_678, 2**19, 2**19) == 73_398_168
    t = 68_217_104 / yardstick.peak("NVIDIA H100 80GB HBM3")[
        "hbm_bytes_per_s"]
    assert abs(t - 20.36e-6) < 0.01e-6
    assert yardstick.peak("another card") is None


def test_spread_uses_python_quartiles():
    med, sp = yardstick.spread([10, 11, 12, 13, 14, 15])
    q1, _, q3 = __import__("statistics").quantiles(
        [10, 11, 12, 13, 14, 15], n=4)
    assert med == 12.5 and sp == pytest.approx((q3 - q1) / 12.5)


def _ev(name, kind, s, e, corr=0, linked=0, tid=1):
    return tracing.Ev(name, kind, s, e, corr, linked, tid)


def test_trace_reduction():
    evs = [
        _ev(tracing.SEGMENT, "user_annotation", 0, 1000),
        _ev("pb:trial.pagerank", "user_annotation", 0, 900),
        _ev("aten::mul", "cpu_op", 10, 30, corr=5),
        _ev("aten::_local_scalar_dense", "cpu_op", 290, 400, corr=6),
        _ev("cudaMemcpyAsync", "cuda_runtime", 300, 399, corr=77),
        _ev("void inner3_kernel<float>(float*)", "kernel", 100, 200),
        _ev("void inner3_kernel<float>(float*)", "kernel", 150, 250),
        _ev("void at::native::vectorized_elementwise_kernel<4>(x)",
            "kernel", 40, 60, linked=5),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 250, 300),
        _ev("tdesc_kernel", "kernel", 990, 1100),     # clipped at 1000
    ]
    red = tracing.reduce(evs, {"inner3": 2, "lane_gather_tdesc": 1,
                               "mono_span": 0})
    assert red["window_s"] == pytest.approx(1e-6)
    # busy: [40,60) + [100,300) + [990,1000)
    assert red["busy_s"] == pytest.approx(230e-9)
    ops = dict(red["device_ops"])
    assert ops["inner3"] == pytest.approx(200e-9)
    assert ops["aten::mul"] == pytest.approx(20e-9)
    assert ops["lane_gather_tdesc"] == pytest.approx(10e-9)
    assert red["coverage"] == {"inner3": [2, 2], "lane_gather_tdesc": [1, 1]}
    gaps = dict(red["idle_gaps"])
    # [300, 990): begins inside the scalar read of the trial
    assert gaps["pb:trial.pagerank > aten::_local_scalar_dense"] == \
        pytest.approx(690e-9)
    assert gaps["pb:trial.pagerank > python"] == pytest.approx(80e-9)


def test_sampler_keeps_reservoir_routes_and_last():
    s = harness.Sampler(3, seed=9)
    for i in range(50):
        s.offer(i, f"a{i}", "dense" if i != 17 else "frontier")
    kept = s.kept()
    assert 17 in kept and 0 in kept and 49 in kept
    assert 3 <= len(kept) <= 6
    s2 = harness.Sampler(3, seed=9)
    for i in range(50):
        s2.offer(i, f"a{i}", "dense" if i != 17 else "frontier")
    assert s2.kept() == kept
