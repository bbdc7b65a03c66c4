"""A whole run on the CPU with the timed path broken underneath: each
fault a cell can have must come out as ``correct`` false, and the
sound run as true.  Also the control at a size a test run can hold:
the reference in the program's place, one precision below (PageRank)
or with its frontier's overflow unchecked (BFS), fails the limit.

On one card no exchange between chips exists, so that fault has no
case here.

    python -m pytest portbench -q
"""

import numpy as np
import pytest
import torch

from portbench import graphs, harness
from portbench.trials import bfs as tbfs
from portbench.trials import pagerank as tpr

SMALL = {"scale": 11}


def _run(cell, seed=2**31 + 3):
    return harness.run_cell(cell, seed, 0.3, 0, device="cpu",
                            overrides=SMALL)


@pytest.mark.parametrize("cell", ["kron19-pr", "urand19-pr", "kron19-bfs",
                                  "urand19-bfs"])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"edges_per_s", "setup_s"}


def _stuck_loop(spmv, n, itermax, d_inv_damped, teleport, tol):
    """PageRank whose every step returns its state unchanged."""
    r = torch.full((n,), 1.0 / n, dtype=torch.float32,
                   device=d_inv_damped.device)
    for _ in range(itermax):
        spmv(r * d_inv_damped)
    return r, torch.zeros(()), itermax


def _short_loop(orig):
    """PageRank that stops one iteration before the program would."""
    def loop(spmv, n, itermax, d_inv_damped, teleport, tol):
        _, _, it = orig(spmv, n, itermax, d_inv_damped, teleport, tol)
        return orig(spmv, n, int(it) - 1, d_inv_damped, teleport, tol)
    return loop


def _half_rows(orig):
    """xspmv with the odd rows' sums left out."""
    def xspmv(plan, x, *a, **k):
        y, m = orig(plan, x, *a, **k)
        y = y.clone()
        y[1::2] = 0
        return y, m
    return xspmv


def _same_frontier(orig):
    """xspmv that hands back its input: a level step that leaves the
    frontier where it was."""
    def xspmv(plan, x, *a, **k):
        y, m = orig(plan, x, *a, **k)
        return x.clone(), m
    return xspmv


def _altered(orig, typ):
    """An answer with one value altered where it is produced."""
    from pygraphblas_tpu_torch import Vector

    def entry(*a, **k):
        v = orig(*a, **k)
        vals = torch.as_tensor(v.to_numpy()).clone()
        j = int(torch.argmax(vals))
        vals[j] = vals[j] + 1 if typ == "INT64" else vals[j] * 0.5
        mask = vals != 0
        return Vector._from_parts(getattr(__import__(
            "pygraphblas_tpu_torch").types, typ), vals, mask)
    return entry


def test_pagerank_faults_are_caught(monkeypatch):
    from pygraphblas_tpu_torch import fused
    from pygraphblas_tpu_torch.core import xspmv as xs

    with monkeypatch.context() as m:
        m.setattr(fused, "_loop", _stuck_loop)
        assert not _run("kron19-pr")["correct"]
    with monkeypatch.context() as m:
        m.setattr(fused, "_loop", _short_loop(fused._loop))
        r = _run("urand19-pr")
        assert not r["correct"]
        assert r["checks"]["pr_rel_l1"]["value"] > 3 * tpr.LIMIT
    with monkeypatch.context() as m:
        m.setattr(xs, "xspmv", _half_rows(xs.xspmv))
        assert not _run("kron19-pr")["correct"]
    with monkeypatch.context() as m:
        m.setattr(fused, "pagerank", _altered(fused.pagerank, "FP32"))
        assert not _run("urand19-pr")["correct"]


def test_bfs_faults_are_caught(monkeypatch):
    from pygraphblas_tpu_torch import algorithms, fused
    from pygraphblas_tpu_torch.core import xspmv as xs

    def no_push(indices, visited, levels, owner, deg, cum, adj, slot, E,
                P, n, level):
        return torch.zeros(P, dtype=torch.int64,
                           device=deg.device), torch.zeros(
                               (), dtype=torch.int64, device=deg.device)

    with monkeypatch.context() as m:        # both routes stand still
        m.setattr(xs, "xspmv", _same_frontier(xs.xspmv))
        m.setattr(fused, "_frontier_expand", no_push)
        assert not _run("kron19-bfs")["correct"]
    with monkeypatch.context() as m:        # the dense route alone
        m.setattr(xs, "xspmv", _same_frontier(xs.xspmv))
        assert not _run("urand19-bfs")["correct"]
    with monkeypatch.context() as m:
        m.setattr(xs, "xspmv", _half_rows(xs.xspmv))
        assert not _run("urand19-bfs")["correct"]
    with monkeypatch.context() as m:
        m.setattr(algorithms, "bfs_level",
                  _altered(algorithms.bfs_level, "INT64"))
        assert not _run("kron19-bfs")["correct"]


def test_a_trial_that_raises_is_a_failure(monkeypatch):
    from pygraphblas_tpu_torch import fused

    orig, calls = fused.pagerank, []

    def boom(*a, **k):          # set-up's warm calls pass, trials raise
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("lost")
        return orig(*a, **k)

    monkeypatch.setattr(fused, "pagerank", boom)
    r = _run("kron19-pr")
    assert not r["correct"] and r["failed"] == r["attempted"] > 0


class _Ctx:
    def __init__(self, cfg, mix, seed):
        self.cfg, self.mix = cfg, mix
        self.gen = torch.Generator().manual_seed(seed)
        self.edges_dev = graphs.make(cfg, self.gen, torch.device("cpu"))
        self.n = self.edges_dev[2]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_controls_fail_their_limits(seed):
    """The controls at kron-14 (larger levels than a BFS cap of 4096
    needs): the bfloat16 PageRank, PageRank one iteration short and the
    capped BFS read past their limits; the references read 0 against
    themselves."""
    _, _, cfg, mix = harness.cell("kron19-pr")
    ctx = _Ctx(dict(cfg, scale=14), mix, seed)
    t = tpr.Trials(ctx)
    ref = t.reference(ctx.edges_dev, None)
    assert t.gap(t.control(ctx.edges_dev, None), ref) > 30 * tpr.LIMIT
    assert t.gap(t.short(ctx.edges_dev, None), ref) > 3 * tpr.LIMIT
    assert t.gap(ref[0].float().numpy(), ref) < tpr.LIMIT / 30

    _, _, cfg, mix = harness.cell("kron19-bfs")
    ctx = _Ctx(dict(cfg, scale=14), dict(mix, pool=8), seed)
    t = tbfs.Trials(ctx)
    src = [t.key(i) for i in range(8)]
    ctl = [t.gap(t.control(ctx.edges_dev, s),
                 t.reference(ctx.edges_dev, s)) for s in src]
    assert max(ctl) > tbfs.LIMIT
    assert all(t.gap(t.reference(ctx.edges_dev, s),
                     t.reference(ctx.edges_dev, s)) == 0 for s in src)
    assert np.all(np.asarray(t.work(ctx.edges_dev, src)) > 0)
