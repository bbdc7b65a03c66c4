#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pygraphblas_tpu_torch) on one card.

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. the build: the CUDA kernels (nvcc, sm_90a) and the native Benes
     routing (g++), from the sources in this checkout;
  3. the paths, each on its own graph (RMAT kron, generated from seed
     42) and its xspmv plans, each driven through the entry point a user
     calls, with the launch counters set to 0 just before and read just
     after; every kernel of the path must have run, exactly the expected
     number of times per xspmv:
       pr20   fused.pagerank, kron-20 ef16 FP32 (A^T), checked against
              the planless COO oracle, timed (best of 3);
       pr21   fused.pagerank, kron-21 ef16 FP32: its first fold level
              streams its source, so the cascade does not apply;
       bfs18  fused.bfs_batch (16 sources) + fused.bfs_level(0),
              kron-18 ef16 BOOL, levels equal to scipy's BFS exactly;
       sssp18 fused.sssp from the vertex of most out-edges, kron-18
              ef16 FP32 with integer weights 1..255, distances equal
              to scipy's Dijkstra exactly;
       bc16   fused.bc, sources 0..3, kron-16 symmetrised FP32, within
              1e-4 of the same call with device="cpu";
     before each path, every kernel it runs is held against its plain
     PyTorch version on the card at the path's own shapes (bit-exact),
     and timed at the shapes of the path named for it in TIMED (and
     mid_pass at bc16's S = 124 too);
  4. small MIN/MAX-fold, mul and int32 cases of every kernel, and
     _lane_gather (which no path reaches) at kron-18's level-0 shape
     beside torch.gather;
  5. one JSON line of kernel results, the card line, and the final
     {"ok": true, "device": ...} line.

Kernel times ("ms") come from CUDA events around back-to-back calls at a
path's shapes, queued behind a sleep kernel so that the host's launch
path is not timed; the plain versions' ("plain_ms") from back-to-back
calls alone (their tens of launches a call would fill the launch queue
behind the sleep).  Both are summed over the kernel's launches in one
xspmv of its timed path.  "in_path_ms" is the
kernel's device time per xspmv inside that path (torch.profiler).
"bound_ms" is the larger of the bytes moved once over the HBM rate and
the fold/mul operations over the float32 rate; for mono_cascade the
bytes are every plan's dm and qg, the first source and the placed
output (its intermediates stay in L2).  Each path through the cascade
also times it against the chain of mono_span launches it replaces, as
kernels ("cascade_vs_chain") and end to end through the entry point
("cascade_ab", the cascade call made to return None); pr20 does so for
every count of fold levels too.

Run:  python3 chip_smoke.py [--iters 200] [--reps 20]
Logs too long for the terminal (nvcc -Xptxas -v, profiler tables, every
check) go to chiprun_out/.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# H100 SXM data sheet, at a 700 W limit: HBM rate, and float32 outside
# the tensor cores (the folds and muls of these kernels)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "mono_span": ("pygraphblas_tpu_torch/csrc/mono.cu",
                  "pygraphblas_tpu/core/mono.py:247"),
    "mono_cascade": ("pygraphblas_tpu_torch/csrc/cascade.cu",
                     "pygraphblas_tpu/core/mono.py:343"),
    "mono_rows": ("pygraphblas_tpu_torch/csrc/mono.cu",
                  "pygraphblas_tpu/core/mono.py:470"),
    "lane_gather": ("pygraphblas_tpu_torch/csrc/perm.cu",
                    "pygraphblas_tpu/core/perm.py:520"),
    "lane_gather_tdesc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                          "pygraphblas_tpu/core/perm.py:577"),
    "lane_gather_tasc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                         "pygraphblas_tpu/core/perm.py:642"),
    "inner3": ("pygraphblas_tpu_torch/csrc/perm.cu",
               "pygraphblas_tpu/core/perm.py:741"),
    "mid_pass": ("pygraphblas_tpu_torch/csrc/perm.cu",
                 "pygraphblas_tpu/core/perm.py:817"),
}

# kernel -> the path whose shapes its "ms" is timed at (lane_gather: no
# path launches it; it is timed alone at the bfs18 level-0 shape)
TIMED = {"mono_span": "pr20", "mono_cascade": "pr20", "mono_rows": "pr21",
         "lane_gather": "isolated", "lane_gather_tdesc": "pr20",
         "lane_gather_tasc": "pr20", "inner3": "pr20", "mid_pass": "bfs18"}

# launches per xspmv of each path (zero for every kernel not named)
EXPECTED = {
    "pr20": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 1,
             "inner3": 1, "lane_gather_tasc": 1},
    "pr21": {"mono_span": 7, "mono_rows": 1, "lane_gather_tdesc": 1,
             "inner3": 1, "lane_gather_tasc": 1},
    "bfs18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
              "mid_pass": 1, "lane_gather_tasc": 2},
    "sssp18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
               "mid_pass": 1, "lane_gather_tasc": 2},
    "bc16": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 1,
             "mid_pass": 1, "lane_gather_tasc": 1},
}

# kernel symbol prefix in a profile -> kernel name
_SYMBOLS = {"mono_span_kernel": "mono_span",
            "mono_cascade_kernel": "mono_cascade",
            "mono_rows_kernel": "mono_rows",
            "lane_gather_kernel": "lane_gather",
            "tdesc_kernel": "lane_gather_tdesc",
            "tasc_kernel": "lane_gather_tasc", "inner3_kernel": "inner3",
            "mid_pass_kernel": "mid_pass"}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps, behind_sleep=True):
    """Mean time of fn() in ms over reps back-to-back calls, from CUDA
    events, after one warm-up call.

    behind_sleep: the calls are queued behind a sleep kernel that
    outlasts the host's enqueueing of all of them (checked: the sleep
    has not ended when the last call is queued), so the events time the
    card's work and not the host's ~25 us launch path, which bounds a
    3 us kernel timed back to back.  Without it (for a call that may
    synchronise inside), plain back-to-back timing."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if behind_sleep:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered or not behind_sleep:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 30:
            raise RuntimeError("event_ms: the calls were not all queued "
                               "within a 0.5 s sleep; one synchronises")
        cycles *= 4


class Checks:
    """Kernel-vs-plain comparisons, each with its time and bound."""

    def __init__(self, torch, reps):
        self.torch = torch
        self.reps = reps
        self.rows = []
        self.cascade_vs_chain = {}      # path -> cascade and chain ms

    def run(self, kernel, path, case, kfn, pfn, nbytes, ops=0,
            timed=False):
        """Every comparison is exact: gathers move values, and the folds
        run in the plain version's order (s = 0..7, level by level)."""
        torch = self.torch
        got = kfn()
        want = pfn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel}/{path} {case}: shape/dtype "
                                 f"{tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        ok = bool(torch.equal(got, want))
        both = torch.isfinite(want) & torch.isfinite(got) \
            if got.is_floating_point() else None
        diff = (got.double() - want.double()).abs()
        if both is not None:
            diff = diff[both]
        err = float(diff.max()) if diff.numel() else 0.0
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        row = dict(kernel=kernel, path=path, case=case,
                   shape=list(got.shape),
                   dtype=str(got.dtype).replace("torch.", ""),
                   max_abs_err=err, tol="exact", ok=ok, timed=timed,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        if timed:
            row["ms"] = event_ms(torch, kfn, self.reps)
            # a plain version is tens of torch ops: queued behind a sleep
            # they fill the launch queue, so they are timed back to back
            row["plain_ms"] = event_ms(torch, pfn, self.reps,
                                       behind_sleep=False)
        self.rows.append(row)
        log(f"  {kernel:17s} {path:8s} {case:26s} err={err:.3e} "
            f"{'ok' if ok else 'FAIL'}"
            + (f"  {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
               f"bound {row['bound_ms']:.4f} ms)" if timed else ""))
        if not ok:
            raise AssertionError(f"{kernel}/{path} {case} disagrees with "
                                 f"its plain version: max err {err}")
        return got


def mono_bytes(plan, src_len, fold, mul):
    """dm, q0 or qg, the source read once (at most src_n of it), vals,
    and the output written once."""
    S = plan.S
    out = (S // 8 if fold else S) * 128 * 4
    idx = S * 128 * plan.dm.element_size() + \
        (S // 8 * 4 if plan.wva else S * 4)
    return (idx + min(src_len, plan.src_n) * 4 + out
            + (S * 128 * 4 if mul else 0))


def cascade_vs_chain(torch, reps, cascade, chain):
    """Event ms of the cascade and of the chain of mono_span launches it
    replaces, on the same inputs, timed in the order cascade, chain,
    chain, cascade (best of each)."""
    if not torch.equal(cascade(), chain()):
        raise AssertionError("mono_cascade differs from the mono_span chain")
    ms = {"cascade_ms": [], "chain_ms": []}
    for k in ("cascade_ms", "chain_ms", "chain_ms", "cascade_ms"):
        ms[k].append(event_ms(torch, cascade if k == "cascade_ms" else chain,
                              reps))
    return {k: min(v) for k, v in ms.items()}


def cascade_by_levels(torch, reps, plan):
    """The cascade of the first k fold levels, with plan k as its
    unfolded last pass, beside the chain of the same k + 1 mono_span
    launches, for k = 1 .. levels: the slope in k is the cost of one
    level in each."""
    from pygraphblas_tpu_torch.core import mono as M

    L = plan.levels + plan.places
    cur = torch.rand(plan.m1, device="cuda")
    rows = []
    for k in range(1, len(L)):
        def chain(k=k):
            c = cur
            for lp in L[:k]:
                c = M.mono_span(lp, c.reshape(-1), 0.0,
                                fold="PLUS").reshape(-1)
            return M.mono_span(L[k], c, 0.0)
        rows.append(dict(levels=k, **cascade_vs_chain(
            torch, reps,
            lambda k=k: M.mono_cascade(L[:k], L[k], cur, 0.0, "PLUS"),
            chain)))
        log(f"  cascade vs chain, {k} fold levels: "
            f"{rows[-1]['cascade_ms']:.4f} vs {rows[-1]['chain_ms']:.4f} ms")
    return rows


def check_xspmv_kernels(torch, ck, plan, x, sem, path, timed=()):
    """Walk one xspmv (core/xspmv.py:xspmv) step by step on the card,
    running each kernel and its plain version on the same inputs.
    Kernels named in `timed` are timed too."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P

    fill = sem.identity(np.float32)
    add, mul = sem.add, sem.mul

    def gather(case, mp, src, **kw):
        name = "mono_span" if mp.wva else "mono_rows"
        kfn = M.mono_span if mp.wva else M.mono_rows
        fold = kw.get("fold")
        return ck.run(name, path, case,
                      lambda: kfn(mp, src, fill, **kw),
                      lambda: M.mono_gather_plain(mp, src, fill, **kw),
                      mono_bytes(mp, src.numel(), fold, "mul" in kw),
                      ops=(mp.S // 8 * 128 * 7 if fold else 0)
                      + (mp.S * 128 if "mul" in kw else 0),
                      timed=name in timed)

    xc = gather("pre", plan.pre, x).reshape(-1)
    if mul == "SECOND":
        prod = gather("decode", plan.decode, xc)
    else:
        prod = gather("decode", plan.decode, xc, vals=plan.vals_col,
                      mul=mul)
    prod = prod.reshape(-1)

    pp = plan.perm
    D, S, R0, K = pp.D, pp.S, pp.R0, pp.K
    fused8 = K == 128 and D >= 2 and pp.n % 1024 == 0
    xe = torch.cat([prod, torch.full((R0 * K - prod.numel(),), float(fill),
                                     device=prod.device)]).reshape(R0, K)
    if K < 128:
        xe = torch.nn.functional.pad(xe, (0, 128 - K))
    cur = xe.contiguous()
    cell = 4 + 1                     # fp32 value + int8 lane index
    fuse_mid = D >= 3 and K == 128 and S <= 24
    shapes = []
    for lvl in range(D - 1):
        r_l = R0 // 128 ** lvl
        g = cur.shape[0] // r_l
        shapes.append((g, r_l))
        if fuse_mid and lvl == D - 2:
            break
        assert r_l >= 128, "a level shorter than 128 rows"
        x_in, a = cur, pp.a_stages[lvl]
        cur = ck.run("lane_gather_tdesc", path, f"level{lvl} g={g} r_l={r_l}",
                     lambda: P._lane_gather_tdesc(x_in, a, g, r_l),
                     lambda: P._tdesc_plain(x_in, a, g, r_l),
                     x_in.numel() * (cell + 4),
                     timed="lane_gather_tdesc" in timed)
    x_in = cur
    if fuse_mid:
        g, r_l = shapes[-1]
        args = (pp.a_stages[D - 2], pp.a_stages[D - 1], pp.ssel,
                pp.c_stages[D - 1], pp.c_stages[D - 2], g, S)
        cur = ck.run("inner3", path, f"g={g} S={S}",
                     lambda: P._inner3(x_in, *args),
                     lambda: P._inner3_plain(x_in, *args),
                     x_in.numel() * (4 + 5 + 4), timed="inner3" in timed)
        start = D - 3
    else:
        nsub = cur.shape[0] // S
        x3 = cur.reshape(nsub, S, 128)
        args = (pp.a_stages[D - 1], pp.ssel, pp.c_stages[D - 1])
        nidx = 3 if pp.ssel is not None else 2
        cur = ck.run("mid_pass", path, f"nsub={nsub} S={S}",
                     lambda: P._mid_pass(x3, *args),
                     lambda: P._mid_pass_plain(x3, *args),
                     x3.numel() * (4 + nidx + 4),
                     timed="mid_pass" in timed).reshape(nsub * S, 128)
        start = D - 2
    for lvl in range(start, -1, -1):
        g, r_l = shapes[lvl]
        x_in, c = cur, pp.c_stages[lvl]
        f8 = add if (lvl == 0 and fused8) else None
        nout = x_in.numel() // 8 if f8 else x_in.numel()
        cur = ck.run("lane_gather_tasc", path,
                     f"level{lvl} g={g} r_l={r_l}" + (" fold8" if f8
                                                      else ""),
                     lambda: P._lane_gather_tasc(x_in, c, g, r_l, f8),
                     lambda: P._tasc_plain(x_in, c, g, r_l, f8),
                     x_in.numel() * cell + nout * 4,
                     ops=nout * 7 if f8 else 0,
                     timed="lane_gather_tasc" in timed)
    if fused8:
        acc1 = cur.reshape(-1)
    else:
        acc1, _ = pp.apply_fold8(prod, fill, add)    # torch ops
    cur = acc1.reshape(-1)[:plan.m1]
    levels, place = plan.levels, plan.places[0]
    if M._cascade_applies(levels, place, cur.dtype):
        def chain(gather1):
            def run():
                c2 = cur
                for lp in levels:
                    c2 = gather1(lp, c2.reshape(-1), fill,
                                 fold=add).reshape(-1)
                return gather1(place, c2, fill)
            return run
        # every plan's dm and qg, the first source and the placed output:
        # the intermediates never leave L2
        isz = cur.element_size()
        nbytes = sum(p.dm.numel() * p.dm.element_size() + p.qg.numel() * 4
                     for p in levels + [place])
        nbytes += (min(cur.numel(), levels[0].src_n) + place.S * 128) * isz
        ops = sum(lp.S // 8 * 128 * 7 for lp in levels)
        cascade = lambda: M.mono_cascade(levels, place, cur, fill, add)
        out = ck.run("mono_cascade", path, f"{len(levels)} levels + place",
                     cascade, chain(M.mono_gather_plain), nbytes, ops=ops,
                     timed="mono_cascade" in timed)
        ck.cascade_vs_chain[path] = cascade_vs_chain(
            torch, ck.reps, cascade, chain(M.mono_span))
        return out
    for i, lp in enumerate(levels):
        cur = gather(f"level{i + 1} fold", lp, cur.reshape(-1),
                     fold=add).reshape(-1)
    return gather("place", place, cur)


class PathRunner:
    """Drives the paths: counts launches (and xspmv calls) over each."""

    def __init__(self, torch, card):
        from pygraphblas_tpu_torch import _kernels
        from pygraphblas_tpu_torch.core import xspmv as xs

        self.torch, self.card, self.K = torch, card, _kernels
        self.calls = 0
        self.counts = {}
        self.results = {}
        orig = xs.xspmv

        def counted(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)

        xs.xspmv = counted       # fused.py calls xs.xspmv

    def drive(self, path, run, per_xspmv):
        """Run `run()` with the counters at 0; check every kernel of the
        path ran exactly `per_xspmv` times per xspmv call."""
        torch, K = self.torch, self.K
        torch.cuda.synchronize()
        K.reset_launches()
        self.calls = 0
        out = run()
        torch.cuda.synchronize()
        counts, calls = dict(K.launches), self.calls
        want = {k: v * calls for k, v in per_xspmv.items()}
        log(f"  {path}: {calls} xspmv calls; launches "
            + ", ".join(f"{k} {c}" for k, c in counts.items() if c))
        for k in KERNELS:
            if counts[k] != want.get(k, 0):
                raise AssertionError(
                    f"{path}: kernel {k} launched {counts[k]} times in "
                    f"{calls} xspmv calls, expected {want.get(k, 0)}")
            if per_xspmv.get(k) and counts[k] == 0:
                raise AssertionError(f"{path}: kernel {k} never ran")
        self.counts[path] = dict(counts=counts, xspmv_calls=calls)
        return out


def cascade_ab(torch, run):
    """Wall seconds of run() through xspmv's cascade and through the
    per-level chain (the cascade call made to return None, as it does
    for a plan it cannot take), in the order cascade, chain, chain,
    cascade; best of each and every run."""
    from pygraphblas_tpu_torch.core import xspmv as xs

    orig = xs.mono_cascade
    runs = {"cascade_s": [], "chain_s": []}
    try:
        for k in ("cascade_s", "chain_s", "chain_s", "cascade_s"):
            xs.mono_cascade = orig if k == "cascade_s" else \
                (lambda *a, **kw: None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            runs[k].append(time.perf_counter() - t0)
    finally:
        xs.mono_cascade = orig
    return dict({k: min(v) for k, v in runs.items()}, runs=runs)


def graph(scale, sym=False):
    from pygraphblas_tpu_torch.generators import rmat_edges

    rows, cols, n = rmat_edges(scale, 16)
    if sym:
        r = np.concatenate([rows, cols])
        c = np.concatenate([cols, rows])
        keep = r != c
        key = np.unique(r[keep] * n + c[keep])
        rows, cols = key // n, key % n
    return rows, cols, n


def plan_for(A, transpose, tag):
    t0 = time.perf_counter()
    plan = A._xspmv_plan(transpose, np.float32, device="cuda")
    pp = plan.perm
    log(f"  {tag} plan {time.perf_counter() - t0:.1f} s: n_perm="
        f"{plan.n_perm} D={pp.D} S={pp.S} R0={pp.R0} K={pp.K} "
        f"levels={len(plan.levels)}")
    for name, mp in ([("pre", plan.pre), ("decode", plan.decode)]
                     + [(f"level{i + 1}", lp)
                        for i, lp in enumerate(plan.levels)]
                     + [("place", plan.places[0])]):
        log(f"    {name:8s} S={mp.S} src_n={mp.src_n} wva={mp.wva} "
            f"stream={mp.stream} ok={mp.ok}")
    return plan


def profile_path(torch, drv, run, tag):
    """Device time by kernel per xspmv over one run of a path."""
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    drv.calls = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_xspmv = max(drv.calls, 1)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{tag}.txt"),
              "w") as f:
        f.write(table)
    cuda = torch.autograd.DeviceType.CUDA
    per_kernel = dict.fromkeys(KERNELS, 0.0)
    other = 0.0
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
        name = next((v for k, v in _SYMBOLS.items() if k in e.key), None)
        if name:
            per_kernel[name] += us
        else:
            other += us
    dev_ms = (sum(per_kernel.values()) + other) / 1e3
    log(f"  profile {tag} ({n_xspmv} xspmv): device {dev_ms:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall under the profiler; per xspmv:")
    for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        if us:
            log(f"    {k:18s} {us / 1e3 / n_xspmv:.4f} ms")
    log(f"    {'other (torch ops)':18s} {other / 1e3 / n_xspmv:.4f} ms")
    return {k: us / 1e3 / n_xspmv for k, us in per_kernel.items()}


def check_small_cases(torch, ck):
    """MIN/MAX folds, muls and int32 at small sizes (not timed)."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P
    from pygraphblas_tpu_torch.core.xspmv import XSpmvPlan

    rng = np.random.RandomState(2)
    src_n = 9000
    idx = np.sort(rng.randint(0, src_n, 64 * 128))
    idx[::11] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    span = M.MonoPlan.build(idx, src_n).to("cuda")
    assert span.wva > 0
    saved = M._SPAN_MAX_WVA
    M._SPAN_MAX_WVA = 0
    try:
        rows16 = M.MonoPlan.build(idx, src_n).to("cuda")
        big = np.sort(rng.randint(0, 2_500_000, 64 * 128))
        rows32 = M.MonoPlan.build(big, 2_500_000).to("cuda")
        stream = M.MonoPlan.build(np.sort(rng.randint(0, 1_500_000,
                                                      3 * 64 * 128)),
                                  3_000_000).to("cuda")
    finally:
        M._SPAN_MAX_WVA = saved
    assert rows16.wva == 0 and rows32.dm.dtype == torch.int32
    assert stream.stream and stream.ok
    inf = np.float32(np.inf)
    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    for tag, mp, n in (("span", span, src_n), ("rows16", rows16, src_n),
                       ("rows32", rows32, 2_500_000),
                       ("stream", stream, 3_000_000)):
        kernel = "mono_span" if mp.wva else "mono_rows"
        kfn = M.mono_span if mp.wva else M.mono_rows
        srcf = torch.from_numpy(rng.rand(n).astype(np.float32)).cuda()
        srci = torch.from_numpy(rng.randint(-1000, 1000, n)
                                .astype(np.int32)).cuda()
        valsf = torch.from_numpy(rng.rand(mp.S * 128)
                                 .astype(np.float32)).cuda()
        valsi = torch.from_numpy(rng.randint(-9, 9, mp.S * 128)
                                 .astype(np.int32)).cuda()
        cases = [
            ("fp32 PLUS fold", srcf, 0.0, dict(fold="PLUS")),
            ("fp32 MIN fold", srcf, inf, dict(fold="MIN")),
            ("fp32 MAX fold", srcf, -inf, dict(fold="MAX")),
            ("fp32 TIMES mul", srcf, 0.0, dict(vals=valsf, mul="TIMES")),
            ("fp32 PLUS mul", srcf, inf, dict(vals=valsf, mul="PLUS")),
            ("int32 MIN fold", srci, imax, dict(fold="MIN")),
            ("int32 MAX fold", srci, imin, dict(fold="MAX")),
            ("int32 PLUS fold", srci, 0, dict(fold="PLUS")),
            ("int32 TIMES mul", srci, 0, dict(vals=valsi, mul="TIMES")),
        ]
        for name, src, fill, kw in cases:
            ck.run(kernel, "small", f"{tag} {name}",
                   lambda: kfn(mp, src, fill, **kw),
                   lambda: M.mono_gather_plain(mp, src, fill, **kw), 0)

    # the cascade: PLUS, MIN and MAX folds, float32 and int32
    n, nnz = 3000, 30000
    rr = np.concatenate([rng.randint(0, 50, nnz // 2),
                         rng.randint(0, n, nnz - nnz // 2)])
    key = np.unique(rr * n + rng.randint(0, n, nnz))
    cp = XSpmvPlan._build(key // n, key % n, np.ones(len(key)), n, n,
                          np.dtype(np.float32)).to("cuda")
    assert len(cp.levels) >= 2
    for dt, folds in ((torch.float32, (("PLUS", 0.0), ("MIN", inf),
                                       ("MAX", -inf))),
                      (torch.int32, (("PLUS", 0), ("MIN", imax),
                                     ("MAX", imin)))):
        cur = torch.from_numpy(rng.randint(-999, 999, cp.m1)).to("cuda", dt)
        for fold, fill in folds:
            def chain():
                c2 = cur
                for lp in cp.levels:
                    c2 = M.mono_gather_plain(lp, c2.reshape(-1), fill,
                                             fold=fold).reshape(-1)
                return M.mono_gather_plain(cp.places[0], c2, fill)
            ck.run("mono_cascade", "small", f"{dt} {fold}",
                   lambda: M.mono_cascade(cp.levels, cp.places[0], cur, fill,
                                          fold), chain, 0)

    g, S = 2, 3
    r_l = S * 128
    x = torch.from_numpy(rng.randint(-99, 99, (g * r_l, 128))
                         .astype(np.int32)).cuda()
    xf = torch.from_numpy(rng.rand(g * r_l, 128).astype(np.float32)).cuda()
    ix = [torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                           .astype(np.int8)).cuda() for _ in range(4)]
    ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                            .astype(np.int8)).cuda()
    ck.run("lane_gather_tdesc", "small", "int32 g=2 r_l=384",
           lambda: P._lane_gather_tdesc(x, ix[0], g, r_l),
           lambda: P._tdesc_plain(x, ix[0], g, r_l), 0)
    for fold, xx in (("MIN", xf), ("MAX", xf), ("PLUS", x), (None, x)):
        ck.run("lane_gather_tasc", "small", f"{xx.dtype} fold={fold}",
               lambda: P._lane_gather_tasc(xx, ix[1], g, r_l, fold),
               lambda: P._tasc_plain(xx, ix[1], g, r_l, fold), 0)
    ck.run("inner3", "small", "int32 g=2 S=3",
           lambda: P._inner3(x, ix[0], ix[1], ssel, ix[2], ix[3], g, S),
           lambda: P._inner3_plain(x, ix[0], ix[1], ssel, ix[2], ix[3], g,
                                   S), 0)
    for xx in (x, xf):
        ck.run("lane_gather", "small", f"{xx.dtype} (768, 128)",
               lambda: P._lane_gather(xx, ix[2]),
               lambda: P._lane_gather_plain(xx, ix[2]), 0)
    for S in (1, 3, 124):
        nsub = 5
        x3 = torch.from_numpy(rng.randint(-99, 99, (nsub, S, 128))
                              .astype(np.int32)).cuda()
        a, c = (torch.from_numpy(rng.randint(0, 128, (nsub * S, 128))
                                 .astype(np.int8)).cuda() for _ in range(2))
        ss = (torch.from_numpy(rng.randint(0, S, (nsub, S, 128))
                               .astype(np.int8)).cuda() if S > 1 else None)
        ck.run("mid_pass", "small", f"int32 nsub={nsub} S={S}",
               lambda: P._mid_pass(x3, a, ss, c),
               lambda: P._mid_pass_plain(x3, a, ss, c), 0)


def lane_gather_isolated(torch, ck, rows):
    """_lane_gather at the bfs18 level-0 shape (rows x 128): no path of
    either package reaches it; beside it torch.gather on a premade int64
    index, the library call that computes the same function."""
    from pygraphblas_tpu_torch.core import perm as P

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(rows, 128).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.randint(0, 128, (rows, 128))
                           .astype(np.int8)).cuda()
    ck.run("lane_gather", "isolated", f"({rows}, 128) fp32",
           lambda: P._lane_gather(x, idx),
           lambda: P._lane_gather_plain(x, idx), x.numel() * (4 + 1 + 4),
           timed=True)
    idx64 = idx.long()
    lib_ms = event_ms(torch, lambda: torch.gather(x, 1, idx64), ck.reps)
    log(f"  library: torch.gather (int64 index) {lib_ms:.4f} ms")
    return lib_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200,
                    help="timed PageRank iterations at kron-20")
    ap.add_argument("--iters21", type=int, default=20,
                    help="timed PageRank iterations at kron-21")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pygraphblas_tpu_torch import _kernels, _native, fused, types
    from pygraphblas_tpu_torch.generators import to_matrix

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    _kernels.lib()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    _native.lib()
    t_gxx = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_kernels.build_log)
    log(f"build: CUDA kernels {t_nvcc:.1f} s (nvcc sm_90a, one process a "
        f"source), benes routing {t_gxx:.1f} s (g++)")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "stack" in line or line.startswith("=="):
            log("  " + line.strip())
    phase_s["build"] = time.perf_counter() - t_start

    ck = Checks(torch, args.reps)
    drv = PathRunner(torch, card)
    sem_pr = types.FP32.PLUS_SECOND
    e2e = {}
    in_path = {}

    def ab(path, run):
        e2e[path]["cascade_ab"] = r = cascade_ab(torch, run)
        k = ck.cascade_vs_chain[path]
        log(f"  {path} cascade vs chain: wall {r['cascade_s']:.6f} vs "
            f"{r['chain_s']:.6f} s (runs {r['runs']}); kernels "
            f"{k['cascade_ms']:.4f} vs {k['chain_ms']:.4f} ms; card {card}")

    def pagerank_path(path, scale, iters, best_of):
        t0 = time.perf_counter()
        rows, cols, n = graph(scale)
        nnz = len(rows)
        A = to_matrix(rows, cols, n, types.FP32)
        t_gen = time.perf_counter() - t0
        log(f"{path}: kron-{scale} ef16 n={n} nnz={nnz} ({t_gen:.1f} s)")
        plan = plan_for(A, True, path)
        per = EXPECTED[path]
        w = torch.from_numpy((np.random.RandomState(1).rand(n) * 1e-6)
                             .astype(np.float32)).cuda()
        check_xspmv_kernels(torch, ck, plan, w, sem_pr, path,
                            timed=[k for k, p in TIMED.items() if p == path])
        if path == "pr20":
            by_levels = cascade_by_levels(torch, ck.reps, plan)
        # correctness: 5 iterations against the planless COO oracle
        r5 = fused.pagerank(A, itermax=5, tol=0.0)
        rows_d, cols_d, _ = A._device_coo("cuda")
        d_inv = fused._d_inv(fused._deg_vec(A, "cuda"), 0.85)
        ref, _, _ = fused._pagerank_loop_coo(rows_d, cols_d, n, 5, d_inv,
                                             np.float32(0.15 / n), 0.0)
        err = float((r5._vals - ref).abs().max())
        scale_r = float(ref.abs().max())
        log(f"  integrity: max |fused - coo| = {err:.3e} (max rank "
            f"{scale_r:.3e}, limit {1e-3 * scale_r:.3e})")
        if not err < 1e-3 * scale_r:
            raise AssertionError(f"{path}: fused pagerank diverges from "
                                 f"the planless oracle by {err}")
        times = []
        for _ in range(best_of):
            t0 = time.perf_counter()
            r = drv.drive(path, lambda: fused.pagerank(A, itermax=iters,
                                                       tol=-1.0), per)
            times.append(time.perf_counter() - t0)
        if r._vals.shape != (n,) or not bool(torch.isfinite(r._vals).all()):
            raise AssertionError(f"{path}: result not finite of shape (n,)")
        el = min(times)
        e2e[path] = dict(ms_per_iteration=el / iters * 1e3,
                         nnz_per_s=nnz * iters / el, iterations=iters,
                         runs_s=times, nnz=nnz, graph_s=t_gen)
        log(f"  {path}: {iters} iterations, best of {best_of} {el:.4f} s "
            f"({times}); {nnz * iters / el:.6e} nnz/s; "
            f"{el / iters * 1e3:.4f} ms/iteration; card {card}")
        in_path[path] = profile_path(
            torch, drv, lambda: fused.pagerank(A, itermax=5, tol=-1.0), path)
        if path == "pr20":
            e2e[path]["cascade_by_levels"] = by_levels
        if per.get("mono_cascade"):
            ab(path, lambda: fused.pagerank(A, itermax=iters, tol=-1.0))
        return A, rows, cols, n

    # 3a. PageRank at kron-20: the first slice's path, now through the
    # cascade
    t0 = time.perf_counter()
    A, rows, cols, n = pagerank_path("pr20", 20, args.iters, 3)
    # yardsticks timed here only: the COO oracle loop (index_add_) and
    # one CSR SpMV of A^T through torch.sparse
    rows_d, cols_d, _ = A._device_coo("cuda")
    d_inv = fused._d_inv(fused._deg_vec(A, "cuda"), 0.85)
    t1 = time.perf_counter()
    fused._pagerank_loop_coo(rows_d, cols_d, n, args.iters, d_inv,
                             np.float32(0.15 / n), -1.0)
    torch.cuda.synchronize()
    coo_ms = (time.perf_counter() - t1) / args.iters * 1e3
    At = torch.sparse_coo_tensor(
        torch.stack([cols_d.long(), rows_d.long()]),
        torch.ones(len(rows), device="cuda"), (n, n)).coalesce() \
        .to_sparse_csr()
    w = torch.rand(n, device="cuda")
    lib_spmv_ms = event_ms(torch, lambda: At @ w, args.reps,
                           behind_sleep=False)
    log(f"  yardsticks: COO index_add_ loop {coo_ms:.4f} ms/iteration; "
        f"torch CSR SpMV (A^T w) {lib_spmv_ms:.4f} ms")
    e2e["pr20"].update(coo_ms_per_iteration=coo_ms,
                       torch_csr_spmv_ms=lib_spmv_ms)
    del A, At, rows_d, cols_d, rows, cols
    phase_s["pr20"] = time.perf_counter() - t0

    # 3b. PageRank at kron-21: level 1 streams, mono_rows, no cascade
    t0 = time.perf_counter()
    A, rows, cols, n = pagerank_path("pr21", 21, args.iters21, 1)
    del A, rows, cols
    phase_s["pr21"] = time.perf_counter() - t0

    # 3c. BFS at kron-18 ef16 BOOL (bench.py:316-350)
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    t0 = time.perf_counter()
    rows, cols, n = graph(18)
    nnz = len(rows)
    A = to_matrix(rows, cols, n, types.BOOL)
    log(f"bfs18: kron-18 ef16 n={n} nnz={nnz}")
    plan = plan_for(A, True, "bfs18")
    per = EXPECTED["bfs18"]
    f0 = torch.zeros(n, device="cuda")
    f0[:: 97] = 1.0
    check_xspmv_kernels(torch, ck, plan, f0, types.FP32.MAX_SECOND, "bfs18",
                        timed=[k for k, p in TIMED.items() if p == "bfs18"])
    lane_lib_ms = lane_gather_isolated(torch, ck, plan.perm.R0)
    srcs = list(range(16))
    fused.bfs_batch(A, srcs)                    # warm
    drv.calls = 0
    t1 = time.perf_counter()
    fused.bfs_batch(A, srcs)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t1
    bfs_calls = drv.calls
    lvb, lv0 = drv.drive("bfs18", lambda: (fused.bfs_batch(A, srcs),
                                           fused.bfs_level(A, 0)), per)
    if not torch.equal(lvb[0].to(torch.int64), lv0._vals):
        raise AssertionError("bfs18: batch[0] != bfs_level(0)")
    G = sp.csr_matrix((np.ones(nnz, np.float32), (rows, cols)), (n, n))
    dist = csgraph.shortest_path(G, directed=True, unweighted=True,
                                 indices=srcs)
    want = np.where(np.isfinite(dist), dist + 1, 0).astype(np.int32)
    got = lvb.cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"bfs18: levels differ from scipy in "
                             f"{int((got != want).sum())} places")
    e2e["bfs18"] = dict(sources=16, seconds=t_batch,
                        edges_per_s=16 * nnz / t_batch,
                        xspmv_calls=bfs_calls,
                        ms_per_xspmv=t_batch / bfs_calls * 1e3,
                        reached_per_source=(got > 0).sum(axis=1).tolist(),
                        depth=int(got.max()))
    log(f"  bfs18: 16 sources {t_batch:.4f} s, {16 * nnz / t_batch:.6e} "
        f"edges/s (K*nnz/s), {bfs_calls} xspmv, "
        f"{t_batch / bfs_calls * 1e3:.4f} ms per xspmv step; levels equal "
        f"scipy's exactly; card {card}")
    in_path["bfs18"] = profile_path(torch, drv,
                                    lambda: fused.bfs_batch(A, srcs), "bfs18")
    ab("bfs18", lambda: fused.bfs_batch(A, srcs))

    # 3d. SSSP at kron-18 ef16, GAP's integer weights 1..255, from the
    # vertex of most out-edges (a third of kron's vertices have none)
    wts = np.random.RandomState(7).randint(1, 256, nnz).astype(np.float32)
    Aw = to_matrix(rows, cols, n, types.FP32, vals=wts)
    s0 = int(np.argmax(np.bincount(rows, minlength=n)))
    log(f"sssp18: kron-18 ef16, FP32 weights 1..255, source {s0}")
    planw = plan_for(Aw, True, "sssp18")
    sem_s = types.FP32.MIN_PLUS
    per = EXPECTED["sssp18"]
    d0 = torch.full((n,), float("inf"), device="cuda")
    d0[:: 89] = 3.0
    check_xspmv_kernels(torch, ck, planw, d0, sem_s, "sssp18")
    fused.sssp(Aw, s0)                          # warm
    t1 = time.perf_counter()
    dv = drv.drive("sssp18", lambda: fused.sssp(Aw, s0), per)
    t_sssp = time.perf_counter() - t1
    s_calls = drv.counts["sssp18"]["xspmv_calls"]
    Gw = sp.csr_matrix((wts, (rows, cols)), (n, n))
    want = csgraph.dijkstra(Gw, directed=True, indices=s0)
    got = dv._vals.cpu().numpy()
    mask = dv._mask.cpu().numpy()
    if not (np.array_equal(mask, np.isfinite(want))
            and np.array_equal(got[mask], want[mask].astype(np.float32))):
        raise AssertionError("sssp18: distances differ from scipy")
    e2e["sssp18"] = dict(source=s0, seconds=t_sssp, xspmv_calls=s_calls,
                         ms_per_xspmv=t_sssp / s_calls * 1e3,
                         edges_per_s=nnz * s_calls / t_sssp,
                         reached=int(mask.sum()))
    log(f"  sssp18: {t_sssp:.4f} s, {s_calls} xspmv, "
        f"{t_sssp / s_calls * 1e3:.4f} ms per step, "
        f"{nnz * s_calls / t_sssp:.6e} nnz/s; distances equal scipy's "
        f"exactly; card {card}")
    ab("sssp18", lambda: fused.sssp(Aw, s0))
    del A, Aw, G, Gw, plan, planw
    phase_s["bfs18+sssp18"] = time.perf_counter() - t0

    # 3e. BC4 at kron-16 symmetrised (bench.py:285-299, 386-401)
    t0 = time.perf_counter()
    rows, cols, n = graph(16, sym=True)
    As = to_matrix(rows, cols, n, types.FP32)
    log(f"bc16: kron-16 symmetrised n={n} nnz={len(rows)}")
    plan_t = plan_for(As, True, "bc16 A^T")
    plan_f = plan_for(As, False, "bc16 A")
    per = EXPECTED["bc16"]
    x0 = torch.from_numpy(np.random.RandomState(3).rand(n)
                          .astype(np.float32)).cuda()
    check_xspmv_kernels(torch, ck, plan_t, x0, sem_pr, "bc16",
                        timed=("mid_pass",))
    srcs = [0, 1, 2, 3]
    fused.bc(As, srcs)                          # warm
    t1 = time.perf_counter()
    cent = drv.drive("bc16", lambda: fused.bc(As, srcs), per)
    t_bc = time.perf_counter() - t1
    ref = fused.bc(As, srcs, device="cpu")
    got, want = cent._vals.cpu(), ref._vals
    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max())
    log(f"  bc16: {t_bc:.4f} s, {drv.counts['bc16']['xspmv_calls']} xspmv; "
        f"max |card - cpu| {err:.3e} (limit {lim:.3e}); card {card}")
    if not err <= lim or not bool(torch.isfinite(got).all()):
        raise AssertionError("bc16: centrality differs from the CPU run")
    e2e["bc16"] = dict(seconds=t_bc, max_abs_err_vs_cpu=err,
                       xspmv_calls=drv.counts["bc16"]["xspmv_calls"])
    ab("bc16", lambda: fused.bc(As, srcs))
    del As, plan_t, plan_f
    phase_s["bc16"] = time.perf_counter() - t0

    # 4. small cases of every kernel (MIN/MAX folds, muls, int32)
    t0 = time.perf_counter()
    log("small cases:")
    check_small_cases(torch, ck)
    phase_s["small"] = time.perf_counter() - t0

    # 5. results
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        timed = [c for c in ck.rows if c["kernel"] == name and c["timed"]
                 and c["path"] == TIMED[name]]
        allc = [c for c in ck.rows if c["kernel"] == name]
        tp = TIMED[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(v["counts"][name] for v in drv.counts.values()),
            launches_by_path={p: v["counts"][name]
                              for p, v in drv.counts.items()
                              if v["counts"][name]},
            launches_per_xspmv=EXPECTED.get(tp, {}).get(name, 0),
            timed_path=tp,
            in_path_ms=in_path.get(tp, {}).get(name),
            max_abs_err=max(c["max_abs_err"] for c in allc),
            ms=sum(c["ms"] for c in timed),
            plain_ms=sum(c["plain_ms"] for c in timed),
            bound_ms=sum(c["bound_ms"] for c in timed),
            bound_by=("bytes" if all(c["bound_by"] == "bytes"
                                     for c in timed) else "operations"),
            library_ms=lane_lib_ms if name == "lane_gather" else None,
            **({"chain_ms": ck.cascade_vs_chain[tp]["chain_ms"]}
               if name == "mono_cascade" else {}),
            checks=f"{sum(c['ok'] for c in allc)}/{len(allc)} exact"))
    with open(os.path.join(OUT_DIR, "chip_smoke_checks.json"), "w") as f:
        json.dump(dict(checks=ck.rows, launches=drv.counts, e2e=e2e,
                       cascade_vs_chain=ck.cascade_vs_chain,
                       phase_s=phase_s), f, indent=1)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log("end to end: " + json.dumps(e2e))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
