"""GAP-scale end to end on the port: a fresh urand graph -> PageRank,
from first touch to converged ranks through the async plan (the twin of
``perf/urand_e2e.py``).

A fresh n = 2^scale uniform random graph (GAP's urand class) is loaded
and ``fused.pagerank`` runs at once on the planless COO loop while the
xspmv plan builds in a background thread (``spmv_plan_async``); once the
plan lands, the later runs take the xspmv kernels.  Every phase's
seconds are reported, the first touch also without the build running
beside it (the same COO loop again once the plan has landed), and the
tier that served each run is printed beside its seconds.

Gates (exit 1 when one fails): the two tiers' ranks within 1e-5 of each
other (the twin's gate), the ranks within 1e-3 x the largest rank of the
planless COO oracle (bench.py's gate), and a plan that lands within
``--plan-wait`` without an error.

    python perf/torch_urand_e2e.py [--scale 22] [--iters 50] [--seed S]
        [--device cuda|cpu]

The default seed is time-derived, so the plan is cold; under a fixed
seed the plan's cache file (``XSpmvPlan.cache_path``) is deleted first.
Prints one JSON line at the end.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=None,
                    help="default: time-derived, so every run is a fresh "
                         "graph (cold plan)")
    ap.add_argument("--plan-wait", type=float, default=3600,
                    help="max seconds to wait for the background plan")
    ap.add_argument("--device", default="cuda")
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plan_shape(plan):
    """The plan's shape, as chip_smoke's plan_for logs it: the Benes
    permutation's D, S, R0, K, the fold levels, and each MonoPlan's
    encoding (resident span or streamed per-row windows)."""
    pp = plan.perm
    mono = {}
    for name, mp in ([("pre", plan.pre), ("decode", plan.decode)]
                     + [(f"level{i + 1}", lp)
                        for i, lp in enumerate(plan.levels)]
                     + [("place", plan.places[0])]):
        mono[name] = dict(S=int(mp.S), wva=int(mp.wva), blk=int(mp.blk),
                          xb=int(mp.xb), max_w=int(mp.max_w),
                          stream=bool(mp.stream), ok=bool(mp.ok))
    return dict(n_perm=int(plan.n_perm), D=int(pp.D), S=int(pp.S),
                R0=int(pp.R0), K=int(pp.K), levels=len(plan.levels),
                mono=mono)


def run(args, state=None):
    """The phases of `args` (``parser()``'s options); returns the result
    dict (the JSON line).  Raises AssertionError when a gate fails.  A
    `state` dict, when given, gets the matrix ("A") and the warm run's
    ranks ("ranks")."""
    from pygraphblas_tpu_torch import fused, types
    from pygraphblas_tpu_torch._device import resolve_device
    from pygraphblas_tpu_torch.base import config, options_set
    from pygraphblas_tpu_torch.core.xspmv import XSpmvPlan
    from pygraphblas_tpu_torch.generators import to_matrix, urand_edges

    dev = resolve_device(args.device)
    seed = args.seed if args.seed is not None else int(time.time()) % 100000
    res = dict(scale=args.scale, edgefactor=args.edgefactor,
               iters=args.iters, seed=seed, device=str(dev))
    wall0 = time.perf_counter()

    t0 = time.perf_counter()
    rows, cols, n = urand_edges(args.scale, args.edgefactor, seed=seed)
    res["gen_s"] = time.perf_counter() - t0
    res["n"], res["nnz"] = n, len(rows)
    print(f"# urand s{args.scale}: n={n} nnz={len(rows)} gen "
          f"{res['gen_s']:.2f}s", flush=True)

    t0 = time.perf_counter()
    A = to_matrix(rows, cols, n, types.FP32, device=dev)
    A._flush()
    res["build_s"] = time.perf_counter() - t0
    if state is not None:
        state["A"] = A
    del rows, cols
    # y = A^T w: the plan of the transposed pattern
    r, c, v = A._coo()
    path = XSpmvPlan.cache_path(c, r, v, n, n, np.dtype(np.float32))
    res["plan_cache_file_removed"] = bool(path and os.path.exists(path))
    if res["plan_cache_file_removed"]:
        os.remove(path)

    saved = config.spmv_plan_async
    options_set(spmv_plan_async=True)
    hkey = ("x", True, np.dtype(np.float32).str)
    cache = A._cache()
    try:
        def timed_pr():
            t0 = time.perf_counter()
            out = fused.pagerank(A, itermax=args.iters, tol=-1.0,
                                 device=dev)
            _sync(dev)
            return time.perf_counter() - t0, out

        def engine():
            return "xspmv" if hkey + (str(dev),) in cache else "coo"

        # first touch: the planless COO loop starts at once, the plan
        # builds in its thread
        t_plan0 = time.perf_counter()
        t_first, r1 = timed_pr()
        res["first_engine"] = engine()
        res["first_pr_s"] = t_first
        res["e2e_first_s"] = time.perf_counter() - wall0
        res["first_nnz_per_s"] = res["nnz"] * args.iters / t_first
        building = ("xbuilding",) + hkey in cache
        res["plan_building_after_first"] = building
        print(f"# first-touch pagerank ({res['first_engine']} tier): "
              f"{t_first:.4f}s, plan build still running: {building}; "
              f"end to end {res['e2e_first_s']:.2f}s from the start",
              flush=True)

        t0 = time.perf_counter()
        while hkey not in cache and ("xerror",) + hkey not in cache:
            if time.perf_counter() - t0 > args.plan_wait:
                break
            time.sleep(0.05)
        res["plan_wait_s"] = time.perf_counter() - t0
        res["plan_build_s"] = time.perf_counter() - t_plan0
        if ("xerror",) + hkey in cache:
            raise AssertionError(f"the plan build failed: "
                                 f"{cache[('xerror',) + hkey]!r}")
        if hkey not in cache:
            raise AssertionError(f"the plan did not land within "
                                 f"{args.plan_wait} s")
        res["plan"] = plan_shape(cache[hkey])
        print(f"# plan landed {res['plan_build_s']:.2f}s after the first "
              f"touch began: {json.dumps(res['plan'])}", flush=True)

        # the first touch's loop again with no build beside it
        rows_d, cols_d, _ = A._device_coo(dev)
        d_inv = fused._d_inv(fused._deg_vec(A, dev), 0.85)
        tele = np.float32(0.15 / n)
        t0 = time.perf_counter()
        ref, _, _ = fused._pagerank_loop_coo(rows_d, cols_d, n, args.iters,
                                             d_inv, tele, -1.0)
        _sync(dev)
        res["coo_quiet_s"] = time.perf_counter() - t0
        print(f"# the COO loop alone (no build running): "
              f"{res['coo_quiet_s']:.4f}s", flush=True)

        t_up, r2 = timed_pr()           # the plan's upload and first run
        res["upgraded_engine"] = engine()
        t_warm, r2 = timed_pr()
        res["upgraded_first_s"] = t_up
        res["warm_pr_s"] = t_warm
        res["warm_engine"] = engine()
        res["warm_nnz_per_s"] = res["nnz"] * args.iters / t_warm
        print(f"# upgraded pagerank ({res['upgraded_engine']} tier): first "
              f"{t_up:.4f}s, warm {t_warm:.4f}s ({res['warm_engine']})",
              flush=True)
    finally:
        options_set(spmv_plan_async=saved)

    if res["first_engine"] != "coo" or res["warm_engine"] != "xspmv":
        raise AssertionError(f"tiers: first {res['first_engine']}, warm "
                             f"{res['warm_engine']} (want coo, xspmv)")
    err = float((r1._vals - r2._vals).abs().max())
    res["tier_max_diff"] = err
    oracle = float((r2._vals - ref).abs().max())
    scale_r = float(ref.abs().max())
    res["oracle_max_diff"], res["max_rank"] = oracle, scale_r
    ok = bool(torch.isfinite(r2._vals).all()) and r2._vals.shape == (n,)
    if state is not None:
        state["ranks"] = r2
    if not (ok and err < 1e-5 and oracle < 1e-3 * scale_r):
        raise AssertionError(f"gates: tiers differ by {err} (limit 1e-5), "
                             f"the oracle by {oracle} (limit "
                             f"{1e-3 * scale_r}), finite {ok}")
    return res


def main(argv=None):
    try:
        res = run(parser().parse_args(argv))
    except AssertionError as e:
        print(f"# FAILED: {e}", flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
