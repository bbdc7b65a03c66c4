#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pygraphblas_tpu_torch) on one card.

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. the build: the CUDA kernels (nvcc, sm_90a) and the native Benes
     routing (g++), from the sources in this checkout;
  3. the graph (RMAT kron, scale 20, edgefactor 16) and its transposed
     FP32 xspmv plan;
  4. each hand-written kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it, plus small MIN-fold,
     TIMES-mul and int32 cases;
  5. the main path: fused.pagerank, checked against the planless COO
     oracle, then timed (best of 3 runs of 200 iterations), with the
     launch counters reset just before each run and read just after,
     and profiled over 10 iterations (device time by kernel);
  6. one JSON line of kernel results, the card line, and the final
     {"ok": true, "device": ...} line.

Kernel times ("ms", "plain_ms") come from CUDA events around
back-to-back calls at the main path's shapes, queued behind a sleep
kernel so that the host's launch path is not timed; for mono_span they
are the sum over its 8 plans, i.e. per iteration.  "in_path_ms" is each
kernel's device time per iteration inside the main path (torch.profiler
over 10 iterations).  "bound_ms" is the larger of the bytes moved once
over the HBM rate and the fold/mul operations over the float32 rate.

Run:  python3 chip_smoke.py [--scale 20] [--iters 200]
Logs too long for the terminal (nvcc -Xptxas -v, profiler tables) go to
chiprun_out/.
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
    "lane_gather_tdesc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                          "pygraphblas_tpu/core/perm.py:577"),
    "inner3": ("pygraphblas_tpu_torch/csrc/perm.cu",
               "pygraphblas_tpu/core/perm.py:741"),
    "lane_gather_tasc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                         "pygraphblas_tpu/core/perm.py:642"),
}


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

    def run(self, kernel, case, kfn, pfn, nbytes, exact, main_path=True,
            rtol=1e-6, ops=0):
        torch = self.torch
        got = kfn()
        want = pfn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel}/{case}: shape/dtype "
                                 f"{tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        scale = float(want.double().abs().max()) if want.numel() else 0.0
        if exact:
            ok = bool(torch.equal(got, want))
            tol = "exact"
        else:
            ok = err <= rtol * scale
            tol = f"{rtol:g} x max|ref| = {rtol * scale:.3e}"
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        row = dict(kernel=kernel, case=case, shape=list(got.shape),
                   dtype=str(got.dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, ok=ok, main_path=main_path,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        if main_path:
            row["ms"] = event_ms(torch, kfn, self.reps)
            row["plain_ms"] = event_ms(torch, pfn, self.reps)
        self.rows.append(row)
        log(f"  {kernel:18s} {case:22s} err={err:.3e} tol={tol} "
            f"{'ok' if ok else 'FAIL'}"
            + (f"  {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
               f"bound {row['bound_ms']:.4f} ms)" if main_path else ""))
        if not ok:
            raise AssertionError(f"{kernel}/{case} disagrees with its "
                                 f"plain version: max err {err}")
        return got


def mono_bytes(plan, src_len, fold, mul):
    S = plan.S
    out = (S // 8 if fold else S) * 128 * 4
    return (S * 128 * 2 + (S // 8) * 4 + min(src_len, plan.src_n) * 4
            + out + (S * 128 * 4 if mul else 0))


def check_main_path_kernels(torch, ck, plan, n):
    """Run one xspmv's worth of kernel inputs through each kernel and its
    plain version, at the main path's shapes."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P

    rng = np.random.RandomState(1)
    w = torch.from_numpy(
        (rng.rand(n) * 1e-6).astype(np.float32)).cuda()
    fill = np.float32(0.0)

    def mono_case(name, mp, src, fold=None):
        return ck.run("mono_span", name,
                      lambda: M.mono_span(mp, src, fill, fold=fold),
                      lambda: M.mono_gather_plain(mp, src, fill, fold=fold),
                      mono_bytes(mp, src.numel(), fold, False),
                      exact=fold is None,
                      ops=mp.S // 8 * 128 * 7 if fold else 0)

    xc = mono_case("pre", plan.pre, w).reshape(-1)
    prod = mono_case("decode", plan.decode, xc).reshape(-1)

    pp = plan.perm
    D, S, R0, K = pp.D, pp.S, pp.R0, pp.K
    if not (D >= 3 and K == 128 and S <= 24 and pp.n % 1024 == 0):
        raise AssertionError(f"main-path permutation D={D} S={S} K={K} "
                             "does not take the fused kernels")
    xe = torch.cat([prod, torch.full((R0 * K - prod.numel(),), 0.0,
                                     device=prod.device)]).reshape(R0, 128)
    cur = xe.contiguous()
    cell = 4 + 1                     # fp32 value + int8 lane index
    shapes = []
    for lvl in range(D - 1):
        r_l = R0 // 128 ** lvl
        g = cur.shape[0] // r_l
        shapes.append((g, r_l))
        if lvl == D - 2:
            break
        x_in, a = cur, pp.a_stages[lvl]
        cur = ck.run("lane_gather_tdesc", f"level{lvl} g={g} r_l={r_l}",
                     lambda: P._lane_gather_tdesc(x_in, a, g, r_l),
                     lambda: P._tdesc_plain(x_in, a, g, r_l),
                     x_in.numel() * (cell + 4), exact=True)
    g, r_l = shapes[-1]
    x_in = cur
    args = (pp.a_stages[D - 2], pp.a_stages[D - 1], pp.ssel,
            pp.c_stages[D - 1], pp.c_stages[D - 2], g, S)
    cur = ck.run("inner3", f"g={g} S={S}",
                 lambda: P._inner3(x_in, *args),
                 lambda: P._inner3_plain(x_in, *args),
                 x_in.numel() * (4 + 5 + 4), exact=True)
    for lvl in range(D - 3, -1, -1):
        g, r_l = shapes[lvl]
        x_in, c = cur, pp.c_stages[lvl]
        fold = "PLUS" if lvl == 0 else None
        nout = x_in.numel() // 8 if fold else x_in.numel()
        cur = ck.run("lane_gather_tasc",
                     f"level{lvl} g={g} r_l={r_l}" + (" fold8" if fold
                                                      else ""),
                     lambda: P._lane_gather_tasc(x_in, c, g, r_l, fold),
                     lambda: P._tasc_plain(x_in, c, g, r_l, fold),
                     x_in.numel() * cell + nout * 4, exact=fold is None,
                     ops=nout * 7 if fold else 0)
    cur = cur.reshape(-1)[:plan.m1]
    for i, lp in enumerate(plan.levels):
        cur = mono_case(f"level{i + 1} fold", lp, cur, fold="PLUS")
        cur = cur.reshape(-1)
    mono_case("place", plan.places[0], cur)


def check_small_cases(torch, ck):
    """MIN fold, TIMES mul and int32 at small sizes (not timed)."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P

    rng = np.random.RandomState(2)
    src_n = 9000
    idx = np.sort(rng.randint(0, src_n, 64 * 128))
    idx[::11] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    mp = M.MonoPlan.build(idx, src_n).to("cuda")
    assert mp.wva > 0
    srcf = torch.from_numpy(rng.rand(src_n).astype(np.float32)).cuda()
    srci = torch.from_numpy(rng.randint(-1000, 1000, src_n)
                            .astype(np.int32)).cuda()
    valsf = torch.from_numpy(rng.rand(mp.S * 128).astype(np.float32)).cuda()
    valsi = torch.from_numpy(rng.randint(-9, 9, mp.S * 128)
                             .astype(np.int32)).cuda()
    inf = np.float32(np.inf)
    imax = np.int32(np.iinfo(np.int32).max)
    cases = [
        ("fp32 MIN fold", srcf, inf, dict(fold="MIN"), False),
        ("fp32 TIMES mul", srcf, 0.0, dict(vals=valsf, mul="TIMES"), False),
        ("int32 MIN fold", srci, imax, dict(fold="MIN"), True),
        ("int32 PLUS fold", srci, 0, dict(fold="PLUS"), True),
        ("int32 TIMES mul", srci, 0, dict(vals=valsi, mul="TIMES"), True),
    ]
    for name, src, fill, kw, exact in cases:
        ck.run("mono_span", name,
               lambda: M.mono_span(mp, src, fill, **kw),
               lambda: M.mono_gather_plain(mp, src, fill, **kw),
               0, exact=exact, main_path=False)
    g, S = 2, 3
    r_l = S * 128
    x = torch.from_numpy(rng.randint(-99, 99, (g * r_l, 128))
                         .astype(np.int32)).cuda()
    xf = torch.from_numpy(rng.rand(g * r_l, 128).astype(np.float32)).cuda()
    ix = [torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                           .astype(np.int8)).cuda() for _ in range(4)]
    ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                            .astype(np.int8)).cuda()
    ck.run("lane_gather_tdesc", "int32 g=2 r_l=384",
           lambda: P._lane_gather_tdesc(x, ix[0], g, r_l),
           lambda: P._tdesc_plain(x, ix[0], g, r_l), 0, True, False)
    for fold, xx, exact in (("MIN", xf, True), ("PLUS", x, True),
                            (None, x, True)):
        ck.run("lane_gather_tasc", f"{xx.dtype} fold={fold}",
               lambda: P._lane_gather_tasc(xx, ix[1], g, r_l, fold),
               lambda: P._tasc_plain(xx, ix[1], g, r_l, fold), 0, exact,
               False)
    ck.run("inner3", "int32 g=2 S=3",
           lambda: P._inner3(x, ix[0], ix[1], ssel, ix[2], ix[3], g, S),
           lambda: P._inner3_plain(x, ix[0], ix[1], ssel, ix[2], ix[3], g,
                                   S), 0, True, False)
    y = torch.from_numpy(rng.rand(2 * 128, 128).astype(np.float32)).cuda()
    ck.run("inner3", "fp32 g=2 S=1",
           lambda: P._inner3(y, ix[0][:256], ix[1][:256], None,
                             ix[2][:256], ix[3][:256], 2, 1),
           lambda: P._inner3_plain(y, ix[0][:256], ix[1][:256], None,
                                   ix[2][:256], ix[3][:256], 2, 1),
           0, True, False)


# kernel symbol prefix in a profile -> kernel name
_SYMBOLS = {"mono_span_kernel": "mono_span", "tdesc_kernel":
            "lane_gather_tdesc", "tasc_kernel": "lane_gather_tasc",
            "inner3_kernel": "inner3"}


def profile_main_path(torch, run, iters, wall_ms_per_iter):
    """Device time by kernel over `iters` main-path iterations, and the
    device's busy share against the timed wall time per iteration."""
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    cuda = torch.autograd.DeviceType.CUDA
    per_kernel = {k: 0.0 for k in _SYMBOLS.values()}
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
    dev_ms = (sum(per_kernel.values()) + other) / 1e3 / iters
    log(f"profile ({iters} iterations): device {dev_ms:.4f} ms/iteration "
        f"of {wall_ms_per_iter:.4f} ms wall (busy share "
        f"{dev_ms / wall_ms_per_iter:.3f})")
    for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        log(f"  {k:18s} {us / 1e3 / iters:.4f} ms/iteration")
    log(f"  {'other (torch ops)':18s} {other / 1e3 / iters:.4f} "
        "ms/iteration")
    return {k: us / 1e3 / iters for k, us in per_kernel.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pygraphblas_tpu_torch import _kernels, _native, fused, types
    from pygraphblas_tpu_torch.generators import rmat_edges, to_matrix

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

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
    log(f"build: CUDA kernels {t_nvcc:.1f} s (nvcc sm_90a), "
        f"benes routing {t_gxx:.1f} s (g++)")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    # 3. graph + plan
    t0 = time.perf_counter()
    rows, cols, n = rmat_edges(args.scale, args.edgefactor)
    nnz = len(rows)
    A = to_matrix(rows, cols, n, types.FP32)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = A._xspmv_plan(True, np.float32, device="cuda")
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    pp = plan.perm
    log(f"graph: kron-{args.scale} ef{args.edgefactor} n={n} nnz={nnz} "
        f"({t_gen:.1f} s); plan {t_plan:.1f} s: n_perm={plan.n_perm} "
        f"D={pp.D} S={pp.S} R0={pp.R0} K={pp.K} levels={len(plan.levels)}")
    for name, mp in ([("pre", plan.pre), ("decode", plan.decode)]
                     + [(f"level{i + 1}", lp)
                        for i, lp in enumerate(plan.levels)]
                     + [("place", plan.places[0])]):
        log(f"  plan {name:8s} S={mp.S} src_n={mp.src_n} wva={mp.wva} "
            f"stream={mp.stream}")

    # 4. kernels against their plain versions
    log("kernels vs plain versions on the card:")
    ck = Checks(torch, args.reps)
    check_main_path_kernels(torch, ck, plan, n)
    check_small_cases(torch, ck)

    # 5. the main path
    t0 = time.perf_counter()
    r = fused.pagerank(A, itermax=args.iters, tol=-1.0)
    torch.cuda.synchronize()
    log(f"warmup: {time.perf_counter() - t0:.2f} s")
    r5 = fused.pagerank(A, itermax=5, tol=0.0)
    rows_d, cols_d, _ = A._device_coo("cuda")
    d_inv = fused._d_inv(fused._deg_vec(A, "cuda"), 0.85)
    ref, _, _ = fused._pagerank_loop_coo(rows_d, cols_d, n, 5, d_inv,
                                         np.float32(0.15 / n), 0.0)
    err = float((r5._vals - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"integrity: max |fused - coo| = {err:.3e} (max rank {scale:.3e}, "
        f"limit {1e-3 * scale:.3e})")
    if not err < 1e-3 * scale:
        raise AssertionError("fused pagerank diverges from the planless "
                             f"oracle by {err}")
    if r._vals.shape != (n,) or not bool(torch.isfinite(r._vals).all()):
        raise AssertionError("pagerank result is not finite of shape (n,)")

    expected = {"mono_span": 3 + len(plan.levels), "lane_gather_tdesc":
                pp.D - 2, "inner3": 1, "lane_gather_tasc": pp.D - 2}
    times, counts = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        fused.pagerank(A, itermax=args.iters, tol=-1.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run_counts = dict(_kernels.launches)
        if counts is not None and run_counts != counts:
            raise AssertionError(f"launch counts vary: {run_counts}")
        counts = run_counts
    elapsed = min(times)
    log(f"pagerank kron-{args.scale} ef{args.edgefactor}: {args.iters} "
        f"iterations best of 3 {elapsed:.4f} s ({times}); "
        f"{nnz * args.iters / elapsed:.6e} nnz/s; "
        f"{elapsed / args.iters * 1e3:.4f} ms/iteration; card {card}")
    for k, c in counts.items():
        per = c / args.iters
        k_ms = sum(r["ms"] for r in ck.rows if r["kernel"] == k
                   and r["main_path"])
        log(f"  launches {k}: {c} ({per:g} per iteration, expected "
            f"{expected[k]}); {k_ms:.4f} ms per iteration (CUDA events); "
            f"card {card}")
        if c == 0 or per != expected[k]:
            raise AssertionError(f"kernel {k} launched {c} times in "
                                 f"{args.iters} iterations")

    # yardsticks timed here only: the COO oracle loop (index_add_) and
    # one cuSPARSE CSR SpMV of A^T
    t0 = time.perf_counter()
    fused._pagerank_loop_coo(rows_d, cols_d, n, args.iters, d_inv,
                             np.float32(0.15 / n), -1.0)
    torch.cuda.synchronize()
    coo_s = time.perf_counter() - t0
    At = torch.sparse_coo_tensor(
        torch.stack([cols_d.long(), rows_d.long()]),
        torch.ones(nnz, device="cuda"), (n, n)).coalesce().to_sparse_csr()
    w = r._vals.contiguous()
    lib_spmv_ms = event_ms(torch, lambda: At @ w, args.reps,
                           behind_sleep=False)
    log(f"yardsticks: COO index_add_ loop {coo_s / args.iters * 1e3:.4f} "
        f"ms/iteration; torch CSR SpMV (A^T w) {lib_spmv_ms:.4f} ms")

    in_path = profile_main_path(
        torch, lambda: fused.pagerank(A, itermax=10, tol=-1.0), 10,
        elapsed / args.iters * 1e3)

    # 6. results
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        main = [c for c in ck.rows if c["kernel"] == name and c["main_path"]]
        allc = [c for c in ck.rows if c["kernel"] == name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], in_path_ms=in_path[name],
            max_abs_err=max(c["max_abs_err"] for c in main),
            ms=sum(c["ms"] for c in main),
            plain_ms=sum(c["plain_ms"] for c in main),
            bound_ms=sum(c["bound_ms"] for c in main),
            bound_by=("bytes" if all(c["bound_by"] == "bytes" for c in main)
                      else "operations"),
            library_ms=None,
            checks=f"{sum(c['ok'] for c in allc)}/{len(allc)} ok"))
    with open(os.path.join(OUT_DIR, "chip_smoke_checks.json"), "w") as f:
        json.dump(ck.rows, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
