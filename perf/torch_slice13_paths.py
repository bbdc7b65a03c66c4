"""Run chip_smoke.py's slice-13 paths (the distributed tier) alone on one
card.

    python perf/torch_slice13_paths.py

Builds the kernels (the yardsticks run on them), runs the CUDA tests of
the distributed tier (``-k world_of_one``), builds chip_smoke's graphs
and yardsticks (kron-20 with its xspmv plan and fused.pagerank's 20
iterations, kron-18 with algorithms.sssp and bfs_level_vxm from
213,770, kron-16 symmetrised with its triangle count), then runs
chip_smoke's ``gd_phase``: gdpr20, gdsp18, gdtc16, gdmxv and gdckpt in a
world of one over NCCL, each with its seconds, and writes their results
to ``chiprun_out/slice13_paths.json``.  A quicker proof of these paths
than the whole chip_smoke; its numbers are the same functions'.  Needs
the card.
"""

import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pygraphblas_tpu_torch import (_kernels, _native, algorithms,  # noqa: E402
                                   fused, types)
from pygraphblas_tpu_torch.generators import to_matrix  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = cs.card_line()
    print("card", card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    _kernels.lib()
    _native.lib()
    print("build", time.perf_counter() - t, flush=True)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m",
         "cuda", "-q", "--noconftest", "-p", "no:cacheprovider", "-k",
         "world_of_one"], capture_output=True, text=True, cwd=_ROOT)
    print("cuda tests rc", r.returncode, r.stdout[-3000:], r.stderr[-2000:],
          flush=True)
    drv = cs.PathRunner(torch, card)
    secs = {}

    def step(name, call):
        t = time.perf_counter()
        out = call()
        secs[name] = time.perf_counter() - t
        print(f"{name} s {secs[name]:.1f}", flush=True)
        return out

    kron20 = step("kron-20 graph", lambda: cs.graph(20))
    A = to_matrix(*kron20[:2], kron20[2], types.FP32)
    step("kron-20 plan", lambda: cs.plan_for(A, True, "pr20"))
    ref = step("fused.pagerank 20", lambda: fused.pagerank(
        A, itermax=20, tol=-1.0)._vals.cpu().numpy())
    t = time.perf_counter()
    fused.pagerank(A, itermax=20, tol=-1.0)
    torch.cuda.synchronize()
    pr20_ms = (time.perf_counter() - t) / 20 * 1e3
    del A
    kron18 = step("kron-18 graph", lambda: cs.graph(18))
    rows, cols, n = kron18
    wts = np.random.RandomState(7).randint(1, 256, len(rows)).astype(
        np.float32)
    s0 = int(np.argmax(np.bincount(rows, minlength=n)))
    B = to_matrix(rows, cols, n, types.BOOL)
    Bw = to_matrix(rows, cols, n, types.FP32, vals=wts)
    gsp18 = step("gsp18 yardsticks", lambda: (
        algorithms.sssp(Bw, s0), algorithms.bfs_level_vxm(B, s0)))
    kron16s = step("kron-16 graph", lambda: cs.graph(16, sym=True))
    tc16 = step("tc16 count", lambda: int(algorithms.triangle_count(
        to_matrix(*kron16s[:2], kron16s[2], types.INT64))))
    res, path_s = step("gd_phase", lambda: cs.gd_phase(
        torch, drv, card, kron20, ref, pr20_ms, kron18, wts, s0, gsp18,
        kron16s, tc16))
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "slice13_paths.json"),
              "w") as f:
        json.dump(dict(res=res, path_s=path_s, secs=secs, pr20_ms=pr20_ms,
                       counts=drv.counts, card=card), f, indent=1,
                  default=str)
    print("total", time.perf_counter() - t_all, flush=True)
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
