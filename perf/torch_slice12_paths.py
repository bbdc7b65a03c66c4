"""Run chip_smoke.py's slice-12 paths alone on one card.

    python perf/torch_slice12_paths.py

Builds the kernels, runs the CUDA tests of the slice (``-k "uint64 or
frontier or fused_dnn"``), then chip_smoke's repair of the unsigned
selects (the UINT64 user predicate among them), ``gbfs18`` (the
direction-optimised BFS and the BFS parents on kron-18, after its
xspmv plan is built and checked), ``gio`` (MatrixMarket at kron-18, the
binary checkpoint at kron-20), ``groad`` (the
frontier BFS on the 4096 x 4096 lattice), ``gdnn1024`` (the dense DNN
at 1024 neurons, 120 layers, 60,000 images) and ``gdnn_coo`` (the
COO-tier DNN at chip_smoke's ``DNN_COO_IMAGES``), each with its seconds, and writes their
results to ``chiprun_out/slice12_paths.json``.  A quicker proof of these
paths than the whole chip_smoke; its numbers are the same functions'.
Needs the card.
"""

import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pygraphblas_tpu_torch import _kernels, _native, types  # noqa: E402
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
         "uint64 or frontier or fused_dnn"],
        capture_output=True, text=True, cwd=_ROOT)
    print("cuda tests rc", r.returncode, r.stdout[-3000:], r.stderr[-2000:],
          flush=True)
    ck = cs.Checks(torch, 20)
    drv = cs.PathRunner(torch, card)
    res, secs = {}, {}

    def step(name, call):
        t = time.perf_counter()
        out = call()
        secs[name] = time.perf_counter() - t
        print(f"{name} s {secs[name]:.1f}", flush=True)
        return out

    res["unsigned"] = step("unsigned", lambda: len(cs.check_unsigned_selects()))
    rows, cols, n = step("kron-18 graph", lambda: cs.graph(18))
    A = to_matrix(rows, cols, n, types.BOOL)
    step("bfs18 plan", lambda: cs.plan_for(A, True, "bfs18"))
    res["gbfs18"] = step("gbfs18", lambda: cs.gbfs18_path(
        torch, ck, drv, card, A, rows, cols, n))
    res["gio_mm"] = step("gio mm", lambda: cs.gio_mm(torch, drv, card, A))
    del A, rows, cols
    rows, cols, n = step("kron-20 graph", lambda: cs.graph(20))
    A = to_matrix(rows, cols, n, types.FP32)
    del rows, cols
    res["gio_binfile"] = step("gio binfile", lambda: cs.gio_binfile(
        torch, drv, card, A))
    del A
    res["groad"] = step("groad", lambda: cs.groad_path(torch, drv, card))
    res["gdnn1024"] = step("gdnn1024", lambda: cs.gdnn1024_path(
        torch, drv, card))
    res["gdnn_coo"] = step("gdnn_coo", lambda: cs.gdnn_coo_path(
        torch, ck, drv, card, cs.DNN_COO_IMAGES))
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "slice12_paths.json"),
              "w") as f:
        json.dump(dict(res=res, secs=secs, counts=drv.counts, card=card,
                       checks=[c for c in ck.rows]), f, indent=1,
                  default=str)
    print("total", time.perf_counter() - t_all, flush=True)
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
