"""Run chip_smoke.py's slice-11 paths alone on one card.

    python perf/torch_slice11_paths.py

Builds the kernels, runs the CUDA tests of the slice (``-k "unsigned or
louvain or extract_assign"``), then chip_smoke's repair of the unsigned
selects, ``gkr`` (Kronecker products), ``gx20`` (extract and assign over
index sets at kron-20) and ``glv16`` (Louvain at kron-16 symmetrised,
labels against the CPU run, every ESC launch against its plain
version), each with its seconds, and writes their results to
``chiprun_out/slice11_paths.json``.  A quicker proof of these paths than
the whole chip_smoke; its numbers are the same functions'.  Needs the
card.
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
         "unsigned or louvain or extract_assign"],
        capture_output=True, text=True, cwd=_ROOT)
    print("cuda tests rc", r.returncode, r.stdout[-3000:], r.stderr[-2000:],
          flush=True)
    ck = cs.Checks(torch, 20)
    drv = cs.PathRunner(torch, card)
    res = {}
    t = time.perf_counter()
    res["unsigned"] = len(cs.check_unsigned_selects())
    print("unsigned s", time.perf_counter() - t, flush=True)
    t = time.perf_counter()
    res["gkr"] = cs.gkr_path(torch, drv, card)
    print("gkr s", time.perf_counter() - t, flush=True)
    t = time.perf_counter()
    rows, cols, n = cs.graph(20)
    A = to_matrix(rows, cols, n, types.FP32)
    print("kron-20 graph s", time.perf_counter() - t, flush=True)
    del rows, cols
    t = time.perf_counter()
    res["gx20"] = cs.gx20_path(torch, drv, card, A, n)
    print("gx20 s", time.perf_counter() - t, flush=True)
    del A
    t = time.perf_counter()
    res["glv16"] = cs.glv16_path(torch, ck, drv, card,
                                 *cs.graph(16, sym=True))
    print("glv16 s", time.perf_counter() - t, flush=True)
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "slice11_paths.json"),
              "w") as f:
        json.dump(dict(res=res, counts=drv.counts, card=card), f, indent=1,
                  default=str)
    print("total", time.perf_counter() - t_all, flush=True)
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
