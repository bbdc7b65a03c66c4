"""Run chip_smoke.py's slice-14 phase (the user-facing entry points)
alone on one card.

    python perf/torch_slice14_paths.py

Builds the kernels, then runs chip_smoke's ``gallery_phase``:
``run_doctests()`` on the card, every demo_torch script, the
GraphChallenge harness (synthetic, and a small dataset in the
challenge's layout), gap_torch/bcmark.py at its defaults and
gap_torch/prmark.py at kron-18 with its xspmv launches checked, each
with its seconds and hand-kernel launches, and writes the records to
``chiprun_out/slice14_paths.json``.  A quicker proof of these entry
points than the whole chip_smoke; its numbers are the same functions'.
Needs the card.
"""

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pygraphblas_tpu_torch import _kernels, _native  # noqa: E402


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
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    drv = cs.PathRunner(torch, card)
    t = time.perf_counter()
    res = cs.gallery_phase(torch, drv, card)
    phase_s = time.perf_counter() - t
    print(f"gallery phase {phase_s:.1f} s", flush=True)
    with open(os.path.join(cs.OUT_DIR, "slice14_paths.json"), "w") as f:
        json.dump(dict(res=res, phase_s=phase_s, counts=drv.counts,
                       card=card), f, indent=1, default=str)
    print("total", time.perf_counter() - t_all, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
