"""Run chip_smoke.py's slice-15 paths (user-defined and newly coded
operators in segfold and pair_fold) alone on one card.

    python perf/torch_slice15_paths.py

Builds the kernels and LogSum32's generated unit (each timed), then runs
chip_smoke's ``check_algebra_codes`` (segfold and pair_fold at every
code the algebra adds, the new muls POW .. COPYSIGN among them), ``sr16``
(with FP32 MIN_ATAN2 and INT32 MAX_BXOR), ``gudf14`` and ``gudf16`` on
tc16's L, and writes the check rows, launches and results to
``chiprun_out/slice15_paths.json``.  A quicker proof of these paths than
the whole chip_smoke; its numbers are the same functions'.  Needs the
card.
"""

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pygraphblas_tpu_torch import _kernels, _opgen  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = cs.card_line()
    print("card", card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    _kernels.lib()
    print(f"build {time.perf_counter() - t:.1f} s; seconds a source "
          f"{_kernels.build_seconds}", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    ck = cs.Checks(torch, 20)
    drv = cs.PathRunner(torch, card)
    res, phase_s = {}, {}
    L = cs.degree_lower(*cs.graph(16, sym=True))
    for name, run in (
            ("codes", lambda: cs.check_algebra_codes(torch, ck)),
            ("sr16", lambda: cs.sr16_path(torch, ck, drv, card, L)),
            ("gudf14", lambda: cs.gudf14_path(torch, ck, drv, card)),
            ("gudf16", lambda: cs.gudf16_path(torch, ck, drv, card, L))):
        t = time.perf_counter()
        res[name] = run()
        phase_s[name] = time.perf_counter() - t
        print(f"{name} {phase_s[name]:.1f} s", flush=True)
    print(f"generated builds {_opgen.build_seconds}; unlowered "
          f"{_kernels.unlowered}", flush=True)
    kernels = cs.generated_entries(ck, drv)
    print(json.dumps({"kernels": kernels}), flush=True)
    with open(os.path.join(cs.OUT_DIR, "slice15_paths.json"), "w") as f:
        json.dump(dict(res=res, phase_s=phase_s, counts=drv.counts,
                       checks=ck.rows, kernels=kernels, card=card,
                       gen_build_seconds=_opgen.build_seconds), f, indent=1,
                  default=str)
    print("total", time.perf_counter() - t_all, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
