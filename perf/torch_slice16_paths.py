"""Run chip_smoke.py's slice-16 paths and checks alone on one card.

    python perf/torch_slice16_paths.py [--scale 20]

Builds the kernels, then runs chip_smoke's ``check_algebra_codes``
(segfold and pair_fold at every code the algebra adds, with integer POW
and BSHIFT at the JAX rule's operands and the generated kernel of the
user op x ** y), ``check_slice16_repairs`` (ANY on the COO tier, UINT64
user ops, integer POW and BSHIFT, a user op's x ** y, on the card),
``gurand20`` (the urand twin at ``--scale``, its plan's kernels held to
their plain versions), ``groadc2048`` (the road twin at side 2048) and
``gdewise16m`` (the dewise twin at 16M + 16M entries), and writes the
check rows, launches and results to ``chiprun_out/slice16_paths.json``.
A quicker proof of these paths than the whole chip_smoke; its numbers
are the same functions'.  Needs the card.
"""

import argparse
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=cs.GURAND_SCALE)
    args = ap.parse_args()
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
    for name, run in (
            ("codes", lambda: cs.check_algebra_codes(torch, ck)),
            ("repairs", cs.check_slice16_repairs),
            ("gurand20", lambda: cs.gurand20_path(torch, ck, drv, card,
                                                  args.scale)),
            ("groadc2048", lambda: cs.groadc2048_path(torch, drv, card)),
            ("gdewise16m", lambda: cs.gdewise16m_path(torch, drv, card))):
        t = time.perf_counter()
        res[name] = run()
        phase_s[name] = time.perf_counter() - t
        print(f"{name} {phase_s[name]:.1f} s", flush=True)
    print(f"generated builds {_opgen.build_seconds}; unlowered "
          f"{_kernels.unlowered}", flush=True)
    bad = [c for c in ck.rows if not c["ok"]]
    print(f"checks {len(ck.rows) - len(bad)}/{len(ck.rows)} ok", flush=True)
    with open(os.path.join(cs.OUT_DIR, "slice16_paths.json"), "w") as f:
        json.dump(dict(res=res, phase_s=phase_s, counts=drv.counts,
                       checks=ck.rows, card=card,
                       gen_build_seconds=_opgen.build_seconds), f, indent=1,
                  default=str)
    print(json.dumps(dict(phase_s=phase_s, counts=drv.counts)), flush=True)
    print("total", time.perf_counter() - t_all, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
