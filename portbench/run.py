"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (JSON); the last lines of standard error are each number the
comparison read, beside its limit.  Exits 2 without a result where no
CUDA card is present (or fewer than the cell asks for), 3 where JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# one process, few threads: the trials are paced by one host thread, and
# idle thread pools only add to the spread of runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    _, work, _, _ = harness.cell(args.workload)
    harness.set_caches()
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < work["chips"]):
        print(f"{args.workload} needs {work['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device="cuda", t0=T0,
                              steady=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
