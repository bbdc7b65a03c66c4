"""The readings that a cell's limit is set from, on the card, in one
process: the program's number on each of `--seeds` (a whole run with a
short window, as ``run.py`` makes it) and the control's on each of
`--control-seeds` (``harness.control_reading``), with each of the trial
kind's ``FAULTS`` in the control's place, for every cell of one
configuration, so that the cells of a seed share its plan.

    python3 portbench/calibrate.py --config gap-kron19 --seeds 1 2 ...
        --control-seeds 101 102 103 [--seconds 2]

One JSON line a reading on standard output, and in
``chiprun_out/portbench_calibrate.jsonl``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="chiprun_out/portbench_calibrate.jsonl")
    args = ap.parse_args(argv)

    from portbench import harness

    man = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = [w["name"] for w in man["workloads"]
             if w["config"] == args.config]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as out:
        def emit(d):
            line = json.dumps(d)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for seed in args.seeds:
            harness.set_caches()
            for c in cells:
                t = time.perf_counter()
                r = harness.run_cell(c, seed, args.seconds, 0, t0=t)
                emit(dict(cell=c, seed=seed, side="program",
                          correct=r["correct"], checks=r["checks"],
                          attempted=r["attempted"], metrics=r["metrics"],
                          wall_s=time.perf_counter() - t))
        for seed in args.control_seeds:
            for c in cells:
                _, _, _, mix = harness.cell(c)
                kind = importlib.import_module(
                    f"portbench.trials.{mix['trial']}")
                for which in ("control",) + getattr(kind, "FAULTS", ()):
                    t = time.perf_counter()
                    emit(dict(cell=c, seed=seed, side=which,
                              value=harness.control_reading(
                                  c, seed, which=which),
                              wall_s=time.perf_counter() - t))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
