"""Measure cells' spread as the contract asks: `--sets` sets of runs of
``run.py``, each run its own process, the same seeds in every set and
every cell (so that a cell's runs load the plans that an earlier cell of
the same configuration built), then the traced runs; prints each
end-to-end metric's median and spread (interquartile range over the
median, Python's quartiles) per cell and set, and the bound five times
the widest spread would give.

    python3 portbench/measure.py --workloads kron19-pr kron19-bfs
        --seeds 1 2 3 4 5 6 [--sets 2] [--seconds 10] [--trace-seeds 7 8 9]

Each run's result line (or its failure) goes to
``chiprun_out/portbench_measure.jsonl``, with the host's steal time
over the run (``/proc/stat``), so that a spread can be set beside what
the machine's other tenants took.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import yardstick  # noqa: E402


def _cpu_ticks():
    """(steal, all) ticks of the host's cpus since boot."""
    with open("/proc/stat") as f:
        vals = [int(x) for x in f.readline().split()[1:]]
    return vals[7] if len(vals) > 7 else 0, sum(vals[:8])


def one(workload, seed, seconds, trace):
    t = time.perf_counter()
    st0, all0 = _cpu_ticks()
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT)
    st1, all1 = _cpu_ticks()
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return dict(workload=workload, seed=seed, trace=trace, rc=p.returncode,
                wall_s=time.perf_counter() - t, result=res,
                steal_pct=100 * (st1 - st0) / max(all1 - all0, 1),
                err_tail=p.stderr[-2500:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="chiprun_out/portbench_measure.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    runs = []
    with open(args.out, "a") as out:
        plan = [(s, w, seed, 0) for s in range(args.sets)
                for w in args.workloads for seed in args.seeds]
        plan += [(args.sets, w, seed, 1) for w in args.workloads
                 for seed in args.trace_seeds]
        for s, w, seed, trace in plan:
            r = one(w, seed, args.seconds, trace)
            r["set"] = s
            runs.append(r)
            out.write(json.dumps(r) + "\n")
            out.flush()
            res = r["result"] or {}
            print(f"{w} set {s} seed {seed} trace {trace} rc {r['rc']} "
                  f"correct {res.get('correct')} wall {r['wall_s']:.1f} s "
                  f"steal {r['steal_pct']:.2f}% "
                  + json.dumps({k: v["value"] for k, v in
                                res.get("metrics", {}).items()})
                  + " checks " + json.dumps(res.get("checks")), flush=True)
            if r["rc"] != 0 or not res.get("correct"):
                print(r["err_tail"], flush=True)
    for w in args.workloads:
        widest = {}
        for s in range(args.sets):
            rows = [r["result"] for r in runs
                    if r["set"] == s and r["workload"] == w and r["result"]]
            for name in (rows[0]["metrics"] if len(rows) > 1 else ()):
                vals = [x["metrics"][name]["value"] for x in rows
                        if name in x["metrics"]]
                med, sp = yardstick.spread(vals)
                widest[name] = max(widest.get(name, 0), sp)
                print(f"{w} set {s} {name}: median {med!r} spread "
                      f"{sp:.5f} ({len(vals)} runs)")
        for name, sp in widest.items():
            print(f"{w} {name}: widest spread {sp:.5f}, 5x = {5 * sp:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
