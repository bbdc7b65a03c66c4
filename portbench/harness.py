"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result.

``run_cell`` reads the cell from ``BENCHMARK.json``, its configuration
from ``portbench/configs/<config>.json``, its mix from
``portbench/mixes/<traffic>.json``, the trial kind that the mix names
from ``portbench/trials/<trial>.py``, the graph family from
``portbench/graphs/<family>.py`` and each metric's reader from
``portbench/metrics/<name>.py``: a new cell, mix or metric is files of
its own.

The window is a closed loop: one client sends trials back to back, the
next when the last has completed on the card, for ``seconds``.  Each
trial is timed by CUDA events on its stream; the window's rate is all
its work over all its time by the host's clock.  A traced run (trace 1)
counts the program's kernel launches and xspmv calls over its window
and then runs ``TRACE_SECONDS`` more of the same traffic under the
profiler.  Once the window has closed and the peak memory has been
read, a seed-drawn sample of the answers (with the first of each BFS
route and the last) is copied to the host, the program's state is
freed, and the plain reference (``portbench/reference``) judges each.
"""

import gc
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from portbench import graphs, tracing, yardstick

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# the program's caches, at fixed paths inside the checkout
CACHE = ".portbench_cache"
# plans kept before a run (a run writes at most one): one for each seed
# of a check's two sets in each cell, whatever order the cells run in
PLANS_KEPT = 24
TRACE_SECONDS = 2.0
FORBIDDEN = ("jax", "jaxlib", "flax", "pygraphblas_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def set_caches(root=ROOT):
    """Point the program's caches into the checkout (before the program
    is imported: the plan cache's directory is read at import) and keep
    the newest PLANS_KEPT plans.  The nvcc and g++ builds already land
    in ``pygraphblas_tpu_torch/_build/``."""
    base = Path(root) / CACHE
    plans = base / "plans"
    plans.mkdir(parents=True, exist_ok=True)
    os.environ["PYGB_TORCH_PLAN_CACHE"] = str(plans)
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for tmp in plans.glob("*.tmp*"):
        tmp.unlink()
    kept = sorted(plans.glob("*.npz"), key=lambda p: p.stat().st_mtime)
    for old in kept[:-PLANS_KEPT] if PLANS_KEPT else kept:
        old.unlink()
    return plans


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(name, root=ROOT):
    """(manifest, workload entry, configuration, mix) of cell `name`."""
    man = load_json(Path(root) / "BENCHMARK.json")
    work = next((w for w in man["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    centry = next(c for c in man["configs"] if c["name"] == work["config"])
    cfg = load_json(Path(root) / centry["file"])
    mix = load_json(HERE / "mixes" / f"{work['traffic']}.json")
    return man, work, cfg, mix


def metrics_for(man, name, trace):
    """The cell's metrics: end-to-end ones untraced, per-layer traced."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


_READERS = {}


def reader(metric):
    """The reader module of `metric`, loaded by path."""
    if metric not in _READERS:
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[metric] = mod
    return _READERS[metric]


class Ctx:
    """What a trial kind and a probe see: the configuration, the mix,
    the device, the seed's generator, the program's matrix ``A`` and
    the harness's spans."""

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix = cfg, mix
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.n = None
        self.A = None
        self.edges_dev = None
        self.instrumented = False
        self.spans = tracing.Spans()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Record:
    """What the metric readers read."""

    def __init__(self, device_kind):
        self.device_kind = device_kind
        self.setup_s = None
        self.window_s = 0.0
        self.trials = []
        self.peak_bytes = 0
        self.plan = dict(seconds=0.0, calls=0, built=0)
        self.xspmv_calls = 0
        self.launches = {}
        self.trace = None
        self.probes = {}
        self.nnz = 0
        self.n = 0


def _wrap_plan(rec):
    """Time XSpmvPlan.build (a build or a cache load) and XSpmvPlan.to;
    count the builds.  Returns the undo."""
    from pygraphblas_tpu_torch.core.xspmv import XSpmvPlan

    build, _build, to = XSpmvPlan.build, XSpmvPlan._build, XSpmvPlan.to

    def timed(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                rec.plan["seconds"] += time.perf_counter() - t
                rec.plan["calls"] += 1
        return call

    def built(*a, **k):
        rec.plan["built"] += 1
        return _build(*a, **k)

    XSpmvPlan.build = staticmethod(timed(build))
    XSpmvPlan._build = staticmethod(built)
    XSpmvPlan.to = timed(to)

    def undo():
        XSpmvPlan.build = staticmethod(build)
        XSpmvPlan._build = staticmethod(_build)
        XSpmvPlan.to = to
    return undo


def _wrap_xspmv(ctx, rec):
    """Count core.xspmv.xspmv calls under a ``pb:xspmv`` span.  Returns
    the undo."""
    from pygraphblas_tpu_torch.core import xspmv as xs

    orig = xs.xspmv

    def xspmv(*a, **k):
        rec.xspmv_calls += 1
        with ctx.spans("xspmv"):
            return orig(*a, **k)

    xs.xspmv = xspmv
    return lambda: setattr(xs, "xspmv", orig)


class Sampler:
    """The answers kept for the comparison: a reservoir of `k` drawn
    from the seed, the first answer of each route and the last."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.res = []
        self.first = {}
        self.last = None

    def offer(self, i, answer, route):
        if route is not None and route not in self.first:
            self.first[route] = (i, answer)
        if len(self.res) < self.k:
            self.res.append((i, answer))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.res[j] = (i, answer)
        self.last = (i, answer)

    def kept(self):
        out = dict(self.res)
        out.update(self.first.values())
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def _trials(ctx, kind, clock, seconds, start, sampler=None, notes=None):
    """Trials back to back from index `start` until `seconds` have
    passed; returns (trials run, failed, seconds, timing marks)."""
    marks, failed, i = [], 0, start
    t0 = time.perf_counter()
    while True:
        with ctx.spans("trial." + kind):
            mark = clock.start()
            try:
                answer = ctx.trials.call(i)
            except Exception:       # a trial that never comes back
                answer = None
                failed += 1
                if failed <= 3:
                    log(f"trial {i} raised:\n{traceback.format_exc()}")
            marks.append(clock.stop(mark))
        if notes is not None:
            note = ctx.trials.note(i, answer) if answer is not None else {}
            notes.append(note)
            if sampler is not None and answer is not None:
                sampler.offer(i, answer, note.get("route"))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            return i - start, failed, time.perf_counter() - t0, marks


def _power_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _steady():
    """Hold the window's host thread still: pin it to one core (the
    highest it may use; threads it starts inherit the pin, threads
    already running keep theirs) and move what set-up made out of the
    collector's reach, so that no full collection walks it."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    gc.collect()
    gc.freeze()
    return core


def run_cell(name, seed, seconds, trace, device="cuda", t0=None,
             overrides=None, root=ROOT, steady=False):
    """One run of cell `name`; returns the result dict (the JSON line).
    `overrides` replaces configuration keys (the CPU tests' small
    graphs); `t0` is the process's start on ``time.perf_counter``;
    `steady` pins the window's thread and freezes the collector
    (``run.py``: a process of its own)."""
    t0 = time.perf_counter() if t0 is None else t0
    man, _, cfg, mix = cell(name, root)
    cfg = dict(cfg, **(overrides or {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    kind_name = mix["trial"]
    kind = importlib.import_module(f"portbench.trials.{kind_name}")
    ctx = Ctx(cfg, mix, seed, dev)
    rec = Record(torch.cuda.get_device_name(dev) if on_card else "cpu")

    # the graph, on the device from the seed; the trials' inputs
    t_in = time.perf_counter() - t0
    rows, cols, n = graphs.make(cfg, ctx.gen, dev)
    ctx.sync()
    t_gen = time.perf_counter() - t0
    ctx.n, rec.n, rec.nnz = n, n, int(rows.numel())
    ctx.edges_dev = (rows, cols, n)
    ctx.trials = kind.Trials(ctx)
    rows_h, cols_h = rows.cpu().numpy(), cols.cpu().numpy()
    ctx.edges_dev = None
    del rows, cols
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_graph = time.perf_counter() - t0

    # the program: its matrix, its plan and every shape the traffic uses
    from pygraphblas_tpu_torch import _kernels, convert

    undo = _wrap_plan(rec)
    try:
        ctx.A = convert.matrix_from_arrays(
            "FP32", n, n, rows_h, cols_h, np.ones(len(rows_h), np.float32),
            device=dev)
        ctx.trials.warm()
    finally:
        undo()
    ctx.instrumented = bool(trace)
    undo = _wrap_xspmv(ctx, rec) if trace else (lambda: None)
    clock = yardstick.EventClock() if on_card else yardstick.HostClock()
    launches0 = dict(_kernels.launches)
    rec.setup_s = time.perf_counter() - t0
    log(f"setup {rec.setup_s:.3f} s: process start to the cell "
        f"{t_in:.3f} s, graph made {t_gen:.3f} s, on the host "
        f"{t_graph:.3f} s ({rec.nnz} entries, {n} vertices); plan "
        f"{rec.plan['seconds']:.3f} s "
        f"({'built' if rec.plan['built'] else 'loaded'}"
        f"{', ' + _plan_files() if on_card else ''}); kernels "
        f"{'built' if _kernels.build_seconds else 'loaded'}")

    # the window
    if steady:
        log(f"window thread pinned to core {_steady()}, collector frozen")
    sampler = Sampler(mix["compare"], seed)
    notes = []
    ran, failed, rec.window_s, marks = _trials(
        ctx, kind_name, clock, seconds, 0, sampler, notes)
    rec.peak_bytes = (torch.cuda.max_memory_allocated(dev) if on_card
                      else 0)
    rec.launches = {k: v - launches0.get(k, 0)
                    for k, v in _kernels.launches.items()}
    undo()
    for mark, note in zip(marks, notes):
        rec.trials.append(dict(note, ms=clock.ms(mark)))
    log(f"window {rec.window_s:.3f} s: {ran} trials, {failed} failed")

    breakdown = None
    if trace:
        breakdown = _traced_segment(ctx, kind_name, clock, ran, rec)
        for m in metrics_for(man, name, True):
            probe = getattr(reader(m["name"]), "probe", None)
            if probe is not None:
                probe(ctx, rec)
        if on_card:
            log(f"card: {_power_line()}")

    # the answers to the host, the program freed, the reference run
    kept = sorted(sampler.kept().items())
    answers = [(i, ctx.trials.host(a)) for i, a in kept]
    keys = [ctx.trials.key(i) for i in range(ran)]
    ctx.A = None
    del kept, sampler
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    edges = (torch.from_numpy(rows_h).to(dev),
             torch.from_numpy(cols_h).to(dev), n)
    gaps, refs = [], {}
    for i, ans in answers:
        key = ctx.trials.key(i)
        if key not in refs:
            refs[key] = ctx.trials.reference(edges, key)
        gaps.append(ctx.trials.gap(ans, refs[key]))
    for t, w in zip(rec.trials, ctx.trials.work(edges, keys)):
        t["work"] = w
    value = max(gaps) if gaps else None
    routes = sorted({t.get("route") for t in rec.trials} - {None})
    log(f"compared {len(answers)} answers (trials "
        f"{[i for i, _ in answers]}); routes run {routes}")

    metrics = {}
    for m in metrics_for(man, name, trace):
        v = reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_out = {"platform": "gpu" if on_card else "cpu",
               "kind": rec.device_kind, "count": 1,
               "memory_peak_bytes": rec.peak_bytes}
    if trace and rec.trace:
        dev_out.update(busy_s=rec.trace["busy_s"],
                       window_s=rec.trace["window_s"])
    checks = {kind.CHECK: {"value": value, "limit": kind.LIMIT},
              "failed_trials": {"value": failed, "limit": 0}}
    correct = (ran > 0 and failed == 0 and value is not None
               and value <= kind.LIMIT)
    out = {"correct": bool(correct), "attempted": ran, "failed": failed,
           "metrics": metrics, "device": dev_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _plan_files():
    d = Path(os.environ["PYGB_TORCH_PLAN_CACHE"])
    sizes = [p.stat().st_size for p in d.glob("*.npz")]
    return f"{len(sizes)} cached, newest " + (
        f"{sizes[-1] / 2**20:.1f} MiB" if sizes else "none")


def _traced_segment(ctx, kind_name, clock, start, rec):
    """TRACE_SECONDS more trials under the profiler; fills rec.trace and
    returns the breakdown.  A trace of the card with no device event
    raises: its busy time would read 0."""
    from pygraphblas_tpu_torch import _kernels

    ctx.spans.on = True
    try:
        before = dict(_kernels.launches)
        evs = tracing.capture(lambda: _trials(
            ctx, kind_name, clock, TRACE_SECONDS, start))
        launched = {k: v - before.get(k, 0)
                    for k, v in _kernels.launches.items()}
        red = tracing.reduce(evs, launched)
    finally:
        ctx.spans.on = False
    if not red["device_events"] and ctx.device.type == "cuda":
        raise RuntimeError("the profiler's trace holds no device event")
    rec.trace = red
    log(f"trace: events by kind {red['kinds']}")
    log(f"trace: {red['device_events']} device events in "
        f"{red['window_s']:.3f} s, busy {red['busy_s']:.6f} s; port "
        f"kernels' events / launches: "
        + ", ".join(f"{k} {a}/{b}" for k, (a, b) in red["coverage"].items()))
    for label, d in red["idle_detail"].items():
        log(f"  idle {d['seconds']:.6f} s in {d['count']} gaps (longest "
            f"{d['longest_s'] * 1e3:.3f} ms): {label}")
    return {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}


def control_reading(name, seed, device="cuda", overrides=None, root=ROOT,
                    which="control"):
    """The control's reading in cell `name` on seed `seed`: the trial
    kind's control (the reference put in the program's place, one
    precision below, or with a guarantee broken) against the reference,
    on the inputs of the first ``compare`` trials of a run of that seed,
    by the number the run compares.  `which` names another answer of
    the trial kind's in the control's place: one of its ``FAULTS``.
    The program does not run."""
    _, _, cfg, mix = cell(name, root)
    cfg = dict(cfg, **(overrides or {}))
    kind = importlib.import_module(f"portbench.trials.{mix['trial']}")
    ctx = Ctx(cfg, mix, seed, torch.device(device))
    rows, cols, n = graphs.make(cfg, ctx.gen, ctx.device)
    ctx.n = n
    ctx.edges_dev = (rows, cols, n)
    trials = kind.Trials(ctx)
    keys = dict.fromkeys(trials.key(i) for i in range(mix["compare"]))
    wrong = getattr(trials, which)
    return max(trials.gap(wrong(ctx.edges_dev, k),
                          trials.reference(ctx.edges_dev, k))
               for k in keys)
