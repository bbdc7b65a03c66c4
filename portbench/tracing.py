"""Spans, the profiler's timeline and its reduction to per-layer numbers.

A traced segment runs the cell's traffic under ``torch.profiler``; the
harness's spans are ``record_function`` annotations named ``pb:...``.
``reduce`` reads the raw events: the device's busy time as the union of
its operations' intervals (kernels, copies, sets) inside the segment,
the device operations that took most time (the port's kernels under
their own names through ``SYMBOLS``, other kernels under the host op
that launched them), each idle gap labelled by the harness span and the
innermost host op open when it began, and the events seen of each port
kernel against its counted launches.
"""

import contextlib
from collections import namedtuple

import torch

# kernel symbol prefix in a profile -> the port's kernel name: a frozen
# copy of chip_smoke.py's _SYMBOLS (every __global__ of each kernel)
SYMBOLS = {"mono_span_kernel": "mono_span",
           "mono_cascade_kernel": "mono_cascade",
           "mono_rows_kernel": "mono_rows",
           "lane_gather_kernel": "lane_gather",
           "tdesc_kernel": "lane_gather_tdesc",
           "tasc_kernel": "lane_gather_tasc", "inner3_kernel": "inner3",
           "mid_pass_kernel": "mid_pass", "fill_keys_kernel": "fill_keys",
           "pair_count_kernel": "pair_count",
           "pair_count_short_kernel": "pair_count",
           "pair_fold_kernel": "pair_fold",
           "pair_fold_search_kernel": "pair_fold",
           "pair_fold_warp_kernel": "pair_fold",
           "segfold_kernel": "segfold",
           "esc_gather_kernel": "esc_gather"}

# device activities that occupy the card (not syncs or annotations)
BUSY_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SEGMENT = "pb:segment"
TOP = 10

Ev = namedtuple("Ev", "name kind start end corr linked tid")


def port_kernel(raw):
    """The port's kernel name of a device symbol, or None."""
    return next((v for k, v in SYMBOLS.items() if k in raw), None)


class Spans:
    """The harness's spans: ``record_function`` annotations while a
    profiler records, nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name):
        if self.on:
            return torch.profiler.record_function("pb:" + name)
        return contextlib.nullcontext()


def capture(fn):
    """Run fn() under the profiler inside a ``pb:segment`` span; returns
    the raw events as ``Ev`` tuples (times in ns)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(SEGMENT):
            fn()
    return [Ev(e.name(), _kind(e), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.correlation_id(),
               e.linked_correlation_id(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def _kind(e):
    """The event's activity type, by kineto's names, worked out from its
    device, name and annotation flag: the card's torch does not give
    its events the type itself."""
    name = e.name()
    annotation = e.is_user_annotation() or name.startswith("pb:")
    if "CUDA" in str(e.device_type()):
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if "Sync" in name.split("(")[0]:
            return "cuda_sync"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(evs, times):
    """For each of the ascending `times`, the name of the innermost of
    the properly nested intervals `evs` that holds it (None where none
    does): one sweep with a stack of the open intervals."""
    evs = sorted(evs, key=lambda e: (e.start, -e.end))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(evs) and evs[j].start <= t:
            while stack and stack[-1].end <= evs[j].start:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def _short(raw):
    """A kernel symbol cut to its function name."""
    name = raw.replace("void ", "").split("(")[0].split("<")[0]
    return name.split("::")[-1] or raw[:64]


def reduce(evs, launched):
    """The segment's numbers from its events: busy_s, window_s, the
    device ops and idle gaps for the breakdown (at most TOP each, as
    [name, seconds]), and coverage: each port kernel's events in the
    trace against its launches counted over the segment (`launched`)."""
    seg = next((e for e in evs if e.name == SEGMENT
                and e.kind == "user_annotation"), None)
    if seg is None:
        raise RuntimeError("the trace holds no segment span")
    s0, s1 = seg.start, seg.end
    dev = [e for e in evs if e.kind in BUSY_KINDS
           and e.end > s0 and e.start < s1]
    merged = _union([max(e.start, s0), min(e.end, s1)] for e in dev)
    busy = sum(e - s for s, e in merged)

    host = [e for e in evs if e.kind not in BUSY_KINDS
            and e.kind not in ("gpu_user_annotation", "cuda_sync")]
    op_of = {e.corr: e.name for e in host if e.kind == "cpu_op"}
    by_name, seen = {}, {}
    for e in dev:
        k = port_kernel(e.name) if e.kind == "kernel" else None
        if k is not None:
            seen[k] = seen.get(k, 0) + 1
            name = k
        elif e.kind == "kernel":
            name = op_of.get(e.linked) or _short(e.name)
        else:
            name = e.name
        dt = min(e.end, s1) - max(e.start, s0)
        by_name[name] = by_name.get(name, 0) + dt
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    main = [e for e in host if e.tid == seg.tid and e.end > s0
            and e.start < s1]
    edges = [s0] + [x for iv in merged for x in iv] + [s1]
    idle_iv = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    starts = [a for a, _ in idle_iv]
    spans = _innermost([e for e in main if e.kind == "user_annotation"],
                       starts)
    cpu = _innermost([e for e in main if e.kind == "cpu_op"], starts)
    rt = _innermost([e for e in main if e.kind in ("cuda_runtime",
                                                    "cuda_driver")], starts)
    gaps = {}
    for (a, b), span, op, r in zip(idle_iv, spans, cpu, rt):
        label = f"{span or SEGMENT} > {op or r or 'python'}"
        n, tot, longest = gaps.get(label, (0, 0, 0))
        gaps[label] = (n + 1, tot + (b - a), max(longest, b - a))
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][1])[:TOP]
    coverage = {k: [seen.get(k, 0), n] for k, n in launched.items()
                if n or seen.get(k)}
    return dict(
        busy_s=busy / 1e9, window_s=(s1 - s0) / 1e9,
        device_events=len(dev), coverage=coverage,
        kinds={k: sum(e.kind == k for e in evs)
               for k in sorted({e.kind for e in evs})},
        device_ops=[[name, ns / 1e9] for name, ns in ops],
        idle_gaps=[[label, tot / 1e9] for label, (_, tot, _) in idle],
        idle_detail={label: dict(count=n, seconds=tot / 1e9,
                                 longest_s=lo / 1e9)
                     for label, (n, tot, lo) in idle})
