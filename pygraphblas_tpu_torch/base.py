"""Runtime base: global options, the error hierarchy, per-operation
timing and the index-range compiler.

The port's counterpart of ``pygraphblas_tpu/base.py``.  Options live in
a Python-side :class:`GlobalConfig` read by the dispatch layer: the
containers' tier limits (``bitmap_max_cells``, ``vector_max_cells``:
past them a container is host-staged sorted COO), ``op_timing`` (the
``_timed`` counters, ``perf_report``), ``spmv_engine`` ("auto" takes the
xspmv pipeline when the semiring and size support it and the plan is
warm, "xspmv" forces it, "csr8" forces the csr8 engine),
``spmv_plan_async`` (build a cold xspmv plan in a thread), the
element-wise device engine's ``ewise_engine`` and ``ewise_device_min``,
and the unmasked SpGEMM's
``spgemm_engine`` and ``spgemm_dense_cells`` ("auto" tries the
compact-dense tier within ``spgemm_dense_cells`` cells, then the
expand/sort/compact engine (core/esc.py) on the card, then the host
two-phase tiers; "dense", "esc" and "scipy" force one tier).  The other
fields are the JAX package's, kept for parity.

At import it tunes glibc's allocator as the JAX package does
(``_tune_host_allocator``), and ``profile_start``/``profile_stop`` wrap
``torch.profiler``.
"""

import ctypes
import os
import sys
import time
from dataclasses import dataclass, field

__all__ = [
    "NULL", "GraphBLASException", "NoValue", "UninitializedObject",
    "InvalidObject", "NullPointer", "InvalidValue", "InvalidIndex",
    "DomainMismatch", "DimensionMismatch", "OutputNotEmpty", "OutOfMemory",
    "InsufficientSpace", "IndexOutOfBound", "Panic", "options_set",
    "options_get", "GxB_INDEX_MAX", "GxB_IMPLEMENTATION", "GxB_SPEC",
    "profile_start", "profile_stop",
]

NULL = None

# Maximum logical dimension: hypersparse storage keeps memory O(nnz).
GxB_INDEX_MAX = 2**60

# Implementation/spec version tuples for API parity.
GxB_IMPLEMENTATION = (1, 0, 0)
GxB_SPEC = (2, 0, 0)


def _tune_host_allocator():
    """Keep freed large blocks on the glibc heap (no mmap, no trim).

    glibc munmaps every large free, so each big numpy temporary of the
    host phases (plan builds, sorted-COO merges, the SpGEMM relabel and
    assembly, graph generators) faults all of its pages in again; on a
    virtual machine a first touch can cost far more than a reuse.
    Reusing heap pages keeps the resident size at its high-water mark,
    the right trade for a compute host.  ``PYGB_MALLOC_TUNE=0``
    disables it (the JAX package's contract)."""
    if os.environ.get("PYGB_MALLOC_TUNE", "1") != "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    except OSError:  # pragma: no cover - another libc: best effort
        pass


_tune_host_allocator()


# --------------------------------------------------------------------------
# Error hierarchy: same names, same meanings as the JAX package's.
# --------------------------------------------------------------------------


class GraphBLASException(Exception):
    pass


class NoValue(GraphBLASException):
    pass


class UninitializedObject(GraphBLASException):
    pass


class InvalidObject(GraphBLASException):
    pass


class NullPointer(GraphBLASException):
    pass


class InvalidValue(GraphBLASException):
    pass


class InvalidIndex(GraphBLASException):
    pass


class DomainMismatch(GraphBLASException):
    pass


class DimensionMismatch(GraphBLASException):
    pass


class OutputNotEmpty(GraphBLASException):
    pass


class OutOfMemory(GraphBLASException):
    pass


class InsufficientSpace(GraphBLASException):
    pass


class IndexOutOfBound(GraphBLASException):
    pass


class Panic(GraphBLASException):
    pass


# --------------------------------------------------------------------------
# Global configuration (the JAX package's fields and defaults).
# --------------------------------------------------------------------------

BY_ROW = 0  # CSR-like orientation (GxB_BY_ROW)
BY_COL = 1  # CSC-like orientation (GxB_BY_COL)


@dataclass
class GlobalConfig:
    nthreads: int = 0
    chunk: float = 65536.0
    burble: int = 0
    hyper_switch: float = 0.0625
    bitmap_switch: list = field(
        default_factory=lambda: [0.04, 0.05, 0.06, 0.08, 0.10, 0.20, 0.30,
                                 0.40])
    format: int = BY_ROW
    op_timing: int = 0
    bitmap_max_cells: int = 1 << 26
    vector_max_cells: int = 1 << 27
    capacity_factor: float = 1.25
    spmv_engine: str = "auto"
    spgemm_engine: str = "auto"
    spgemm_dense_cells: int = 1 << 24
    spmv_plan_async: bool = False
    ewise_engine: str = "auto"
    ewise_device_min: int = 1 << 21


config = GlobalConfig()


def options_set(nthreads=None, chunk=None, burble=None, hyper_switch=None,
                bitmap_switch=None, format=None, op_timing=None,
                bitmap_max_cells=None, vector_max_cells=None,
                spmv_engine=None, spgemm_engine=None,
                spgemm_dense_cells=None, spmv_plan_async=None,
                ewise_engine=None, ewise_device_min=None):
    """Set global library options (the JAX package's surface)."""
    if nthreads is not None:
        config.nthreads = int(nthreads)
    if chunk is not None:
        config.chunk = float(chunk)
    if burble is not None:
        config.burble = int(burble)
    if hyper_switch is not None:
        config.hyper_switch = float(hyper_switch)
    if bitmap_switch is not None:
        config.bitmap_switch = list(bitmap_switch)
    if format is not None:
        config.format = int(format)
    if op_timing is not None:
        config.op_timing = int(op_timing)
    if bitmap_max_cells is not None:
        config.bitmap_max_cells = int(bitmap_max_cells)
    if vector_max_cells is not None:
        config.vector_max_cells = int(vector_max_cells)
    if spmv_engine is not None:
        if spmv_engine not in ("auto", "csr8", "xspmv"):
            raise ValueError("spmv_engine must be auto|csr8|xspmv")
        config.spmv_engine = spmv_engine
    if spgemm_engine is not None:
        if spgemm_engine not in ("auto", "dense", "esc", "scipy"):
            raise ValueError("spgemm_engine must be auto|dense|esc|scipy")
        config.spgemm_engine = spgemm_engine
    if spgemm_dense_cells is not None:
        config.spgemm_dense_cells = int(spgemm_dense_cells)
    if spmv_plan_async is not None:
        config.spmv_plan_async = bool(spmv_plan_async)
    if ewise_engine is not None:
        if ewise_engine not in ("auto", "device", "host"):
            raise ValueError("ewise_engine must be auto|device|host")
        config.ewise_engine = ewise_engine
    if ewise_device_min is not None:
        config.ewise_device_min = int(ewise_device_min)


def options_get():
    """Get global library options (the JAX package's keys)."""
    return dict(nthreads=config.nthreads, chunk=config.chunk,
                burble=config.burble, hyper_switch=config.hyper_switch,
                bitmap_switch=list(config.bitmap_switch),
                format=config.format)


def burble(msg, *args):
    """Dispatch-layer debug logging."""
    if config.burble:
        print("[burble %.6f] %s" % (time.time(), msg % args),
              file=sys.stderr)


# --------------------------------------------------------------------------
# Per-operation wall-clock counters (options_set(op_timing=1))
# --------------------------------------------------------------------------

perf_counters = {}


def _timed(name):
    """Decorate a dispatch-layer operation with an op-timing counter
    (enabled via ``options_set(op_timing=1)``; near zero cost when
    off)."""
    from functools import wraps

    def deco(fn):
        @wraps(fn)
        def wrap(*a, **k):
            if not config.op_timing:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                c = perf_counters.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += time.perf_counter() - t0
        return wrap
    return deco


def perf_report(reset=False, file=None):
    """Aggregated per-op timing: {op: (calls, total_seconds)}.  With
    file= (e.g. sys.stderr) also prints a sorted table.  Host seconds:
    a call returns when its work is queued on the card, unless it reads
    a result back."""
    snap = {k: tuple(v) for k, v in perf_counters.items()}
    if file is not None:
        for k, (n, t) in sorted(snap.items(), key=lambda kv: -kv[1][1]):
            print(f"{k:24s} {n:8d} calls {t:10.4f} s", file=file)
    if reset:
        perf_counters.clear()
    return snap


_profiler = None


def profile_start(log_dir):
    """Start a torch.profiler trace of the host and, where there is a
    card, its kernels; `profile_stop` writes it into `log_dir` (a Chrome
    trace, one ``.json`` file)."""
    global _profiler
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _profiler.start()


def profile_stop():
    """Stop the trace `profile_start` began and write it out."""
    global _profiler
    prof, _profiler = _profiler, None
    if prof is not None:
        prof.stop()


# --------------------------------------------------------------------------
# Index-range compiler: GraphBLAS slices are stop-INCLUSIVE.
# --------------------------------------------------------------------------

_all_slice = slice(None, None, None)


class IndexSet:
    """Compiled index descriptor: one of ALL, LIST, RANGE, STRIDE,
    BACKWARDS."""

    __slots__ = ("kind", "start", "stop", "step", "list", "size")

    ALL = "all"
    LIST = "list"
    RANGE = "range"
    STRIDE = "stride"
    BACKWARDS = "backwards"

    def __init__(self, kind, start=None, stop=None, step=None, list_=None,
                 size=None):
        self.kind = kind
        self.start = start
        self.stop = stop
        self.step = step
        self.list = list_
        self.size = size

    def indices(self, dim_size):
        """Materialize as a host index vector against a dimension size."""
        import numpy as np

        if self.kind == IndexSet.ALL:
            return np.arange(dim_size, dtype=np.int64)
        if self.kind == IndexSet.LIST:
            return np.asarray(self.list, dtype=np.int64)
        if self.kind == IndexSet.RANGE:
            return np.arange(self.start, self.stop + 1, dtype=np.int64)
        if self.kind == IndexSet.STRIDE:
            return np.arange(self.start, self.stop + 1, self.step,
                             dtype=np.int64)
        if self.kind == IndexSet.BACKWARDS:
            return np.arange(self.start, self.stop - 1, -self.step,
                             dtype=np.int64)
        raise Panic("unknown index kind")  # pragma: no cover


def _build_range(rslice, stop_val):
    """Compile a Python slice/list into an :class:`IndexSet` (stop
    inclusive: ``A[1:3]`` selects rows 1, 2, 3)."""
    if isinstance(rslice, list):
        return IndexSet(IndexSet.LIST, list_=rslice, size=len(rslice))
    if rslice is None or rslice == _all_slice:
        return IndexSet(IndexSet.ALL, size=None)
    start = 0 if rslice.start is None else rslice.start
    stop = stop_val if rslice.stop is None else rslice.stop
    step = rslice.step
    if step is None:
        return IndexSet(IndexSet.RANGE, start=start, stop=stop,
                        size=(stop - start) + 1)
    if step < 0:
        step = abs(step)
        size = 0 if start < stop else int((start - stop) / step) + 1
        return IndexSet(IndexSet.BACKWARDS, start=start, stop=stop,
                        step=step, size=size)
    size = 0 if start > stop or step == 0 else \
        int((stop - start) / step) + 1
    return IndexSet(IndexSet.STRIDE, start=start, stop=stop, step=step,
                    size=size)


_SELECT_OP_NAMES = {
    ">": "GT_THUNK", "<": "LT_THUNK", ">=": "GE_THUNK", "<=": "LE_THUNK",
    "!=": "NE_THUNK", "==": "EQ_THUNK", ">0": "GT_ZERO", "<0": "LT_ZERO",
    ">=0": "GE_ZERO", "<=0": "LE_ZERO", "!=0": "NONZERO", "==0": "EQ_ZERO",
}


def _get_select_op(op):
    from . import selectop as selectop_module

    return getattr(selectop_module, _SELECT_OP_NAMES[op])


def _get_bin_op(op, funcs):
    return {">": funcs.GT, "<": funcs.LT, ">=": funcs.GE, "<=": funcs.LE,
            "!=": funcs.NE, "==": funcs.EQ, "+": funcs.PLUS,
            "-": funcs.MINUS, "*": funcs.TIMES, "/": funcs.DIV}[op]
