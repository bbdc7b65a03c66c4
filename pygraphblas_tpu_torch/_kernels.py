"""Build, load and count the port's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (a source whose instantiations take long is split
into translation units of its own: ``csrc/mono_*.cu``; ``build_seconds``
holds each source's seconds, ``build_phases`` nvcc's own time for each
of its phases); the objects are linked into one shared
library with a plain C interface, loaded with ctypes.  The build lands in
``_build/`` (listed in ``.gitignore``) under a name carrying a hash of
the sources, at first use: importing this module compiles nothing.

``launches`` counts kernel launches by name.  Each wrapper adds one
exactly where it launches its kernel, so a run can show which kernels
its path went through (``reset_launches`` before, read after); a launch
of a generated kernel (``_opgen.py``: a user op's ``segfold`` or
``pair_fold``) counts under its kernel's name and, per op, in
``generated``.  ``unlowered`` names each op that did not lower to a
generated kernel, and why.
"""

import csv
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from .ops import table

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# nvcc's flags for every kernel source, the generated ones too
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset
launches = {"mono_span": 0, "mono_cascade": 0, "mono_rows": 0,
            "lane_gather": 0, "lane_gather_tdesc": 0, "lane_gather_tasc": 0,
            "inner3": 0, "mid_pass": 0, "pair_count": 0, "fill_keys": 0,
            "pair_fold": 0, "segfold": 0, "esc_gather": 0}
# "<kernel> <op names>" -> launches of a generated kernel since the last
# reset; op name -> why it did not lower (since the process started)
generated = {}
unlowered = {}

_lib = None
build_log = ""
# source file name -> seconds from the build's start to its nvcc's end
# (the last build of this process; empty when a finished build was
# reused)
build_seconds = {}
# source file name -> {nvcc phase (cicc, ptxas, ...): seconds}, from
# nvcc --time, for the same build
build_phases = {}

# GraphBLAS type name -> csrc/ops.cuh dtype code: the value type of the
# 4-byte words a kernel reads (DT_F32 float, DT_U32 uint32, the others
# int32, the narrow ones widened: see to_words)
TYPE_CODES = {"FP32": 0, "INT32": 1, "UINT32": 2, "INT8": 3, "INT16": 4,
              "UINT8": 5, "UINT16": 6, "BOOL": 7}
# add-monoid op name -> fold code (csrc/ops.cuh FOLD_*)
FOLDS = {"PLUS": 0, "MIN": 1, "MAX": 2, "TIMES": 3, "ANY": 4, "LOR": 5,
         "LAND": 6, "LXOR": 7, "LXNOR": 8, "BOR": 9, "BAND": 10,
         "BXOR": 11, "BXNOR": 12}
# mul op name -> mul code (csrc/ops.cuh MUL_*)
MULS = {"TIMES": 0, "PLUS": 1, "MINUS": 2, "RMINUS": 3, "DIV": 4,
        "RDIV": 5, "FIRST": 6, "SECOND": 7, "PAIR": 8, "MIN": 9, "MAX": 10,
        "ISEQ": 11, "ISNE": 12, "ISGT": 13, "ISLT": 14, "ISGE": 15,
        "ISLE": 16, "LOR": 17, "LAND": 18, "LXOR": 19, "EQ": 20, "NE": 21,
        "GT": 22, "LT": 23, "GE": 24, "LE": 25, "ANY": 7, "POW": 26,
        "BOR": 27, "BAND": 28, "BXOR": 29, "BXNOR": 30, "BGET": 31,
        "BSET": 32, "BCLR": 33, "BSHIFT": 34, "ATAN2": 35, "HYPOT": 36,
        "FMOD": 37, "REMAINDER": 38, "LDEXP": 39, "COPYSIGN": 40}
# BOOL arithmetic (ops/table.py): PLUS is OR, TIMES is AND, MINUS is XOR,
# DIV is FIRST, MIN is AND, MAX is OR; on 0/1 words EQ is LXNOR
_BOOL_OPS = {"PLUS": "LOR", "TIMES": "LAND", "MINUS": "LXOR",
             "RMINUS": "LXOR", "DIV": "FIRST", "RDIV": "SECOND",
             "MIN": "LAND", "MAX": "LOR", "EQ": "LXNOR"}
# the fold codes a float word takes
_FLOAT_FOLDS = ("PLUS", "MIN", "MAX", "TIMES", "ANY")


def reset_launches():
    for k in launches:
        launches[k] = 0
    generated.clear()


def count(name, ops=None):
    """One launch of kernel `name` (of its generated variant for the op
    names `ops`)."""
    launches[name] += 1
    if ops is not None:
        key = f"{name} {ops}"
        generated[key] = generated.get(key, 0) + 1


def _nvcc():
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _phases(path):
    """nvcc --time's CSV -> {phase: seconds}, summed over its rows."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for row in csv.reader(f):
            # source, phase, inputs, output, arch, tool, milliseconds, unit
            if len(row) < 8 or row[-1].strip() != "ms":
                continue
            name = row[1].strip()
            out[name] = round(out.get(name, 0.0) + float(row[-2]) / 1e3, 3)
    return out


def build():
    """Compile the kernels (one nvcc per source, in parallel) and link
    them into one library; returns its path.  Reuses a finished build of
    the same sources."""
    global build_log
    build_seconds.clear()
    build_phases.clear()
    h = hashlib.sha1()
    for p in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libpgb_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        t0 = time.perf_counter()
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-Xptxas", "-v", "--time",
                   obj + ".csv", "-c", src, "-o", obj]
            # the compiler's output to a file: a pipe nobody reads while
            # the others run would fill and stall it
            with open(obj + ".log", "w") as log:
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
        pending = {src: p for src, _, p in procs}
        while pending:
            for src, p in list(pending.items()):
                if p.poll() is not None:
                    build_seconds[os.path.basename(src)] = \
                        time.perf_counter() - t0
                    del pending[src]
            time.sleep(0.05)
        logs = []
        failed = []
        for src, obj, p in procs:
            name = os.path.basename(src)
            build_phases[name] = _phases(obj + ".csv")
            with open(obj + ".log") as f:
                logs.append(f"== {name} ({build_seconds[name]:.1f} s; "
                            f"{build_phases[name]})\n{f.read()}")
            if p.returncode:
                failed.append(src)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = os.path.join(work, "lib.so")
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                        *[o for _, o, _ in procs]],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        L.pgb_mono_span.argtypes = [p, p, p, i64, p, p, i64, i32, i32, i32,
                                    ctypes.c_uint32, p]
        L.pgb_lane_gather_tdesc.argtypes = [p, p, p, i64, i64, i32, p]
        L.pgb_lane_gather_tasc.argtypes = [p, p, p, i64, i64, i32, i32, p]
        L.pgb_inner3.argtypes = [p, p, p, p, p, p, p, i64, i32, p]
        L.pgb_mono_rows.argtypes = [p, p, i32, p, i64, i64, p, i64, p, p,
                                    i64, i32, i32, i32, ctypes.c_uint32, p]
        L.pgb_mono_cascade.argtypes = [p, i64, p, p, i64, i32, i32, i32,
                                       ctypes.c_uint32, p]
        L.pgb_lane_gather.argtypes = [p, p, p, i64, i32, p]
        L.pgb_mid_pass.argtypes = [p, p, p, p, p, i64, i32, i32, p]
        L.pgb_pair_count.argtypes = [p, i64, p, i64, p, p, p, p, p, i64, i32,
                                     p]
        L.pgb_fill_keys.argtypes = [p, i64, p, i64, p, p, p, p, p, i64, i32,
                                    p]
        L.pgb_pair_fold.argtypes = [p, p, i64, p, p, i64, p, p, p, p, p, p,
                                    i64, i32, i32, i32, i32, i32,
                                    ctypes.c_uint32, p]
        L.pgb_segfold.argtypes = [p, p, p, i64, i32, i32, p,
                                  ctypes.c_uint32, p, p]
        L.pgb_segfold_tiles.argtypes = [i64]
        L.pgb_segfold_tiles.restype = i64
        L.pgb_esc_gather.argtypes = [p, p, i64, p, p, p, p, i64, p]
        for fn in (L.pgb_mono_span, L.pgb_lane_gather_tdesc,
                   L.pgb_lane_gather_tasc, L.pgb_inner3, L.pgb_mono_rows,
                   L.pgb_mono_cascade, L.pgb_lane_gather, L.pgb_mid_pass,
                   L.pgb_pair_count, L.pgb_fill_keys, L.pgb_pair_fold,
                   L.pgb_segfold, L.pgb_esc_gather):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(rc, name):
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


def on_card(t, name):
    """Whether a kernel wrapper launches its kernel for tensor `t`: False
    for a CPU tensor, and for a CUDA tensor of a dtype wider than 4 bytes,
    which the JAX package sends to XLA (its plain versions run on the
    card then); True for other CUDA tensors, 1- and 2-byte ones among
    them (the wrappers widen them to 4-byte words).  Raises for other
    devices.  Reads only the device and the dtype's size."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.dtype.itemsize <= 4


def value_type(t, *ops):
    """The GraphBLAS type whose values tensor `t` holds: that of the first
    op object given (a Monoid, BinaryOp or Type), else the type torch
    dtype t.dtype is read as (int32 -> INT32: the bit-view types UINT16,
    UINT32 and UINT64 always travel with their op objects)."""
    from . import types

    for op in ops:
        if op is None or isinstance(op, str):
            continue
        if isinstance(op, type) and issubclass(op, types.Type):
            return op
        if hasattr(op, "type_cls"):
            return op.type_cls
        return getattr(types, op.type)
    return types.from_torch_dtype(t.dtype)


def dtype_code(typ, name):
    """The kernels' dtype code for GraphBLAS type `typ`; raises TypeError
    for types wider than 4 bytes (their callers take the plain version:
    ``on_card``)."""
    code = TYPE_CODES.get(typ.__name__)
    if code is None:
        raise TypeError(f"{name}: the CUDA kernels take types of 4 bytes "
                        f"or less, not {typ.__name__}")
    return code


def monoid_of(fold, typ):
    """An add monoid given by name (at type `typ`) or as an object."""
    if fold is None or not isinstance(fold, str):
        return fold
    return getattr(typ, fold + "_MONOID")


def binaryop_of(mul, typ):
    """A binary op given by name (at type `typ`) or as an object."""
    if mul is None or not isinstance(mul, str):
        return mul
    return getattr(typ, mul)


def fold_code(monoid, typ, name):
    """The kernels' fold code for add monoid `monoid` over words of type
    `typ` (-1 for None); derived from its op's name.  Raises TypeError
    for a monoid no built-in code folds (a user monoid, which
    ``segfold`` and ``pair_fold`` take through ``_opgen`` where it
    lowers; a bitwise or logical one on float words)."""
    if monoid is None:
        return -1
    op = monoid.binaryop
    nm = op.op if op.builtin else None
    if typ.__name__ == "BOOL":
        nm = _BOOL_OPS.get(nm, nm)
    code = FOLDS.get(nm)
    if code is None or (typ._kind == "f" and nm not in _FLOAT_FOLDS):
        raise TypeError(f"{name}: no kernel fold for {monoid.name} over "
                        f"{typ.__name__}")
    return code


def mul_code(op, typ, name):
    """The kernels' mul code for binary op `op` over words of type `typ`
    (-1 for None); derived from its name.  Raises TypeError for an op
    with no code (a user op: ``pair_fold`` takes it through ``_opgen``
    where it lowers; a positional one)."""
    if op is None:
        return -1
    nm = op.op if op.builtin and op.positional is None else None
    if typ.__name__ == "BOOL":
        nm = _BOOL_OPS.get(nm, nm)
    code = MULS.get(nm)
    if code is None:
        raise TypeError(f"{name}: no kernel multiply for {op.name} over "
                        f"{typ.__name__}")
    return code


def fold_fill(monoid, typ):
    """The fill a kernel folds with for `monoid` over type `typ` (a
    numpy scalar): the monoid's identity, except ANY, which the kernels
    fold as MAX (any product is the largest of some products, and an
    identity lane never beats a product): the type's least value, MAX's
    identity (from the table: ``typ.MAX_MONOID`` is rebound by
    ``new_monoid``, as ``algorithms.relu_neuron_semiring`` does)."""
    if monoid.binaryop.builtin and monoid.binaryop.op == "ANY" \
            and typ.__name__ != "BOOL":
        return table.MONOIDS["MAX"][1](typ.numpy_dtype)
    return monoid.identity(typ.numpy_dtype)


def fold_fn(monoid, typ):
    """The torch closure the fold kernels' plain versions fold with: the
    monoid's, except ANY, which they fold as the kernels do (MAX; LOR
    over BOOL)."""
    if monoid.binaryop.builtin and monoid.binaryop.op == "ANY":
        return (typ.LOR_MONOID if typ.__name__ == "BOOL"
                else typ.MAX_MONOID).apply
    return monoid.apply


def to_words(t, typ):
    """Values of type `typ` (held dtype) -> the 4-byte words a kernel
    reads: float32 or int32 as they are, BOOL, INT8, INT16 and UINT8
    widened by value, UINT16 (an int16 bit view) zero-extended."""
    if t.dtype.itemsize >= 4:
        return t
    w = t.to(torch.int32)
    return w & 0xFFFF if typ.__name__ == "UINT16" else w


def from_words(w, typ):
    """Kernel words -> values of type `typ` (held dtype): narrow ones
    keep their low bits (a fold that wrapped in 32 bits wraps the same
    at its own width), BOOL is nonzero."""
    if w.dtype == typ.torch_dtype:
        return w
    if typ.__name__ == "BOOL":
        return w != 0
    return w.to(typ.torch_dtype)


def widen(t):
    """Any 1- or 2-byte tensor -> int32 words for a kernel that only
    moves data, and the function that narrows its result back (the same
    bits: a 2-byte float goes through its int16 bit view)."""
    if t.dtype.itemsize == 4:
        return t, lambda w: w
    dt = t.dtype
    if dt.is_floating_point:
        return (t.view(torch.int16).to(torch.int32),
                lambda w: w.to(torch.int16).view(dt))
    if dt == torch.bool:
        return t.to(torch.int32), lambda w: w != 0
    return t.to(torch.int32), lambda w: w.to(dt)


def word_code(t):
    """The dtype code of a 4-byte word tensor for a kernel that only
    moves data (float32 words or int32 words)."""
    return TYPE_CODES["FP32"] if t.dtype == torch.float32 else \
        TYPE_CODES["INT32"]


def fill_bits(fill, typ):
    """The 32 bits of scalar `fill` (a value of type `typ`) as a kernel
    word, as an int."""
    if typ.__name__ == "FP32":
        return int(np.asarray(fill, np.float32).reshape(1)
                   .view(np.uint32)[0])
    v = np.asarray(fill).astype(typ.numpy_dtype).astype(np.int64)
    return int(v.astype(np.uint32))


def cuda_args(name, *tensors):
    """Check that every tensor lies on the card and is contiguous."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: mixed devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
