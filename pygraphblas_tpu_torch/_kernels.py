"""Build, load and count the port's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, loaded with ctypes.  The build lands in
``_build/`` (listed in ``.gitignore``) under a name carrying a hash of
the sources, at first use: importing this module compiles nothing.

``launches`` counts kernel launches by name.  Each wrapper adds one
exactly where it launches its kernel, so a run can show which kernels
its path went through (``reset_launches`` before, read after).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches since the last reset
launches = {"mono_span": 0, "mono_cascade": 0, "mono_rows": 0,
            "lane_gather": 0, "lane_gather_tdesc": 0, "lane_gather_tasc": 0,
            "inner3": 0, "mid_pass": 0, "pair_count": 0, "fill_keys": 0,
            "pair_fold": 0, "segfold": 0, "esc_gather": 0}

_lib = None
build_log = ""

# torch dtype -> csrc/ops.cuh dtype code
DTYPES = {torch.float32: 0, torch.int32: 1}


def reset_launches():
    for k in launches:
        launches[k] = 0


def count(name):
    launches[name] += 1


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


def build():
    """Compile the kernels (one nvcc per source, in parallel) and link
    them into one library; returns its path.  Reuses a finished build of
    the same sources."""
    global build_log
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
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                   "-Xcompiler", "-fPIC", "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{text}")
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
    card then); True for other CUDA tensors.  Raises for other devices.
    Reads only the device and the dtype's size."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.dtype.itemsize <= 4


def dtype_code(t, name):
    """The kernel's dtype code for tensor t; raises TypeError for other
    dtypes (1- or 2-byte ones: no entry point of the port passes one)."""
    code = DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or int32, "
                        f"not {t.dtype}")
    return code


def fill_bits(fill, dtype):
    """The 32 bits of scalar `fill` in the kernel dtype, as an int."""
    npt = np.float32 if dtype == torch.float32 else np.int32
    return int(np.asarray(fill, npt).reshape(1).view(np.uint32)[0])


def cuda_args(name, *tensors):
    """Check that every tensor lies on the card and is contiguous."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: mixed devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
