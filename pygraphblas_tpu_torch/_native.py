"""Host-side native code through ctypes: the Benes routing
(``csrc/benes.cpp``) here, and the MatrixMarket parser and COO
canonicaliser (``csrc/fastio.cpp``) for ``io/native.py``.

Each library is built with ``g++`` at first use into ``_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source, so an
edited source is rebuilt and concurrent builds (test workers) never
load a half-written file."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")

_lib = None


def build(source):
    """The shared library built from ``csrc/<source>`` (built now if this
    source's hash has none yet); a failed build raises
    CalledProcessError."""
    src = os.path.join(_HERE, "csrc", source)
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"libpgb_{stem}_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 "-o", tmp, src], check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def available():
    """True when a C++ compiler is present (the library builds)."""
    return _lib is not None or shutil.which("g++") is not None


def lib():
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build("benes.cpp"))
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        L.pgb_benes_color.argtypes = [p, p, i64, i64, i64, ctypes.c_int, p]
        L.pgb_benes_color.restype = ctypes.c_int
        L.pgb_benes_stages.argtypes = [p, i64, i64, i64, i64, p]
        L.pgb_benes_stages.restype = ctypes.c_int
        _lib = L
    return _lib


def benes_color(u, v, n_left, n_right, bits=7):
    """Exact 2^bits-coloring of a 2^bits-regular bipartite multigraph
    with edges (u[i], v[i]); returns uint8 colors."""
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    color = np.empty(len(u), np.uint8)
    rc = lib().pgb_benes_color(u.ctypes.data, v.ctypes.data, len(u),
                               int(n_left), int(n_right), int(bits),
                               color.ctypes.data)
    if rc:
        raise ValueError("benes_color: bad arguments")
    return color


def benes_stages(src, D, S, R0):
    """Whole-plan K == 128 routing: returns (a_stages (D,R0,128),
    c_stages (D,R0,128), ssel (128^(D-1),S,128) or None), all int8."""
    src = np.ascontiguousarray(src, np.int64)
    Np = R0 * 128
    nsub = 128 ** (D - 1)
    ssel_sz = nsub * S * 128 if S > 1 else 0
    buf = np.empty(2 * D * Np + ssel_sz, np.int8)
    rc = lib().pgb_benes_stages(src.ctypes.data, len(src), int(D), int(S),
                                int(R0), buf.ctypes.data)
    if rc:
        raise ValueError("benes_stages: bad arguments")
    a = buf[:D * Np].reshape(D, R0, 128)
    c = buf[D * Np:2 * D * Np].reshape(D, R0, 128)
    ssel = buf[2 * D * Np:].reshape(nsub, S, 128) if S > 1 else None
    return a, c, ssel
