"""Time the build of the port's CUDA kernels, one source at a time.

    python perf/torch_build_times.py [CSRC_DIR ...]

For each directory (default: ``pygraphblas_tpu_torch/csrc``) it runs
``pygraphblas_tpu_torch/_kernels.build`` on that directory's sources into
a fresh temporary build directory, and prints one JSON line a directory:
the wall seconds of the whole build and, for each source, its seconds
from the build's start (``_kernels.build_seconds``) and nvcc's time for
each of its phases (``_kernels.build_phases``: cicc, ptxas, ...).  The
directories are built one after the other, so they do not share the
cores.  Needs ``nvcc``; run it on the machine with the card.
"""

import json
import os
import shutil
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from pygraphblas_tpu_torch import _kernels  # noqa: E402


def time_dir(csrc):
    work = tempfile.mkdtemp()
    saved = _kernels.CSRC, _kernels.BUILD_DIR
    _kernels.CSRC, _kernels.BUILD_DIR = os.path.abspath(csrc), work
    try:
        t0 = time.perf_counter()
        _kernels.build()
        wall = time.perf_counter() - t0
        return {"dir": csrc, "wall_s": round(wall, 2), "sources": {
            k: {"s": round(v, 2), "phases": _kernels.build_phases.get(k, {})}
            for k, v in sorted(_kernels.build_seconds.items())}}
    finally:
        _kernels.CSRC, _kernels.BUILD_DIR = saved
        shutil.rmtree(work, ignore_errors=True)


def main(argv):
    for d in argv or [_kernels.CSRC]:
        print(json.dumps(time_dir(d)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
