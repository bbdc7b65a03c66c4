"""pygraphblas_tpu_torch: the PyTorch/CUDA port of pygraphblas_tpu.

The slice ported so far is the main path: whole-loop PageRank
(``fused.pagerank``) over the gather-free semiring SpMV
(``core/xspmv.py``), with its four hand-written CUDA kernels for Hopper
(``csrc/*.cu``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, which runs each kernel's plain PyTorch version.

Imports torch and numpy only: nothing of JAX or of pygraphblas_tpu.
"""

from . import types
from .base import config, options_set
from .matrix import Matrix
from .vector import Vector
from ._device import resolve_device

__all__ = ["types", "config", "options_set", "Matrix", "Vector",
           "resolve_device"]
