"""pygraphblas_tpu_torch: the PyTorch/CUDA port of pygraphblas_tpu.

Ported so far: the gather-free semiring SpMV (``core/xspmv.py``) and
the fused loops over it (``fused.pagerank``, ``bfs_level``,
``bfs_batch``, ``sssp``, ``bc``); the masked SpGEMM
(``core/spgemm.py``) with ``algorithms.triangle_count`` and
``k_truss``; and the unmasked SpGEMM (``core/gustavson.py``, with the
expand/sort/compact engine ``core/esc.py``).  Thirteen hand-written CUDA
kernels for Hopper (``csrc/*.cu``), one for each Pallas kernel of the
JAX package, carry them.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, which runs each kernel's plain PyTorch
version.

Imports torch, numpy and scipy only: nothing of JAX or of
pygraphblas_tpu.
"""

from . import types
from .base import config, options_set
from .matrix import Matrix
from .vector import Vector
from ._device import resolve_device

__all__ = ["types", "config", "options_set", "Matrix", "Vector",
           "resolve_device"]
