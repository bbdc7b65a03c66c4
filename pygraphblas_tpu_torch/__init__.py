"""pygraphblas_tpu_torch: the PyTorch/CUDA port of pygraphblas_tpu.

Ported so far: the GraphBLAS containers ``Matrix`` and ``Vector``
(bitmap, COO and iso formats, masks, accumulators, descriptors; the
element-wise, apply, select, reduce, mxv/vxm and mxm families) with
their XLA-only tiers in plain torch (``core/dense.py``, ``csr8.py``,
``spmspv.py``, ``sparse.py``, ``dewise.py``, ``coosem.py``,
``coosparse.py``); the algebra (``types``, ``binaryop``, ``unaryop``,
``monoid``, ``semiring``, ``selectop``, ``descriptor``, ``scalar`` and
``base``, from the tables of ``ops/table.py``: every type, operator,
monoid and semiring name of the JAX package); the gather-free semiring
SpMV (``core/xspmv.py``) and the fused loops over it
(``fused.pagerank``, ``bfs_level``, ``bfs_batch``, ``sssp``, ``bc``);
the masked SpGEMM (``core/spgemm.py``) with the container algorithms
(``algorithms.pagerank``, ``sssp``, ``bfs_level``, ``bfs_parents`` and
their vxm forms, ``triangle_count``, ``triangle_centrality``,
``betweenness_centrality``, ``k_truss``, ``louvain_cluster``); the
unmasked SpGEMM (``core/gustavson.py``, with the expand/sort/compact
engine ``core/esc.py`` and the dense tier ``core/dense.py``); the
frontier BFS (``fused.bfs_frontier``) and the GraphChallenge sparse DNN
(``fused.dnn``, ``algorithms.dnn``, ``hyperdnn``); and the I/O
(``io/``: MatrixMarket, TSV/CSV, the binary checkpoint) with the
drawing helpers (``gviz``).  Thirteen
hand-written CUDA kernels for Hopper (``csrc/*.cu``), one for each
Pallas kernel of the JAX package, carry them.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"`` (a container's
constructors take ``device=``), which runs each kernel's plain PyTorch
version.

Imports torch, numpy and scipy only: nothing of JAX or of
pygraphblas_tpu.
"""

from .base import (
    NULL,
    GxB_INDEX_MAX,
    GxB_IMPLEMENTATION,
    GxB_SPEC,
    config,
    options_get,
    options_set,
    perf_report,
    GraphBLASException,
    NoValue,
    UninitializedObject,
    InvalidObject,
    NullPointer,
    InvalidValue,
    InvalidIndex,
    DomainMismatch,
    DimensionMismatch,
    OutputNotEmpty,
    OutOfMemory,
    InsufficientSpace,
    IndexOutOfBound,
    Panic,
)

IMPLEMENTATION_MAJOR, IMPLEMENTATION_MINOR, IMPLEMENTATION_SUB = \
    GxB_IMPLEMENTATION
IMPLEMENTATION_VERSION = GxB_IMPLEMENTATION

__version__ = "1.0.0"


def get_version():
    """The package's version."""
    return __version__


def init(blocking=False):
    """Library initialization: nothing to do (torch and the kernels
    initialize at first use); kept for API parity."""
    return None

__pdoc__ = {}

# Build the operator registries, in the JAX package's order.
from .semiring import build_semirings, current_semiring
from .binaryop import (build_binaryops, Accum, binary_op, current_binop,
                       current_accum)
from .unaryop import build_unaryops, unary_op
from .selectop import build_selectops, select_op
from .monoid import build_monoids, current_monoid

build_binaryops(__pdoc__)
build_unaryops(__pdoc__)
build_monoids(__pdoc__)
build_semirings(__pdoc__)
build_selectops(__pdoc__)

from . import types
from . import descriptor
from . import selectop
from . import unaryop
from . import binaryop
from . import monoid
from . import semiring
from .matrix import Matrix
from .vector import Vector
from .scalar import Scalar
from ._device import resolve_device

from .types import (
    BOOL,
    FP64,
    FP32,
    FC64,
    FC32,
    INT64,
    INT32,
    INT16,
    INT8,
    UINT64,
    UINT32,
    UINT16,
    UINT8,
    promote,
    binop,
    Type,
)

__all__ = [
    "GxB_INDEX_MAX", "GxB_IMPLEMENTATION", "GxB_SPEC", "Matrix", "Vector",
    "Scalar", "Accum", "BOOL", "FP64", "FP32", "FC64", "FC32", "INT64",
    "INT32", "INT16", "INT8", "UINT64", "UINT32", "UINT16", "UINT8",
    "descriptor", "selectop", "binary_op", "unary_op", "select_op",
    "options_set", "options_get", "types", "config", "resolve_device",
    "perf_report", "run_doctests",
]


def run_doctests(raise_on_error=False):
    """Run every docstring example of the package's user modules (the
    JAX package's ``run_doctests``, over the port's modules); returns
    the number that failed.  The examples run on the CPU where they name
    ``device="cpu"``."""
    import doctest
    import sys

    from . import algorithms as algorithms_module
    from . import base as base_module
    from . import gviz as gviz_module
    from . import matrix as matrix_module
    from . import scalar as scalar_module
    from . import vector as vector_module

    this = sys.modules[__name__]
    failures = 0
    for mod in (this, selectop, unaryop, binaryop, matrix_module,
                vector_module, scalar_module, monoid, semiring, types,
                gviz_module, algorithms_module, descriptor, base_module):
        extraglobs = dict(
            Matrix=Matrix, Vector=Vector, Scalar=Scalar, types=types,
            descriptor=descriptor, GxB_INDEX_MAX=GxB_INDEX_MAX,
        )
        r = doctest.testmod(mod, optionflags=doctest.ELLIPSIS,
                            raise_on_error=raise_on_error,
                            extraglobs=extraglobs)
        failures += r.failed
    return failures
