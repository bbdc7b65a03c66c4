"""Global options, at the size the port needs so far.

``spmv_engine`` mirrors ``pygraphblas_tpu.base.config.spmv_engine``:
"auto" takes the xspmv pipeline when the semiring and size support it,
"xspmv" forces it, "csr8" forces the csr8 engine (not ported yet).

``spgemm_engine`` and ``spgemm_dense_cells`` mirror the JAX package's
unmasked SpGEMM options (pygraphblas_tpu/base.py:188-192): "auto" tries
the compact-dense tier within ``spgemm_dense_cells`` cells, then the
expand/sort/compact engine (core/esc.py) on the card, then the host
two-phase tiers; "dense", "esc" and "scipy" force one tier."""

from dataclasses import dataclass


@dataclass
class _Config:
    spmv_engine: str = "auto"
    spgemm_engine: str = "auto"
    spgemm_dense_cells: int = 1 << 24


config = _Config()


def options_set(spmv_engine=None, spgemm_engine=None,
                spgemm_dense_cells=None):
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
