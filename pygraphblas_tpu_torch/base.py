"""Global options, at the size the port needs so far.

``spmv_engine`` mirrors ``pygraphblas_tpu.base.config.spmv_engine``:
"auto" takes the xspmv pipeline when the semiring and size support it,
"xspmv" forces it, "csr8" forces the csr8 engine (not ported yet)."""

from dataclasses import dataclass


@dataclass
class _Config:
    spmv_engine: str = "auto"


config = _Config()


def options_set(spmv_engine=None):
    if spmv_engine is not None:
        if spmv_engine not in ("auto", "csr8", "xspmv"):
            raise ValueError("spmv_engine must be auto|csr8|xspmv")
        config.spmv_engine = spmv_engine
