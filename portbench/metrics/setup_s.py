"""Seconds from the process's start to the window's: imports, the
kernels' build or load, the graph, the program's matrix, its xspmv plan
(built, or loaded from the plan cache) and the warm-up calls."""


def read(rec):
    return rec.setup_s
