"""Hand-kernel launches a PageRank iteration: the window's
``_kernels.launches`` delta over the ``core.xspmv.xspmv`` calls that
the harness's span around it counted (one call an iteration)."""


def read(rec):
    if not rec.xspmv_calls:
        return None
    return sum(rec.launches.values()) / rec.xspmv_calls
