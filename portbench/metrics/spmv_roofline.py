"""The xspmv SpMV's share of its memory roofline, in %.

Probe (after the window of a traced run): CUDA events over back-to-back
``core.xspmv.xspmv`` calls (PLUS_SECOND over FP32, y = A^T x) on the
cell's own plan and an x drawn from the seed, queued behind a sleep
kernel so that the host's launches do not pace them.  The bound counts
bytes that any SpMV of this matrix needs (``yardstick.spmv_bytes``),
whatever implements it, at the card's peak bandwidth."""

import numpy as np
import torch

from portbench import yardstick

REPS = 50


def probe(ctx, rec):
    if ctx.device.type != "cuda":
        return
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.core import xspmv as xs

    plan = ctx.A._xspmv_plan(True, np.float32, device=ctx.device)
    x = torch.rand(ctx.n, generator=ctx.gen, device=ctx.device)
    sem = types.FP32.PLUS_SECOND
    ms = yardstick.event_ms(lambda: xs.xspmv(plan, x, sem, np.float32),
                            REPS)
    rec.probes["spmv_ms"] = ms


def read(rec):
    ms = rec.probes.get("spmv_ms")
    peak = yardstick.peak(rec.device_kind)
    if not ms or peak is None:
        return None
    nbytes = yardstick.spmv_bytes(rec.nnz, rec.n, rec.n)
    return 100.0 * (nbytes / peak["hbm_bytes_per_s"]) / (ms / 1e3)
