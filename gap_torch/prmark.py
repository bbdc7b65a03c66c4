"""GAP PageRank benchmark driver (reference: ``gap/prmark.py``).

Usage: python gap_torch/prmark.py [--scale N] [--rounds R]
[--graph kron|urand] [--device cpu]
Loads/generates the graph, runs PageRank for the configured rounds, and
prints per-round wall time, mean, and nnz/s.  The graph and the rounds
live on the CUDA card unless --device names another device.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--edgefactor", type=int, default=16)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--graph", default="kron", choices=["kron", "urand"])
    p.add_argument("--binfile", default=None,
                   help="load a .npz binary checkpoint instead of generating")
    p.add_argument("--eager", action="store_true",
                   help="use the eager per-op path instead of the fused loop")
    p.add_argument("--engine", default=None, choices=["auto", "csr8", "xspmv"],
                   help="SpMV engine (csr8 skips the xspmv plan build; "
                        "right choice for one-shot runs)")
    p.add_argument("--async-plan", action="store_true",
                   help="never block on the xspmv plan build: rounds run "
                        "the planless COO tier immediately and upgrade "
                        "once the background build lands (first-touch "
                        "tiering for fresh GAP-scale graphs)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the graph and the rounds")
    return p


def sync(dev, result):
    """Wait for the round: the card's queue, then one host read of the
    result."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return float(result._dense_pair()[0].sum())


def run(args, stats=None):
    """The rounds of `args` (``parser()``'s options); returns the last
    round's ranks (an FP32 Vector).  A `stats` dict, when given, gets
    each round's seconds ("rounds_s") and the graph's entries ("nnz").
    The SpMV options are restored on return."""
    from pygraphblas_tpu_torch import fused, types
    from pygraphblas_tpu_torch._device import resolve_device
    from pygraphblas_tpu_torch.algorithms import pagerank
    from pygraphblas_tpu_torch.base import config, options_set
    from pygraphblas_tpu_torch.generators import (rmat_edges, to_matrix,
                                                  urand_edges)
    from pygraphblas_tpu_torch.matrix import Matrix

    dev = resolve_device(args.device)
    saved = (config.spmv_engine, config.spmv_plan_async)
    try:
        if args.engine:
            options_set(spmv_engine=args.engine)
        if args.async_plan:
            options_set(spmv_plan_async=True)

        if args.binfile:
            A = Matrix.binread(args.binfile, device=dev)
            nnz = A.nvals
        else:
            gen = rmat_edges if args.graph == "kron" else urand_edges
            rows, cols, n = gen(args.scale, args.edgefactor)
            A = to_matrix(rows, cols, n, types.FP32, device=dev)
            nnz = len(rows)

        d = A.reduce_vector(types.FP32.PLUS_MONOID)

        rounds = []
        for r in range(args.rounds):
            start = time.perf_counter()
            if args.eager:
                result = pagerank(A, damping=0.85, itermax=100, tol=1e-4,
                                  d=d.dup(), device=dev)
            else:  # whole-loop-fused production path
                result = fused.pagerank(A, damping=0.85, itermax=100,
                                        tol=1e-4, device=dev)
            sync(dev, result)
            elapsed = time.perf_counter() - start
            rounds.append(elapsed)
            print(f"round {r}: {elapsed:.4f}s")
        mean = sum(rounds) / len(rounds)
        print(f"mean: {mean:.4f}s  nnz/s per full run: {nnz / mean:.3e}")
    finally:
        options_set(spmv_engine=saved[0], spmv_plan_async=saved[1])
    if stats is not None:
        stats.update(rounds_s=rounds, nnz=nnz)
    return result


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
