"""GAP Betweenness-Centrality benchmark driver (reference:
``gap/bcmark.py``): batched push-pull SpMM frontiers with accumulation.

Usage: python gap_torch/bcmark.py [--scale N] [--rounds R] [--batch B]
[--device cpu]  (the CUDA card unless --device names another device)
"""

import argparse
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=int, default=10)
    p.add_argument("--edgefactor", type=int, default=16)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--eager", action="store_true",
                   help="use the eager per-op path instead of the fused loop")
    p.add_argument("--device", default="cuda",
                   help="torch device of the graph and the rounds")
    return p


def sources(n, rounds, batch):
    """The batches of sources of every round (stdlib random, seed 42, as
    the reference draws them)."""
    rng = random.Random(42)
    return [[rng.randint(0, n - 1) for _ in range(batch)]
            for _ in range(rounds)]


def run(args, stats=None):
    """The rounds of `args` (``parser()``'s options); returns the last
    round's centrality (an FP32 Vector).  A `stats` dict, when given,
    gets each round's seconds ("rounds_s") and the graph's entries
    ("nnz")."""
    from gap_torch.prmark import sync
    from pygraphblas_tpu_torch import fused, types
    from pygraphblas_tpu_torch._device import resolve_device
    from pygraphblas_tpu_torch.algorithms import betweenness_centrality
    from pygraphblas_tpu_torch.generators import rmat_edges, to_matrix

    dev = resolve_device(args.device)
    rows, cols, n = rmat_edges(args.scale, args.edgefactor)
    A = to_matrix(rows, cols, n, types.FP32, device=dev)
    AT = A.T

    rounds = []
    for r, batch in enumerate(sources(n, args.rounds, args.batch)):
        start = time.perf_counter()
        if args.eager:
            bc = betweenness_centrality(A, batch, AT, device=dev)
        else:
            bc = fused.bc(A, batch, device=dev)
        sync(dev, bc)
        elapsed = time.perf_counter() - start
        rounds.append(elapsed)
        print(f"round {r}: {elapsed:.4f}s")
    print(f"mean: {sum(rounds) / len(rounds):.4f}s")
    if stats is not None:
        stats.update(rounds_s=rounds, nnz=len(rows))
    return bc


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
