"""Single-source shortest paths: the MIN_PLUS semiring relaxation.

d = d min.+ A, iterated to fixpoint — the classic algebraic
Bellman-Ford (reference `SSSP.ipynb`).  Oracle: scipy's Dijkstra.

Run: python demo_torch/08_sssp.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
from scipy.sparse import csgraph  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import sssp  # noqa: E402


def graph():
    """A connected Watts-Strogatz graph (1500 vertices, 6 neighbours,
    rewiring 0.4, seed 7) with integer weights 1..9, the same both ways:
    (rows, cols, n, weights)."""
    rows, cols, n = graphs.watts_strogatz(1500, 6, 0.4, seed=7)
    rng = np.random.RandomState(7)
    lo = rows < cols
    w = rng.randint(1, 10, int(lo.sum())).astype(np.float64)
    W = graphs.adjacency(rows[lo], cols[lo], n, w)
    W = (W + W.T).tocsr()
    return rows, cols, n, np.asarray(W[rows, cols]).ravel()


def oracle(rows, cols, n, wts, source=0):
    """{vertex: distance} of the vertices reachable from `source`."""
    d = csgraph.dijkstra(graphs.adjacency(rows, cols, n, wts),
                         indices=source)
    return {int(i): float(d[i]) for i in np.flatnonzero(np.isfinite(d))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n, wts = graph()
    A = Matrix.sparse(types.FP64, n, n, device=dev)
    A._build(rows, cols, wts)

    d = sssp(A, 0, device=dev)
    got = dict(d)
    want = oracle(rows, cols, n, wts)
    assert len(got) == len(want)
    for node, dist in want.items():
        assert abs(got[node] - dist) < 1e-9, (node, got[node], dist)
    print(f"sssp from 0: {len(got)} reachable, "
          f"max distance {max(got.values()):.0f} (scipy agrees)")
    print("OK")


if __name__ == "__main__":
    main()
