"""K-Truss decomposition via iterated masked SpGEMM.

The k-truss of a graph is the maximal subgraph where every edge is
supported by >= k-2 triangles (reference `K-Truss.ipynb`): compute
per-edge support with C<A> = A @ A plus_pair, drop weak edges, repeat
until the edge set is stable.  Oracle: the same fixed point in scipy.

Run: python demo_torch/04_ktruss.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import k_truss  # noqa: E402

KS = (3, 4, 5, 6)


def graph():
    """Holme-Kim power-law clustered graph: 800 vertices, 10 edges each,
    triangle probability 0.5, seed 11."""
    return graphs.powerlaw_cluster(800, 10, 0.5, seed=11)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.INT64, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.int64))

    for k in KS:
        T = k_truss(A, k, device=dev)
        want = graphs.k_truss_edges(rows, cols, n, k)
        print(f"{k}-truss: {T.nvals} directed edges (scipy: {want})")
        assert T.nvals == want
    print("OK")


if __name__ == "__main__":
    main()
