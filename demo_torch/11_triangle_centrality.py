"""Triangle centrality (Burkhardt): rank vertices by the triangles in
their neighborhood, computed with masked plus_pair SpGEMM + two SpMVs.

TC(v) = (3*A@y - 2*That@y + y) / k  where y = per-vertex triangle
counts (reference `TriangleCentrality.ipynb`).  Oracle: brute-force
numpy triangle enumeration.

Run: python demo_torch/11_triangle_centrality.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import triangle_centrality  # noqa: E402


def graph():
    """Holme-Kim power-law clustered graph: 800 vertices, 6 edges each,
    triangle probability 0.3, seed 9."""
    return graphs.powerlaw_cluster(800, 6, 0.3, seed=9)


def oracle(rows, cols, n):
    """(TC, y): Burkhardt's centrality by brute force, and y, twice the
    triangles at each vertex."""
    Ad = np.zeros((n, n))
    Ad[rows, cols] = 1.0
    T = (Ad @ Ad) * Ad                      # common neighbours per edge
    y = T.sum(axis=1)                       # 2x triangles at each vertex
    k = y.sum()
    That = (T != 0).astype(float)           # triangle-edge pattern
    tc = (3.0 * Ad @ y - 2.0 * That @ y + y) / k if k else y
    return tc, y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.FP64, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.float64))

    tc = triangle_centrality(A, device=dev)
    got = np.zeros(n)
    for i, v in tc:
        got[i] = v

    want, _ = oracle(rows, cols, n)
    err = np.max(np.abs(got - want))
    assert err < 1e-8, err
    top = np.argsort(-got)[:5]
    print("top-5 by triangle centrality:", top.tolist())
    print(f"max abs error vs brute force: {err:.2e}")
    print("OK")


if __name__ == "__main__":
    main()
