"""Batched betweenness centrality: masked PLUS_FIRST SpMM sweeps.

Brandes forward/backward over a batch of sources held as rows of one
matrix (reference `gap/bcmark.py:16-67`, `BetweennessCentrality.ipynb`).
Oracle: Brandes' accumulation in Python from the same sources.

Run: python demo_torch/09_betweenness_centrality.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import betweenness_centrality  # noqa: E402

SOURCES = [3, 17, 42, 99]


def graph():
    """Holme-Kim power-law clustered graph: 600 vertices, 4 edges each,
    triangle probability 0.2, seed 11."""
    return graphs.powerlaw_cluster(600, 4, 0.2, seed=11)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.FP32, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.float32))

    c = betweenness_centrality(A, SOURCES, device=dev)
    got = np.zeros(n)
    for i, v in c:
        got[i] = v

    # every ordered (source, target) pair: the batched matrix formulation
    # accumulates both directions
    want = graphs.brandes(rows, cols, n, SOURCES)
    err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    assert err < 1e-3, err
    top = np.argsort(-got)[:5]
    print("top-5 central vertices:", top.tolist())
    print(f"max relative error vs Brandes: {err:.2e}")
    print("OK")


if __name__ == "__main__":
    main()
