"""PageRank on a random graph, two ways, against a numpy oracle.

- `algorithms.pagerank`: the GAP formulation (masked transposed
  plus_second SpMV, reference gap/prmark.py)
- `fused.pagerank`: the whole iteration loop on the device, its SpMV
  the gather-free xspmv engine once the graph is large enough
- power iteration in numpy as the oracle

Run: python demo_torch/02_pagerank.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, fused, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import pagerank  # noqa: E402


def graph():
    """500 vertices, 4000 directed edges: G(n, m), seed 2."""
    return graphs.gnm(500, 4000, seed=2, directed=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.FP32, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.float32))

    expect = graphs.pagerank(rows, cols, n, alpha=0.85)
    r = pagerank(A, damping=0.85, tol=1e-8, device=dev)
    got = r.to_numpy()
    err = float(np.max(np.abs(got - expect)))
    print(f"pagerank: n={n} max|err| vs power iteration = {err:.2e}")
    assert err < 1e-3

    f = fused.pagerank(A, damping=0.85, itermax=100, tol=1e-8, device=dev)
    ferr = float(np.max(np.abs(f.to_numpy() - expect)))
    print(f"fused.pagerank: max|err| vs power iteration = {ferr:.2e}")
    assert ferr < 1e-3

    top = np.argsort(got)[::-1][:5]
    print("top-5 vertices:", top.tolist())
    print("OK")


if __name__ == "__main__":
    main()
