"""Triangle counting: masked SpGEMM in three formulations.

total = sum over edges of |N(u) ∩ N(v)| computed as C<L> = L @ L with
the plus_pair semiring (reference `TriangleCentrality.ipynb` and the
GraphChallenge formulation; BASELINE config[2]).  Oracle: the row sums
of (A @ A) .* A in scipy.

Run: python demo_torch/03_triangle_counting.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import triangle_count  # noqa: E402


def graph():
    """Holme-Kim power-law clustered graph: 2000 vertices, 8 edges each,
    triangle probability 0.3, seed 4."""
    return graphs.powerlaw_cluster(2000, 8, 0.3, seed=4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.BOOL, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.bool_))

    want = int(round(graphs.triangles(rows, cols, n).sum() / 3))
    for method in ("sandia", "cohen", "sandia_dot"):
        got = triangle_count(A, method, device=dev)
        print(f"{method:11s}: {got} triangles")
        assert got == want, (got, want)
    print(f"scipy      : {want} triangles")
    print("OK")


if __name__ == "__main__":
    main()
