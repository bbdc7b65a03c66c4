"""Kronecker graph generation at huge logical dimensions.

`kronecker` expands a small seed adjacency into a scale-free graph whose
logical dimension squares at every step — the hypersparse tier keeps
memory O(nnz), exactly like the reference's Kronecker/Sierpinski
notebooks over 2^60-dim matrices.

Run: python demo_torch/06_kronecker_graphs.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pygraphblas_tpu_torch import Matrix  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    seed = Matrix.from_lists([0, 0, 1, 1, 2], [0, 1, 1, 2, 0],
                             [1.0, 1.0, 1.0, 1.0, 1.0], device=dev)
    print("seed graph:")
    print(seed)

    G = seed.dup()
    for step in range(6):
        G = G.kronecker(G) if step < 2 else G.kronecker(seed)
        print(f"after step {step + 1}: shape={G.shape} nvals={G.nvals}")

    deg = G.out_degree()
    print("max out-degree:", deg.max(), " vertices with edges:", deg.nvals)
    assert G.nvals == 5 ** 8  # |E| multiplies per kron step
    print("OK")


if __name__ == "__main__":
    main()
