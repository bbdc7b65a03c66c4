"""Louvain community detection: modularity-gain local moves as
semiring SpGEMM (H = W @ M) plus community contraction (P^T W P).

Reference `Louvain.ipynb` validates the same algorithm against
python-louvain; here the oracle is the modularity (numpy) of a planted
partition: the recovered partition must score at least as well, less
0.02.

Run: python demo_torch/10_louvain.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import louvain_cluster  # noqa: E402

BLOCKS, SIZE = 5, 200


def graph():
    """5 planted groups of 200 vertices, p_in 0.10, p_out 0.003, seed 3."""
    return graphs.planted_partition(BLOCKS, SIZE, 0.10, 0.003, seed=3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rows, cols, n = graph()
    A = Matrix.sparse(types.FP32, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.float32))

    lab = louvain_cluster(A, device=dev)
    labels = np.zeros(n, np.int64)
    for i, v in lab:
        labels[i] = v
    ncomm = int(labels.max()) + 1
    mod = graphs.modularity(rows, cols, n, labels)
    mod_planted = graphs.modularity(rows, cols, n,
                                    np.arange(n) // SIZE)

    print(f"found {ncomm} communities, modularity {mod:.4f} "
          f"(planted partition: {mod_planted:.4f})")
    assert mod >= mod_planted - 0.02, (mod, mod_planted)
    print("OK")


if __name__ == "__main__":
    main()
