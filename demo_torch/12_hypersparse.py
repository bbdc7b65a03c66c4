"""Hypersparse matrices: 2^60 logical dimensions with O(nnz) storage.

The reference's hypersparse walkthrough
(`Hypersparse-RadiX-Net-with-pygraphblas.ipynb`) shows GraphBLAS
containers addressed by huge logical index spaces.  Here: a graph on
randomly-scattered 60-bit vertex ids, BFS-style reachability, degree
vectors, extract/assign, and O(1) iso vectors — all at n = 2^60.

Run: python demo_torch/12_hypersparse.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from pygraphblas_tpu_torch import Matrix, Vector, types  # noqa: E402

N = 1 << 60


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    rng = np.random.RandomState(5)

    # a ring + chords over 4096 vertices scattered through the 2^60 space
    ids = np.unique(rng.randint(0, N, 4096, dtype=np.int64))
    m = len(ids)
    src = np.concatenate([ids, ids])
    dst = np.concatenate([np.roll(ids, -1), ids[rng.permutation(m)]])
    keep = src != dst
    src, dst = src[keep], dst[keep]

    A = Matrix.sparse(types.FP32, N, N, device=dev)
    A._build(src, dst, np.ones(len(src), np.float32))
    print(f"A: {A.nrows} x {A.ncols} logical, {A.nvals} stored edges")
    n_uniq = len({(int(s), int(d)) for s, d in zip(src, dst)})
    assert A.nrows == N and A.nvals == n_uniq

    # degree vector at 2^60 via plus_pair against an O(1) iso vector
    ones = Vector.iso(np.float32(1.0), N, device=dev)
    deg = A.mxv(ones, semiring=types.FP32.plus_pair)
    dd = dict(deg)
    want = dict(zip(*np.unique(src, return_counts=True)))
    assert all(dd[int(i)] == float(c) for i, c in want.items())
    print(f"out-degree vector: {deg.nvals} entries at size 2^60")

    # 2-hop reachability from one scattered vertex
    f = Vector.sparse(types.FP32, N, device=dev)
    f[int(ids[0])] = 1.0
    h1 = f.vxm(A, semiring=types.FP32.plus_pair)
    h2 = h1.vxm(A, semiring=types.FP32.plus_pair)
    print(f"frontier: 1 -> {h1.nvals} -> {h2.nvals} vertices")
    assert h1.nvals >= 2

    # extract a scattered principal submatrix
    sub = A.extract_matrix(ids[:64].tolist(), ids[:64].tolist())
    assert sub.nrows == 64
    print(f"extracted 64x64 submatrix: {sub.nvals} entries")
    print("OK")


if __name__ == "__main__":
    main()
