"""Introduction to GraphBLAS with pygraphblas_tpu_torch.

The executable twin of the reference's
`Introduction-to-GraphBLAS-with-Python.ipynb`: build a small directed
graph as a Matrix, look at it, multiply over different semirings, and
run a masked BFS.

Run: python demo_torch/01_introduction.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pygraphblas_tpu_torch import Matrix, Vector, types, descriptor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # --- a tiny directed graph ----------------------------------------------
    #  0 -> 1 -> 2 -> 0,  1 -> 3,  3 -> 2
    A = Matrix.from_lists([0, 1, 2, 1, 3], [1, 2, 0, 3, 2],
                          [1, 2, 3, 4, 5], device=dev)
    print("A =")
    print(A)

    # element access, slicing (GraphBLAS slices are stop-INCLUSIVE)
    print("\nA[1, 2] =", A[1, 2])
    print("rows 0:1 =")
    print(A[0:1, :])

    # --- semiring products --------------------------------------------------
    # plus_times is linear algebra; min_plus is shortest-path algebra
    print("\nA @ A (plus_times):")
    print(A @ A)
    print("\nA.min_plus(A):")
    print(A.min_plus(A))

    # with-block scoping sets the default semiring (reference signature UX)
    with types.INT64.MIN_PLUS:
        print("\nsame, via with-block:")
        print(A @ A)

    # --- masked BFS (the canonical GraphBLAS loop) --------------------------
    n = A.nrows
    v = Vector.sparse(types.INT64, n, device=dev)
    q = Vector.sparse(types.BOOL, n, device=dev)
    q[0] = True
    level = 1
    while q.reduce_bool():
        v.assign_scalar(level, mask=q)
        q = q.vxm(A, semiring=types.BOOL.lor_land, mask=v,
                  desc=descriptor.RC)
        level += 1
    print("\nBFS levels from 0:")
    print(v)
    assert v[2] == 3  # 0 -> 1 -> 2
    print("\nOK")


if __name__ == "__main__":
    main()
