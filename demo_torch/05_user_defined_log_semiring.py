"""User-defined operators: the log-semiring.

Products of probabilities underflow; the log-semiring computes in log
space with PLUS = log-add-exp and TIMES = +.  User ops here are plain
Python functions over torch tensors (the replacement for the
reference's numba-cfunc pathway, reference `Log-Semiring.ipynb` and
binaryop.py:137-191).

Run: python demo_torch/05_user_defined_log_semiring.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from math import exp, log
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from pygraphblas_tpu_torch import Matrix  # noqa: E402
from pygraphblas_tpu_torch.binaryop import binary_op  # noqa: E402
from pygraphblas_tpu_torch.types import FP32  # noqa: E402


class Log32(FP32):
    @binary_op(FP32)
    def PLUS(x, y):
        return x + torch.log1p(torch.exp(y - x))

    @binary_op(FP32)
    def TIMES(x, y):
        return x + y

    @classmethod
    def _from_value(cls, value):
        return log(value)

    @classmethod
    def _to_value(cls, data):
        return exp(data)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # transition probabilities of a tiny Markov chain
    A = Matrix.sparse(Log32, 4, 4, device=dev)
    A[0, 1] = 0.5
    A[0, 2] = 0.5
    A[1, 3] = 0.25
    A[2, 3] = 0.125

    monoid = Log32.new_monoid(Log32.PLUS, Log32.default_one)
    semiring = Log32.new_semiring(monoid, Log32.TIMES)

    with semiring:
        P2 = A @ A  # two-step path probabilities, summed in log space

    print("two-step probabilities (stored in log space, shown as probs):")
    print("P(0 -> 3 in 2 steps) =", P2[0, 3])
    assert abs(P2[0, 3] - (0.5 * 0.25 + 0.5 * 0.125)) < 1e-6
    print("OK")


if __name__ == "__main__":
    main()
