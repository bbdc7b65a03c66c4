"""hyperdnn: the whole sparse DNN as ONE hypersparse block matrix.

The reference's showcase for user-defined semirings composing with the
hypersparse tier (`demo/dnn/dnn.py:28-50`): every layer is a block of a
single (L+1)n x (L+1)n matrix, bias+ReLU+clip live INSIDE the mxm via a
user-defined semiring, and one matrix expression advances every image
one layer.  Verified here against the per-layer container path.

Run: python demo_torch/13_hyperdnn.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.algorithms import (  # noqa: E402
    dnn, hypergraph, hyperdnn, relu_neuron_semiring)
from pygraphblas_tpu_torch.testing import build_biases, radix_net  # noqa: E402

NLAYERS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    n, layers = radix_net([4, 4], NLAYERS, weight=1.0, seed=11, device=dev)
    biases = build_biases(n, NLAYERS, -0.25, device=dev)

    rng = np.random.RandomState(11)
    m = 64
    r = rng.randint(0, m, 400)
    c = rng.randint(0, n, 400)
    keys = np.unique(r.astype(np.int64) * n + c)
    r, c = keys // n, keys % n
    Y = Matrix.sparse(types.FP32, m, n, device=dev)
    Y._build(r, c, np.ones(len(r), np.float32))

    # the whole-net block matrices: weights on the superdiagonal, biases
    # on the diagonal one block over
    HW = hypergraph(layers)
    HB = hypergraph(biases, diag=True)
    print(f"whole-net block matrix: {HW.nrows} x {HW.ncols}, "
          f"{HW.nvals} weights ({NLAYERS} layers of {n} neurons)")
    print("ReLU semiring:", relu_neuron_semiring().name)

    Yh = Matrix.sparse(types.FP32, m, HW.ncols, device=dev)
    Yh._build(r, c, np.ones(len(r), np.float32))
    out = hyperdnn(NLAYERS, HW, HB, Yh)

    # activations land in the final block column; the per-layer container
    # path is the oracle
    want = dnn(layers, biases, Y)
    rr, cc, vv = out._coo()
    off = NLAYERS * n
    assert (cc >= off).all()
    wd = np.zeros((m, n), np.float32)
    wr, wc, wv = want._coo()
    wd[wr, wc] = wv
    gd = np.zeros((m, n), np.float32)
    gd[rr, cc - off] = vv
    assert np.allclose(wd, gd, atol=1e-5)
    print(f"hyperdnn == per-layer dnn ({out.nvals} activations, "
          f"{int((gd > 0).sum())} positive)")
    print("OK")


if __name__ == "__main__":
    main()
