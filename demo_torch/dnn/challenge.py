"""GraphChallenge Sparse DNN harness (reference ``demo/dnn/challenge.py``).

Loads the GraphChallenge dataset layout when present on disk (neuron
weights TSVs + MNIST feature TSV + truth categories); otherwise falls
back to a RadiX-Net synthetic network so the benchmark runs hermetically.
The category oracle asserts predicted categories match the truth file —
the end-to-end numeric correctness check (reference challenge.py:74-76).

Run: python demo_torch/dnn/challenge.py [--ndir DIR | --fullscale]
[--nneurons N] [--nlayers L] [--nimages M] [--engine dnn|hyperdnn]
[--device cpu]  (the CUDA card unless --device names another device;
with neither --ndir nor --fullscale, the synthetic network)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import numpy as np  # noqa: E402

from demo_torch.dnn import timing  # noqa: E402
from pygraphblas_tpu_torch import Matrix, testing, types  # noqa: E402

NFEATURES = 60000
BIAS = {1024: -0.3, 4096: -0.35, 16384: -0.4, 65536: -0.45}
# the dense working set fused.dnn may hold (bytes of float32 cells)
FUSED_CAP = 4 << 30


@timing
def load_layers(ndir, nneurons, nlayers, device=None):
    layers = []
    for i in range(nlayers):
        fname = Path(ndir) / f"neuron{nneurons}" / \
            f"n{nneurons}-l{i + 1}.tsv"
        layers.append(Matrix.from_tsv(str(fname), types.FP32,
                                      nneurons, nneurons, device=device))
    return layers


@timing
def load_images(ndir, nneurons, device=None):
    fname = Path(ndir) / f"sparse-images-{nneurons}.tsv"
    return Matrix.from_tsv(str(fname), types.FP32, NFEATURES, nneurons,
                           device=device)


@timing
def load_categories(ndir, nneurons, nlayers):
    fname = Path(ndir) / "DNN" / \
        f"neuron{nneurons}-l{nlayers}-categories.tsv"
    with open(fname) as f:
        return {int(line) - 1 for line in f}


@timing
def run(nneurons, images, layers, biases, fused=True, device=None):
    """fused.dnn on `device` (the whole net in one loop of dense
    products) when the dense working set fits in FUSED_CAP, else the
    per-op container path (algorithms.dnn, on the operands' device)."""
    from pygraphblas_tpu_torch import fused as fk
    from pygraphblas_tpu_torch.algorithms import dnn

    m, n = images.nrows, nneurons
    cells = max(m * n, n * n * len(layers))
    if fused and not images._is_huge and cells * 4 <= FUSED_CAP:
        result = fk.dnn(layers, biases, images, device=device)
    else:
        result = dnn(layers, biases, images)
    result.wait()
    return result


def run_challenge(ndir, nneurons, nlayers, device=None):
    """Run the official dataset with the category truth oracle."""
    layers = load_layers(ndir, nneurons, nlayers, device)
    images = load_images(ndir, nneurons, device)
    biases = testing.build_biases(nneurons, nlayers, BIAS[nneurons],
                                  device=device)
    result = run(nneurons, images, layers, biases, device=device)
    predicted = set(result.reduce_vector().nonzero().indices)
    truth = load_categories(ndir, nneurons, nlayers)
    assert predicted == truth, "category mismatch vs truth file"
    print(f"OK: {len(predicted)} categories match")
    return result


def run_synthetic(radices=(4, 4, 4), nlayers=12, nimages=512, seed=7,
                  device=None):
    """Hermetic RadiX-Net run with a self-consistency oracle."""
    n, layers = testing.radix_net(list(radices), nlayers, weight=None,
                                  seed=seed, device=device)
    rng = np.random.RandomState(seed)
    nnz = nimages * 8
    img_r = rng.randint(0, nimages, nnz)
    img_c = rng.randint(0, n, nnz)
    img_v = rng.rand(nnz).astype(np.float32)
    images = Matrix.sparse(types.FP32, nimages, n, device=device)
    images._build(img_r, img_c, img_v)
    biases = testing.build_biases(n, nlayers, -0.1, device=device)
    result = run(n, images, layers, biases, device=device)
    print(f"synthetic dnn: {result.nvals} outputs, "
          f"max={result.reduce_float(types.FP32.MAX_MONOID):.4f}")
    return result


def run_fullscale(nneurons=1024, nlayers=120, nimages=NFEATURES, seed=7,
                  engine="dnn", device=None):
    """The official-size run (60,000 x nneurons images through nlayers
    RadiX-Net layers) with a self-computed category truth oracle —
    the reference's dataset-scale config (demo/dnn/dnn.sh) made hermetic
    (no network egress for the GraphChallenge tarballs).

    ``engine="hyperdnn"`` routes through the whole-net hypersparse
    block matrix with the fused ReLU semiring (algorithms.hyperdnn;
    reference demo/dnn/dnn.py:28-50).
    """
    # exact-radix network at nneurons; like the official nets, layers
    # have uniform degree r and a constant weight, an exact binary
    # fraction, so every activation is exactly representable in fp32 --
    # the category oracle is then independent of summation order
    radices, weight = testing.fullscale_radices(nneurons)
    n, layers = testing.radix_net(radices, nlayers, weight=weight,
                                  seed=seed, device=device)
    assert n == nneurons, (n, nneurons)
    # binary images with per-row fill in [0, 0.3): sparse rows die in
    # the network, dense rows survive, so the category set is a real
    # discrimination oracle (like the official truth files)
    img_r, img_c, img_v = testing.fullscale_images(nimages, n, seed=seed)
    bias = -0.25
    biases = testing.build_biases(n, nlayers, bias, device=device)
    if engine == "hyperdnn":
        from pygraphblas_tpu_torch.algorithms import hypergraph, hyperdnn

        HW = hypergraph(layers)
        HB = hypergraph(biases, diag=True)
        Yh = Matrix.sparse(types.FP32, nimages, HW.ncols, device=device)
        Yh._build(img_r, img_c, img_v)
        result = hyperdnn(nlayers, HW, HB, Yh)
        result.wait()
    else:
        images = Matrix.sparse(types.FP32, nimages, n, device=device)
        images._build(img_r, img_c, img_v)
        result = run(n, images, layers, biases, device=device)
    predicted = set(result.reduce_vector().nonzero().indices)

    truth_Y = testing.scipy_dnn_oracle(
        img_r, img_c, img_v, [w._coo() for w in layers], nimages, n, bias)
    truth = set(np.nonzero(np.asarray(
        truth_Y.sum(axis=1)).ravel() != 0)[0].tolist())
    assert predicted == truth, (
        f"category mismatch: {len(predicted ^ truth)} differ")
    print(f"OK: {len(predicted)} categories match the oracle "
          f"({nimages} images x {nneurons} neurons x {nlayers} layers)")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ndir", default=None,
                   help="GraphChallenge dataset directory")
    p.add_argument("--nneurons", type=int, default=1024)
    p.add_argument("--nlayers", type=int, default=120)
    p.add_argument("--fullscale", action="store_true",
                   help="official-size hermetic run with oracle")
    p.add_argument("--nimages", type=int, default=NFEATURES)
    p.add_argument("--engine", default="dnn", choices=("dnn", "hyperdnn"),
                   help="per-layer container path, or the whole-net "
                        "hypersparse block matrix with the fused ReLU "
                        "semiring")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.ndir:
        return run_challenge(args.ndir, args.nneurons, args.nlayers,
                             args.device)
    if args.fullscale:
        return run_fullscale(args.nneurons, args.nlayers, args.nimages,
                             engine=args.engine, device=args.device)
    return run_synthetic(device=args.device)


if __name__ == "__main__":
    main()
