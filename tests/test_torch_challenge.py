"""The port's GraphChallenge harness (demo_torch/dnn/challenge.py) on
the CPU in its three modes: the dataset layout (a small dataset written
by ``testing.write_challenge_dataset``, its truth file from the scipy
oracle; a wrong truth file fails), the synthetic RadiX-Net against the
JAX harness's ``run_synthetic``, and the full-scale net at 64 neurons
on both engines against the category oracle (hyperdnn on the COO
tier)."""

import os

import numpy as np
import pytest

from demo_torch.dnn import challenge
from pygraphblas_tpu_torch import options_set, testing
from pygraphblas_tpu_torch.base import config


def _dataset(path, nlayers=2):
    return testing.write_challenge_dataset(
        str(path), 1024, nlayers, 64, challenge.BIAS[1024])


def test_dataset_mode(tmp_path, capsys):
    truth = _dataset(tmp_path)
    assert 0 < len(truth) < 64
    result = challenge.main(["--ndir", str(tmp_path), "--nneurons", "1024",
                             "--nlayers", "2", "--device", "cpu"])
    assert set(result.reduce_vector().nonzero().indices) == truth
    assert result.shape == (challenge.NFEATURES, 1024)
    assert f"OK: {len(truth)} categories match" in capsys.readouterr().out


def test_dataset_mode_refuses_a_wrong_truth(tmp_path):
    truth = _dataset(tmp_path, nlayers=3)
    cats = os.path.join(str(tmp_path), "DNN", "neuron1024-l3-categories.tsv")
    with open(cats, "w") as f:
        f.write("\n".join(str(c + 1) for c in sorted(truth)[1:]) + "\n")
    with pytest.raises(AssertionError, match="category mismatch"):
        challenge.main(["--ndir", str(tmp_path), "--nneurons", "1024",
                        "--nlayers", "3", "--device", "cpu"])


def test_synthetic_mode_matches_jax():
    from demo.dnn.challenge import run_synthetic

    want = run_synthetic()
    got = challenge.main(["--device", "cpu"])
    wr, wc, wv = (np.asarray(a) for a in want._coo())
    gr, gc, gv = got._coo()
    assert got.shape == want.shape and len(gv) > 0
    assert np.array_equal(gr, wr) and np.array_equal(gc, wc)
    assert np.allclose(gv, wv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["dnn", "hyperdnn"])
def test_fullscale_mode(engine, capsys):
    """hyperdnn on the COO tier, as tests/test_torch_dnn.py runs it: on
    the bitmap tier its user semiring is a dense broadcast-reduce that
    runs for minutes on a loaded CPU."""
    cells = (config.bitmap_max_cells, config.vector_max_cells)
    if engine == "hyperdnn":
        options_set(bitmap_max_cells=1, vector_max_cells=1)
    try:
        result = challenge.main(["--fullscale", "--nneurons", "64",
                                 "--nlayers", "10", "--nimages", "500",
                                 "--engine", engine, "--device", "cpu"])
    finally:
        options_set(bitmap_max_cells=cells[0], vector_max_cells=cells[1])
    out = capsys.readouterr().out
    assert "categories match the oracle (500 images x 64 neurons" in out
    assert result.nrows == 500
