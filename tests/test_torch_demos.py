"""The port's demo gallery (demo_torch/NN_*.py) on the CPU, in process:
each script's ``main(["--device", "cpu"])`` prints ``OK`` last once its
numpy/scipy oracle agrees (tests/test_torch_demo_oracles.py holds those
oracles against networkx's)."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DEMOS = sorted((ROOT / "demo_torch").glob("[0-9]*.py"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The demos' graphs are small: their many short torch ops run on one
    thread.  Beside five other busy test workers, one thread took this
    file 15.6 s against 59.7 s at torch's default of one a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(stem):
    path = next(p for p in DEMOS if p.name.startswith(stem))
    spec = importlib.util.spec_from_file_location(
        "demo_torch_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script", DEMOS, ids=[d.name for d in DEMOS])
def test_demo_prints_ok(script, capsys):
    _load(script.name[:2]).main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and lines[-1] == "OK"
