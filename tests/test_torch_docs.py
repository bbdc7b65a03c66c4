"""The committed API docs of the port (``docs/api_torch``) against a
fresh run of their generator, ``docs/generate_torch.py``."""

import filecmp
import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_api_docs_are_current(tmp_path):
    """docs/api_torch equals a fresh run of docs/generate_torch.py."""
    sys.path.insert(0, os.path.join(ROOT, "docs"))
    try:
        gen = importlib.import_module("generate_torch")
    finally:
        sys.path.pop(0)
    gen.main(tmp_path)
    made = sorted(os.listdir(tmp_path))
    committed = os.path.join(ROOT, "docs", "api_torch")
    assert made == sorted(os.listdir(committed))
    assert len(made) == len(gen.MODULES) + 1
    for f in made:
        assert filecmp.cmp(tmp_path / f, os.path.join(committed, f),
                           shallow=False), f
