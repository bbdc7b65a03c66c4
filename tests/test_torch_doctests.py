"""The port's docstring examples (``run_doctests``) against the JAX
package's: every example of the JAX package's ``__init__``, ``matrix``,
``vector``, ``base``, ``binaryop``, ``unaryop`` and ``selectop`` stands in
the port's counterpart docstring (the package renamed) and passes on the
CPU; and the device scope that ``run_doctests`` opens."""

import ast
import doctest
import importlib
import os
import re

import pytest
import torch

import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import _device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("__init__", "matrix", "vector", "base", "binaryop", "unaryop",
           "selectop")
PARSER = doctest.DocTestParser()


def _name(mod, pkg):
    return pkg if mod == "__init__" else f"{pkg}.{mod}"


@pytest.fixture(scope="module")
def cpu_run():
    """One run of the port's examples on the CPU: (failures, {module:
    attempted})."""
    tried = {}
    orig = doctest.testmod

    def counting(mod, **kw):
        r = orig(mod, **kw)
        tried[mod.__name__] = r.attempted
        return r

    doctest.testmod = counting
    try:
        failed = T.run_doctests(device="cpu")
    finally:
        doctest.testmod = orig
    return failed, tried


@pytest.mark.parametrize("mod", MODULES)
def test_run_doctests_on_cpu(cpu_run, mod):
    """0 failures, and at least as many examples tried in each module as
    the JAX package holds there."""
    failed, tried = cpu_run
    assert failed == 0
    jax_mod = importlib.import_module(_name(mod, "pygraphblas_tpu"))
    want = sum(len(t.examples) for t in doctest.DocTestFinder().find(jax_mod))
    assert want > 0
    assert tried[_name(mod, "pygraphblas_tpu_torch")] >= want


def _docstrings(path):
    """{qualified name: [docstring, ...]} of a source file's module,
    classes and functions, nested ones included."""
    tree = ast.parse(open(path).read(), path)
    out = {"<module>": [ast.get_docstring(tree, clean=False)]}

    def walk(node, prefix):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                q = prefix + ch.name
                out.setdefault(q, []).append(
                    ast.get_docstring(ch, clean=False))
                walk(ch, q + ".")

    walk(tree, "")
    return out


def _examples(doc):
    return [(e.source, e.want) for e in PARSER.get_examples(doc or "")]


@pytest.mark.parametrize("mod", MODULES)
def test_examples_match_jax(mod):
    """Every JAX docstring with examples has a port counterpart of the
    same qualified name that holds the same examples, source and want,
    once `pygraphblas_tpu` reads `pygraphblas_tpu_torch`."""
    jax = _docstrings(os.path.join(ROOT, "pygraphblas_tpu", f"{mod}.py"))
    port = _docstrings(os.path.join(ROOT, "pygraphblas_tpu_torch",
                                    f"{mod}.py"))
    rename = re.compile(r"\bpygraphblas_tpu\b")
    count = 0
    for name, docs in jax.items():
        for doc in docs:
            want = [(rename.sub("pygraphblas_tpu_torch", s), w)
                    for s, w in _examples(doc)]
            if not want:
                continue
            count += len(want)
            assert name in port, name
            assert want in [_examples(d) for d in port[name]], name
    assert count > 0


def test_default_device_scope(monkeypatch):
    """Without a card, resolve_device(None) raises outside the scope;
    inside it gives the scope's device (nested scopes too), and the
    default comes back after the block, also after an exception."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _device.resolve_device(None)
    with _device.default_device("cpu"):
        assert _device.resolve_device(None) == torch.device("cpu")
        assert _device.resolve_device("cpu") == torch.device("cpu")
        with _device.default_device("meta"):
            assert _device.resolve_device(None) == torch.device("meta")
        assert _device.resolve_device(None) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        _device.resolve_device(None)
    with pytest.raises(ZeroDivisionError):
        with _device.default_device("cpu"):
            1 / 0
    with pytest.raises(RuntimeError, match="CUDA"):
        _device.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Matrix.from_lists([0], [1], [2]).reduce_int()


def test_run_doctests_scope_ends_with_the_call(monkeypatch):
    """run_doctests() without a device runs on the card (raising without
    one), and run_doctests(device="cpu") leaves the default as it was,
    also when an example raises (raise_on_error)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_doctests()

    def failing(mod, **kw):
        # inside the call the examples' default is the CPU
        assert _device.resolve_device(None) == torch.device("cpu")
        raise doctest.UnexpectedException(None, None, None)

    monkeypatch.setattr(doctest, "testmod", failing)
    with pytest.raises(doctest.UnexpectedException):
        T.run_doctests(raise_on_error=True, device="cpu")
    assert _device._default is None
    with pytest.raises(RuntimeError, match="CUDA"):
        _device.resolve_device(None)


def test_run_doctests_without_graphviz(monkeypatch):
    """Where graphviz is absent, gviz's examples (which draw through it)
    are not run, and every other example still is: the JAX package's 446
    (its seven modules' 440 and scalar's 6)."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda m, *a: None if m == "graphviz" else real(m, *a))
    tried = {}
    orig = doctest.testmod

    def counting(mod, **kw):
        r = orig(mod, **kw)
        tried[mod.__name__] = r.attempted
        return r

    monkeypatch.setattr(doctest, "testmod", counting)
    assert T.run_doctests(device="cpu") == 0
    assert "pygraphblas_tpu_torch.gviz" not in tried
    assert sum(tried.values()) >= 446
