"""The port's I/O against the JAX package on the CPU: MatrixMarket
(``to_mm`` text equal, ``from_mm`` triples equal, through the native
parser of ``csrc/fastio.cpp`` and through the Python reader), TSV/CSV,
the binary checkpoint crossing between the packages in both directions,
and ``ssget`` over a stand-in ``ssgetpy`` (nothing is fetched)."""

import io
import subprocess
import sys
import types as pytypes

import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import _native
from pygraphblas_tpu_torch.io import native

VALUES = {"INT64": [-7, 42, 0, 2**40 + 3],
          "FP64": [1.5, -0.25, 1e-300, 3.0],
          "BOOL": [True, True, True, True],
          "UINT32": [3000000000, 1, 4294967295, 7]}
ROWS, COLS = [0, 1, 2, 2], [1, 2, 0, 3]


def _mat(pkg, tname, **kw):
    return pkg.Matrix.from_lists(ROWS, COLS, VALUES[tname],
                                 typ=getattr(pkg.types, tname), nrows=3,
                                 ncols=4, **kw)


def _triples(M):
    r, c, v = M._coo()
    return M.type.__name__, M.shape, r.tolist(), c.tolist(), v.tolist()


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("tname", sorted(VALUES))
def test_mm_round_trip_matches_jax(tname, reader, tmp_path, monkeypatch):
    """to_mm writes the JAX package's text (UINT32 past the sign bit as
    its unsigned value); from_mm of a file path reads back the JAX
    package's matrix, through the native parser or, with no compiler,
    the Python reader."""
    want_f, got_f = io.StringIO(), io.StringIO()
    _mat(J, tname).to_mm(want_f)
    _mat(T, tname, device="cpu").to_mm(got_f)
    assert got_f.getvalue() == want_f.getvalue()
    if tname == "UINT32":
        assert " 3000000000\n" in got_f.getvalue()
    path = tmp_path / "m.mtx"
    path.write_text(got_f.getvalue())
    if reader == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    got = T.Matrix.from_mm(path, device="cpu")
    assert _triples(got) == _triples(J.Matrix.from_mm(io.StringIO(
        want_f.getvalue())))
    assert _triples(T.Matrix.from_mm(io.StringIO(got_f.getvalue()))) == \
        _triples(got)


@pytest.mark.parametrize("header", ["pattern symmetric", "real skew-symmetric",
                                    "integer general"])
def test_mm_native_equals_python_reader(header, tmp_path):
    """The native parser and the Python reader read one file alike:
    symmetric halves mirrored, duplicates (last wins) and comments."""
    body = ("% a comment\n4 4 5\n2 1 3\n3 1 -1.5\n4 4 2\n3 2 7\n2 1 5\n"
            if "pattern" not in header else
            "% a comment\n4 4 4\n2 1\n3 1\n4 4\n3 2\n")
    if "integer" in header:
        body = body.replace("-1.5", "-2")
    text = f"%%MatrixMarket matrix coordinate {header}\n" + body
    path = tmp_path / "s.mtx"
    path.write_text(text)
    assert native.available()
    got = T.Matrix.from_mm(path, device="cpu")
    assert _triples(got) == _triples(T.Matrix.from_mm(io.StringIO(text)))
    assert _triples(got) == _triples(J.Matrix.from_mm(io.StringIO(text)))


def test_mm_native_leaves_complex_hermitian_and_wide_ints_to_python(
        tmp_path):
    """Files the native parser does not read itself come back as the
    Python reader reads them: complex values (general and hermitian,
    the mirrored half conjugated), an INT64 value past 2**53 exactly,
    a mixed-case header, and an INT64 overflow raised as the JAX
    package raises it."""
    texts = [
        "%%MatrixMarket matrix coordinate complex general\n"
        "3 3 2\n1 2 1.5 -2\n3 1 0 4\n",
        "%%MatrixMarket matrix coordinate complex hermitian\n"
        "3 3 3\n2 1 1.5 -2\n3 3 7 0\n3 1 0 4\n",
        "%%MatrixMarket matrix coordinate integer symmetric\n"
        f"3 3 3\n2 1 {2**62 + 1}\n3 3 {-(2**60) - 1}\n3 2 "
        f"{2**63 - 1}\n",
        "%%MatrixMarket Matrix Coordinate Real Symmetric\n"
        "2 2 1\n2 1 0.5\n"]
    for k, text in enumerate(texts):
        path = tmp_path / f"m{k}.mtx"
        path.write_text(text)
        got = T.Matrix.from_mm(path, device="cpu")
        assert _triples(got) == _triples(T.Matrix.from_mm(io.StringIO(text)))
        assert _triples(got) == _triples(J.Matrix.from_mm(io.StringIO(text)))
    r, c, v = T.Matrix.from_mm(tmp_path / "m2.mtx", device="cpu")._coo()
    assert v.tolist() == [2**62 + 1, 2**62 + 1, 2**63 - 1, 2**63 - 1,
                          -(2**60) - 1]
    big = ("%%MatrixMarket matrix coordinate integer general\n"
           f"1 1 1\n1 1 {2**64 - 1}\n")
    path = tmp_path / "big.mtx"
    path.write_text(big)
    with pytest.raises(OverflowError):
        J.Matrix.from_mm(io.StringIO(big))
    with pytest.raises(OverflowError):
        T.Matrix.from_mm(path, device="cpu")


def test_native_parser_errors_and_failed_build(tmp_path, monkeypatch):
    """A missing file and a file that is not MatrixMarket raise; a build
    that fails raises rather than falling back to the Python reader."""
    with pytest.raises(FileNotFoundError):
        T.Matrix.from_mm(tmp_path / "none.mtx")
    bad = tmp_path / "bad.mtx"
    bad.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        T.Matrix.from_mm(bad)

    def fail(*a, **kw):
        raise subprocess.CalledProcessError(1, a[0])

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(subprocess, "run", fail)
    ok = tmp_path / "ok.mtx"
    ok.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                  "1 1 1\n1 1\n")
    with pytest.raises(subprocess.CalledProcessError):
        T.Matrix.from_mm(ok)


def test_sort_dedup_native_matches_numpy():
    """The C++ canonicaliser: (row, col) order, the last duplicate kept,
    the values exact (INT64 past 2**53 too)."""
    rng = np.random.RandomState(0)
    n = 50_000
    rows, cols = rng.randint(0, 300, n), rng.randint(0, 300, n)
    vals = rng.rand(n).astype(np.float32)
    r1, c1, v1 = native.sort_dedup_native(rows, cols, vals)
    order = np.lexsort((np.arange(n), cols, rows))
    rs, cs, vs = rows[order], cols[order], vals[order]
    last = np.ones(n, bool)
    last[:-1] = (rs[:-1] != rs[1:]) | (cs[:-1] != cs[1:])
    assert np.array_equal(r1, rs[last]) and np.array_equal(c1, cs[last])
    assert v1.dtype == np.float32 and np.array_equal(v1, vs[last])
    wide = (np.int64(2**62) + np.arange(n)).astype(np.int64)
    assert np.array_equal(native.sort_dedup_native(rows, cols, wide)[2],
                          wide[order][last])
    r2, c2, v2 = native.sort_dedup_native(rows, cols, None)
    assert v2 is None and np.array_equal(r2, r1) and np.array_equal(c2, c1)


def test_csv_and_tsv_match_jax():
    """from_csv with a header, 0-based indices and another delimiter;
    from_tsv; each equal to the JAX package's."""
    cases = [("row,col,val\n1,2,7\n3,1,9\n\n2,2,4\n", "INT64",
              dict(delimiter=",")),
             ("0;1;0.5\n2;0;1.25\n", "FP32",
              dict(one_based=False, delimiter=";")),
             ("1,1,1\n2,3,0\n", "BOOL", {})]
    for text, tname, kw in cases:
        want = J.Matrix.from_csv(io.StringIO(text), getattr(J.types, tname),
                                 3, 3, **kw)
        got = T.Matrix.from_csv(io.StringIO(text), getattr(T.types, tname),
                                3, 3, device="cpu", **kw)
        assert _triples(got) == _triples(want)
    text = "1\t2\t7\n2\t1\t9\n"
    assert _triples(T.Matrix.from_tsv(io.StringIO(text), T.types.INT64,
                                      2, 2)) == \
        _triples(J.Matrix.from_tsv(io.StringIO(text), J.types.INT64, 2, 2))


def test_binfile_crosses_between_the_packages(tmp_path):
    """A binfile the JAX package writes loads in the port, and one the
    port writes loads in the JAX package, at four types."""
    for tname in sorted(VALUES):
        jp, tp = tmp_path / f"j_{tname}.grb", tmp_path / f"t_{tname}.grb"
        _mat(J, tname).binwrite(jp)
        _mat(T, tname, device="cpu").to_binfile(tp)
        got = T.Matrix.binread(jp, device="cpu")
        assert _triples(got) == _triples(_mat(J, tname))
        assert got.iseq(_mat(T, tname, device="cpu"))
        assert _triples(J.Matrix.from_binfile(tp)) == \
            _triples(_mat(J, tname))
    bad = tmp_path / "bad.grb"
    with open(bad, "wb") as fh:
        np.savez_compressed(fh, magic=np.asarray("other"))
    with pytest.raises(ValueError):
        T.Matrix.binread(bad)


def test_ssget_with_a_stand_in_ssgetpy(tmp_path, monkeypatch):
    """ssget over a stand-in ssgetpy whose download extracts one file:
    the matrix it yields, then the binary cache, which skips the
    MatrixMarket parse on the next call."""
    (tmp_path / "karate.mtx").write_text(
        "%%MatrixMarket matrix coordinate integer general\n"
        "3 3 3\n1 2 7\n2 3 9\n3 1 4\n")

    class _Result:
        def download(self, extract=True):
            return str(tmp_path), None

    mod = pytypes.ModuleType("ssgetpy")
    mod.search = lambda q=None: [_Result()]
    monkeypatch.setitem(sys.modules, "ssgetpy", mod)
    calls = []
    orig = T.Matrix.from_mm.__func__

    def counting(cls, *a, **k):
        calls.append(1)
        return orig(cls, *a, **k)

    monkeypatch.setattr(T.Matrix, "from_mm", classmethod(counting))
    (name, M), = T.Matrix.ssget("Newman/karate", device="cpu")
    assert name == "karate.mtx" and M.to_lists() == [[0, 1, 2], [1, 2, 0],
                                                      [7, 9, 4]]
    assert not list(tmp_path.glob("*.grb"))
    (_, M1), = T.Matrix.ssget("Newman/karate", binary_cache_dir=True,
                              device="cpu")
    (_, M2), = T.Matrix.ssget("Newman/karate", binary_cache_dir=True,
                              device="cpu")
    assert len(calls) == 2 and (tmp_path / "karate.mtx.grb").exists()
    assert M2.iseq(M1) and M2.iseq(M)
