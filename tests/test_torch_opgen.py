"""The operator compiler (pygraphblas_tpu_torch/_opgen.py) on the CPU.

The CUDA functors it renders run only on the card (chip_smoke's gudf14
and gudf16 hold them against the plain versions there); here its IR,
rendered as torch ops (``_opgen.evaluate``), is held against the op it
lowers (``op.apply``), exactly: every built-in binary op of the table at
every type of 4 bytes or less (all lower but integer POW, which reads a
value while it is traced), LogSum32's ops and user ops at the unsigned
views.  Values come from a numpy seed plus edge values (0, +-1, the
type's extremes; +-inf and NaN at FP32).  Ops that do not lower name
their reason in ``_kernels.unlowered``; the generated source is
deterministic, and a build that fails raises.
"""

import os

import numpy as np
import pytest
import torch

from pygraphblas_tpu_torch import (_kernels, _opgen, binaryop, testing,
                                   types)
from pygraphblas_tpu_torch.binaryop import binary_op
from pygraphblas_tpu_torch.ops import table

TYPES = ("BOOL", "INT8", "INT16", "INT32", "UINT8", "UINT16", "UINT32",
         "FP32")


def _values(T, n, seed):
    """n values of type T (held dtype) from a seed, edge values first."""
    rng = np.random.RandomState(seed)
    if T.__name__ == "BOOL":
        v = rng.rand(n) < 0.5
        v[:2] = [False, True]
        return torch.from_numpy(v)
    if T.__name__ == "FP32":
        v = (rng.randn(n) * 10).astype(np.float32)
        v[:9] = [0, 1, -1, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, -0.0]
        v[9:40] = rng.randint(-40, 40, 31)
        return torch.from_numpy(v)
    info = np.iinfo(T.numpy_dtype)
    v = rng.randint(info.min, int(info.max) + 1, n, dtype=np.int64)
    v[:5] = [0, 1, info.max, info.min, min(int(info.max), 2)]
    v[5:60] = rng.randint(max(int(info.min), -40), 40, 55)
    if info.min < 0:
        v[60] = -1
    return T.to_torch(v.astype(T.numpy_dtype))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok])
    else:
        assert torch.equal(got, want)


def _pairs(T, seed):
    x, y = _values(T, 512, seed), _values(T, 512, seed + 1)
    return x, torch.cat([y[256:], y[:256]])


@pytest.mark.parametrize("typ", TYPES)
def test_builtin_ops_lower_and_evaluate_as_apply(typ):
    T = getattr(types, typ)
    x, y = _pairs(T, 3)
    unlowered = []
    for name, spec in table.BINARY.items():
        if spec["positional"] or name == "CMPLX" or typ not in spec["types"]:
            continue
        op = getattr(binaryop, f"{name}_{typ}")
        try:
            ir = _opgen.lower(op, T)
        except _opgen.Unlowered:
            unlowered.append(name)
            continue
        _same(_opgen.evaluate(ir, x, y), op.apply(x, y))
    # integer POW lowers too since its closure squares over six fixed
    # rounds (the JAX rule) and reads no value on the host
    assert unlowered == []


def test_logsum32_lowers_and_evaluates_as_apply():
    sem = testing.logsum32()
    x, y = _pairs(types.FP32, 5)
    x[:4] = torch.tensor([float("-inf"), float("-inf"), 2.0, -1.0])
    y[:4] = torch.tensor([float("-inf"), 3.0, 2.0, float("-inf")])
    for op in (sem.add_monoid, sem.mul_op):
        got = _opgen.evaluate(_opgen.lower(op, types.FP32), x, y)
        _same(got, op.apply(x, y))
    fold = _opgen.evaluate(_opgen.lower(sem.add_monoid, types.FP32), x, y)
    assert fold[0] == float("-inf") and not torch.isnan(fold[:4]).any()
    src = _opgen.source(sem.add_monoid, types.FP32, sem.mul_op)
    assert "0.6931471824645996f" in src and "GenMul" in src


@pytest.mark.parametrize("typ,big", [("UINT16", 60000),
                                     ("UINT32", 3000000000)])
def test_user_ops_at_unsigned_views(typ, big):
    """The lowered graph carries the unsigned widening (_unsigned.call):
    the fault's cases give the JAX package's answers through the IR."""
    T = getattr(types, typ)
    bigger = binary_op(T)(lambda x, y: torch.where(x > y, x, y))
    quot = binary_op(T)(lambda x, y: x // y)
    x = T.to_torch(np.array([big, 5], T.numpy_dtype))
    y = T.to_torch(np.array([7, big + 1000 if typ == "UINT32" else big],
                            T.numpy_dtype))
    ir = _opgen.lower(bigger, T)
    got = T.to_numpy(_opgen.evaluate(ir, x, y))
    assert got.tolist() == [big, y[1].item() & ((1 << T._bits) - 1)]
    assert T.to_numpy(_opgen.evaluate(_opgen.lower(quot, T), x, y)).tolist() \
        == [big // 7, 0]
    xs, ys = _pairs(T, 9)
    _same(_opgen.evaluate(ir, xs, ys), bigger.apply(xs, ys))
    assert "(int32_t)(uint16_t)" in _opgen.functor(ir, T, "F") \
        or typ == "UINT32"


def test_what_does_not_lower_is_recorded():
    def branchy(x, y):
        return x if bool((x > y).all()) else y

    cases = {
        binary_op(types.INT32)(branchy): "tracing failed",
        binary_op(types.FP32)(lambda x, y: torch.erf(x) + y):
            "aten.erf.default is outside the table",
        binaryop.FIRSTI_INT32: "a positional op",
    }
    for op, reason in cases.items():
        assert not _opgen.lowers(op, types.INT32 if op.type_name == "INT32"
                                 else types.FP32)
        assert reason in _kernels.unlowered[op.name]
    with pytest.raises(_opgen.Unlowered, match="no kernel word"):
        _opgen.lower(binaryop.PLUS_INT64, types.INT64)


def test_udt_op_does_not_lower():
    op = binaryop.BinaryOp("PAIRSUM", "INT32", fn=lambda x, y: x,
                           udt=types.INT32, attach=False)
    assert not _opgen.lowers(op, types.INT32)
    assert _kernels.unlowered["PAIRSUM_INT32"] == "a UDT op"


def test_source_is_deterministic():
    sem = testing.logsum32()
    a = _opgen.source(sem.add_monoid, types.FP32, sem.mul_op)
    _opgen._LOWERED.clear()
    b = _opgen.source(sem.add_monoid, types.FP32, sem.mul_op)
    assert a == b and _opgen.digest(a) == _opgen.digest(b)
    assert _opgen.digest(a) != _opgen.digest(
        _opgen.source(sem.add_monoid, types.FP32))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A generated kernel that cannot be built raises: no fall-back."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(_opgen, "GEN_DIR", str(tmp_path))
    monkeypatch.setattr(_opgen, "_LIBS", {})
    sem = testing.logsum32()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _opgen.unit(sem.add_monoid, types.FP32, sem.mul_op)
    assert not os.listdir(tmp_path)


def test_failed_compile_raises(monkeypatch, tmp_path):
    """nvcc's refusal comes back as a RuntimeError carrying its output;
    nothing is left behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such function' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    gen = tmp_path / "gen"
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_opgen, "GEN_DIR", str(gen))
    monkeypatch.setattr(_opgen, "_LIBS", {})
    sem = testing.logsum32()
    with pytest.raises(RuntimeError, match="no such function"):
        _opgen.unit(sem.add_monoid, types.FP32)
    assert not os.listdir(gen)


def test_table_covers_the_traced_ops():
    ops = set(_opgen.table())
    for name in ("add", "sub", "mul", "div", "floor_divide", "neg", "pow",
                 "fmod", "round", "clamp", "ldexp", "eq", "ne", "lt", "le",
                 "gt", "ge", "logical_and", "logical_or", "logical_xor",
                 "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
                 "bitwise_not", "__lshift__", "__rshift__", "minimum",
                 "maximum", "where", "atan2", "hypot", "copysign",
                 "_to_copy", "full_like", "ones_like", "zeros_like", "exp",
                 "log1p", "abs", "exp2", "log", "log2", "expm1", "sqrt",
                 "rsqrt", "sin", "cos", "tanh", "sigmoid", "floor", "ceil",
                 "trunc", "sign", "reciprocal", "clamp_min", "clamp_max"):
        assert name in ops, name
