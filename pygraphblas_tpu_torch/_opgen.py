"""The operator compiler: user-defined (and any other torch-traceable)
binary ops carried into the ``segfold`` and ``pair_fold`` kernels.

The JAX package traces whatever operator a semiring holds into its
Pallas kernels (``scan.py:_segfold_pallas`` folds with any ``combine``,
``spgemm.py:_pallas_fill_merge_fold`` applies any ``mul_op.apply``); the
port's kernels take built-in op codes (``csrc/ops.cuh``).  This module
gives them the rest:

1. **Lowering.**  ``lower(op, typ)`` traces ``op.apply`` (a BinaryOp, or
   a Monoid's op) with ``make_fx`` on 0-d ``meta`` tensors of the type's
   held dtype, so that a user op at an unsigned view carries its
   widening (``_unsigned.call``), and lowers the aten graph through a
   closed table (``_OPS``) to an IR: one node a value, computed at the
   dtype torch computes it at (``cdt``: the result's, or the operands'
   common dtype for a comparison), cast to its own dtype.  Python
   control flow on a value, an aten op outside the table, a UDT and a
   positional op do not lower: ``Unlowered`` says why, and the op keeps
   the tier it took before (``_kernels.unlowered[name] = reason``).
2. **Two renderings.**  ``source`` renders the IR as a CUDA functor,
   ``__device__ W operator()(W a, W b) const`` over the kernels' 4-byte
   words (``csrc/gen.cuh`` holds each op's device semantics);
   ``evaluate`` renders it as torch ops, which the CPU tests hold
   against ``op.apply``.
3. **Build.**  ``unit(add, typ, mul)`` puts the fold's functor, and the
   multiply's where one is given, into one translation unit that
   instantiates ``segfold`` (``csrc/scan.cuh``) and ``pair_fold``
   (``csrc/spgemm.cuh``) at the type's word, exporting
   ``pgb_segfold_gen`` and ``pgb_pair_fold_gen`` (the signatures of
   ``pgb_segfold`` and ``pgb_pair_fold`` without the op codes).  ``nvcc``
   compiles it with ``_kernels.build``'s flags into
   ``_build/gen/<hash>.so`` (the hash covers the source, the headers and
   the flags) at first use; it is loaded with ctypes and kept per
   source.  A unit that fails to compile raises, as a launch that fails
   does: nothing falls back to a plain version.

Imports no JAX; ``torch.fx`` only inside ``lower``.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels, _unsigned
from .ops import table

GEN_DIR = os.path.join(_kernels.BUILD_DIR, "gen")
_HEADERS = ("ops.cuh", "gen.cuh", "scan.cuh", "spgemm.cuh")

# unit hash -> nvcc seconds (builds of this process)
build_seconds = {}


class Unlowered(Exception):
    """An op that does not lower to a kernel functor, and why."""


@dataclass(frozen=True)
class Node:
    """One value of the IR: `op` ("arg", "const" or an ``_OPS`` name)
    over the values `args` (indices of earlier nodes), each cast to
    `cdt` first (None: as they are), the result cast to `dtype`;
    `value`: the op's static operand (a constant, a rounding mode, a
    pow exponent, clamp's bounds)."""

    op: str
    args: tuple
    dtype: torch.dtype
    cdt: object = None
    value: object = None


@dataclass(frozen=True)
class IR:
    """The nodes (the two inputs first) and the result's index."""

    nodes: tuple
    out: int


_C_TYPES = {torch.bool: "bool", torch.int8: "int8_t", torch.uint8: "uint8_t",
            torch.int16: "int16_t", torch.int32: "int32_t",
            torch.int64: "int64_t", torch.float32: "float",
            torch.float64: "double"}

# canonical op -> (device function in csrc/gen.cuh, torch function),
# each over operands already cast to the node's cdt
_BINARY = {
    "add": ("gen::add", torch.add), "sub": ("gen::sub", torch.sub),
    "mul": ("gen::mul", torch.mul), "div": ("gen::div", torch.div),
    "div_trunc": ("gen::div_trunc",
                  lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    "div_floor": ("gen::div_floor",
                  lambda a, b: torch.div(a, b, rounding_mode="floor")),
    "remainder": ("gen::remainder", torch.remainder),
    "fmod": ("gen::fmod_", torch.fmod), "pow": ("gen::ipow", table.power),
    "minimum": ("gen::minimum", torch.minimum),
    "maximum": ("gen::maximum", torch.maximum),
    "atan2": ("gen::m_atan2", torch.atan2),
    "hypot": ("gen::m_hypot", torch.hypot),
    "copysign": ("gen::m_copysign", torch.copysign),
    "bitwise_and": (None, torch.bitwise_and),
    "bitwise_or": (None, torch.bitwise_or),
    "bitwise_xor": (None, torch.bitwise_xor),
    "lshift": ("gen::lshift", torch.bitwise_left_shift),
    "rshift": ("gen::rshift", torch.bitwise_right_shift),
    "eq": (None, torch.eq), "ne": (None, torch.ne), "lt": (None, torch.lt),
    "le": (None, torch.le), "gt": (None, torch.gt), "ge": (None, torch.ge),
    "logical_and": (None, torch.logical_and),
    "logical_or": (None, torch.logical_or),
    "logical_xor": (None, torch.logical_xor),
}
_INFIX = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^",
          "eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
          "ge": ">=", "logical_and": "&&", "logical_or": "||",
          "logical_xor": "!="}
_UNARY = {
    "neg": ("gen::neg", torch.neg), "abs": ("gen::abs_", torch.abs),
    "sign": ("gen::sign", torch.sign),
    "reciprocal": ("gen::reciprocal", torch.reciprocal),
    "sqrt": ("gen::m_sqrt", torch.sqrt), "rsqrt": ("gen::rsqrt_", torch.rsqrt),
    "exp": ("gen::m_exp", torch.exp), "exp2": ("gen::m_exp2", torch.exp2),
    "log": ("gen::m_log", torch.log), "log2": ("gen::m_log2", torch.log2),
    "log1p": ("gen::m_log1p", torch.log1p),
    "expm1": ("gen::m_expm1", torch.expm1),
    "sin": ("gen::m_sin", torch.sin), "cos": ("gen::m_cos", torch.cos),
    "tanh": ("gen::m_tanh", torch.tanh), "sigmoid": ("gen::sigmoid", torch.sigmoid),
    "floor": ("gen::floor_", torch.floor), "ceil": ("gen::ceil_", torch.ceil),
    "trunc": ("gen::trunc_", torch.trunc),
    "round": ("gen::round_", torch.round),
    "bitwise_not": (None, torch.bitwise_not),
    "logical_not": (None, torch.logical_not),
}
# the comparisons and logical ops: computed at the operands' common dtype
# (bool for the logical ones), a bool result
_COMPARE = ("eq", "ne", "lt", "le", "gt", "ge")
_LOGICAL = ("logical_and", "logical_or", "logical_xor", "logical_not")

# aten overload packet -> canonical op (the closed table); the packets
# handled by name in _lower_call are listed in _SPECIAL
_OPS = {"add": "add", "sub": "sub", "rsub": "sub", "mul": "mul",
        "floor_divide": "div_floor", "remainder": "remainder",
        "fmod": "fmod", "minimum": "minimum", "maximum": "maximum",
        "atan2": "atan2", "hypot": "hypot", "copysign": "copysign",
        "bitwise_and": "bitwise_and", "bitwise_or": "bitwise_or",
        "bitwise_xor": "bitwise_xor", "__and__": "bitwise_and",
        "__or__": "bitwise_or", "__xor__": "bitwise_xor",
        "__lshift__": "lshift", "bitwise_left_shift": "lshift",
        "__rshift__": "rshift", "bitwise_right_shift": "rshift",
        "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt",
        "ge": "ge", "logical_and": "logical_and",
        "logical_or": "logical_or", "logical_xor": "logical_xor",
        **{u: u for u in _UNARY}}
_SPECIAL = ("div", "pow", "where", "clamp", "clamp_min", "clamp_max",
            "ldexp", "_to_copy", "full_like", "ones_like", "zeros_like",
            "scalar_tensor", "lift_fresh_copy", "clone", "alias",
            "detach")


def table():
    """The aten ops (overload packets) that lower."""
    return sorted(set(_OPS) | set(_SPECIAL))


def _wrap_int(v, dtype):
    """Python int v as torch's conversion to integer `dtype` keeps it."""
    bits = torch.iinfo(dtype).bits
    v = int(v) & ((1 << bits) - 1)
    if dtype != torch.uint8 and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _const_value(v, dtype):
    """Scalar v converted to `dtype` as torch converts it."""
    if dtype == torch.bool:
        return bool(v)
    if dtype.is_floating_point:
        return float(np.asarray(float(v)).astype(
            np.float32 if dtype == torch.float32 else np.float64))
    return _wrap_int(v, dtype)


class _Builder:
    """Appends IR nodes while walking a traced graph."""

    def __init__(self):
        self.nodes = []
        self.ref = {}              # fx node -> IR index

    def add(self, node):
        self.nodes.append(node)
        return len(self.nodes) - 1

    def const(self, v, dtype):
        if dtype not in _C_TYPES:
            raise Unlowered(f"a constant of dtype {dtype}")
        return self.add(Node("const", (), dtype,
                             value=_const_value(v, dtype)))

    def dtype_of(self, a):
        return self.nodes[a].dtype

    def operand(self, a, cdt):
        """An fx argument (a traced value or a Python number) as an IR
        index; numbers become constants of `cdt`."""
        import torch.fx

        if isinstance(a, torch.fx.Node):
            return self.ref[a]
        if isinstance(a, (bool, int, float)):
            return self.const(a, cdt)
        raise Unlowered(f"an operand {a!r}")


def _meta(dtype):
    return torch.empty((), dtype=dtype, device="meta")


def _result_type(b, args):
    """torch's common dtype of fx arguments (traced values and numbers)."""
    import torch.fx

    xs = [_meta(b.dtype_of(b.ref[a])) if isinstance(a, torch.fx.Node)
          else a for a in args]
    return torch.result_type(*xs)


def _lower_call(b, n, dtype):
    """One call_function node of the traced graph -> IR index."""
    target = n.target
    name = getattr(getattr(target, "overloadpacket", None), "__name__",
                   str(target))
    over = getattr(target, "_overloadname", "")
    args, kw = list(n.args), dict(n.kwargs)
    if name in ("lift_fresh_copy", "clone", "alias", "detach"):
        return b.ref[args[0]]
    if name == "_to_copy":
        for k in ("dtype", "layout", "device", "pin_memory",
                  "memory_format"):
            kw.pop(k, None)
        if kw:
            raise Unlowered(f"_to_copy with {sorted(kw)}")
        return b.add(Node("cast", (b.ref[args[0]],), dtype))
    if name in ("full_like", "ones_like", "zeros_like", "scalar_tensor"):
        v = {"ones_like": 1, "zeros_like": 0}.get(
            name, args[1] if name == "full_like" else args[0])
        return b.const(v, dtype)
    if name == "where":
        cond = b.operand(args[0], torch.bool)
        x, y = (b.operand(a, dtype) for a in args[1:3])
        return b.add(Node("where", (cond, x, y), dtype, dtype))
    if name in ("clamp", "clamp_min", "clamp_max"):
        lo = args[1] if len(args) > 1 else kw.pop("min", None)
        hi = args[2] if len(args) > 2 else kw.pop("max", None)
        if name == "clamp_max":
            lo, hi = None, lo
        if any(v is not None and not isinstance(v, (int, float))
               for v in (lo, hi)) or kw:
            raise Unlowered(f"aten.{name}.{over} with tensor bounds")
        return b.add(Node("clamp", (b.ref[args[0]],), dtype, dtype,
                          value=tuple(None if v is None
                                      else _const_value(v, dtype)
                                      for v in (lo, hi))))
    if name == "ldexp":
        e = b.ref[args[1]]
        if b.dtype_of(e).is_floating_point or not dtype.is_floating_point:
            raise Unlowered("ldexp with a float exponent")
        return b.add(Node("ldexp", (b.operand(args[0], dtype), e), dtype,
                          dtype))
    if name == "div":
        mode = kw.pop("rounding_mode", None)
        if kw:
            raise Unlowered(f"aten.div with {sorted(kw)}")
        op = {None: "div", "trunc": "div_trunc", "floor": "div_floor"}[mode]
        return b.add(Node(op, tuple(b.operand(a, dtype) for a in args),
                          dtype, dtype))
    if name == "pow":
        if over == "Tensor_Scalar":
            return b.add(Node("pow_c", (b.ref[args[0]],), dtype, dtype,
                              value=args[1]))
        return b.add(Node("pow", tuple(b.operand(a, dtype) for a in args),
                          dtype, dtype))
    op = _OPS.get(name)
    if op is None:
        raise Unlowered(f"aten.{name}.{over} is outside the table")
    if kw.pop("alpha", 1) != 1 or kw:
        raise Unlowered(f"aten.{name}.{over} with {sorted(n.kwargs)}")
    if name == "rsub":
        args = args[::-1]
    if op in _LOGICAL:
        cdt = torch.bool
    elif op in _COMPARE:
        cdt = _result_type(b, args)
    else:
        cdt = dtype
    if len(args) != (1 if op in _UNARY else 2):
        raise Unlowered(f"aten.{name}.{over} with {len(args)} operands")
    return b.add(Node(op, tuple(b.operand(a, cdt) for a in args), dtype,
                      cdt))


def _trace(op, typ):
    """The aten graph of op.apply over 0-d meta tensors of typ's held
    dtype."""
    from torch.fx.experimental.proxy_tensor import make_fx

    dt = typ.torch_dtype
    try:
        with _unsigned.lowering():
            return make_fx(lambda x, y: op.apply(x, y))(_meta(dt),
                                                        _meta(dt))
    except Exception as e:  # the op's own error, from any line of it
        msg = str(e).strip().splitlines()
        raise Unlowered(f"tracing failed: {type(e).__name__}: "
                        f"{msg[0] if msg else ''}") from None


def _lower(op, typ):
    if getattr(op, "positional", None) is not None:
        raise Unlowered("a positional op")
    if getattr(op, "udt", None) is not None:
        raise Unlowered("a UDT op")
    if typ is None or typ.__name__ not in _kernels.TYPE_CODES:
        raise Unlowered(f"no kernel word for "
                        f"{getattr(typ, '__name__', typ)}")
    g = _trace(op, typ)
    b = _Builder()
    out = None
    for n in g.graph.nodes:
        val = n.meta.get("val")
        dtype = getattr(val, "dtype", None)
        if n.op == "output":
            res = n.args[0]
            if isinstance(res, (tuple, list)):
                if len(res) != 1:
                    raise Unlowered("an op with several results")
                res = res[0]
            out = b.operand(res, typ.torch_dtype)
            continue
        if dtype not in _C_TYPES or (val is not None and val.dim() != 0):
            raise Unlowered(f"a value of dtype {dtype} and shape "
                            f"{tuple(getattr(val, 'shape', ()))}")
        if n.op == "placeholder":
            b.ref[n] = b.add(Node("arg", (), dtype, value=len(b.ref)))
        elif n.op == "get_attr":
            t = getattr(g, n.target)
            if t.numel() != 1:
                raise Unlowered("a tensor constant of several values")
            b.ref[n] = b.const(t.item(), dtype)
        elif n.op == "call_function":
            b.ref[n] = _lower_call(b, n, dtype)
        else:
            raise Unlowered(f"an fx node of kind {n.op}")
    return IR(tuple(b.nodes), out)


# (op object, type name) -> IR or Unlowered, for this process
_LOWERED = {}


def lower(op, typ):
    """The IR of BinaryOp `op` (or Monoid: its op) at Type `typ`; raises
    Unlowered (and records the reason in ``_kernels.unlowered``)."""
    op = getattr(op, "binaryop", op)
    key = (op, typ.__name__)
    if key not in _LOWERED:
        try:
            _LOWERED[key] = _lower(op, typ)
        except Unlowered as e:
            _LOWERED[key] = e
    got = _LOWERED[key]
    if isinstance(got, Unlowered):
        _kernels.unlowered[op.name] = str(got)
        raise got
    return got


def lowers(op, typ):
    """Whether `op` lowers at `typ` (decided before any launch)."""
    try:
        lower(op, typ)
        return True
    except Unlowered:
        return False


# ---------------------------------------------------------------------------
# the torch rendering


def evaluate(ir, x, y):
    """The IR as torch ops on tensors x, y of its held dtype."""
    vals = []
    for n in ir.nodes:
        a = [vals[i].to(n.cdt) if n.cdt is not None else vals[i]
             for i in n.args]
        if n.op == "arg":
            v = (x, y)[n.value]
        elif n.op == "const":
            v = torch.tensor(n.value, dtype=n.dtype, device=x.device)
        elif n.op == "cast":
            v = a[0]
        elif n.op == "where":
            v = torch.where(vals[n.args[0]], a[1], a[2])
        elif n.op == "clamp":
            lo, hi = n.value
            v = a[0]
            if lo is not None:
                v = torch.clamp(v, min=lo)
            if hi is not None:
                v = torch.clamp(v, max=hi)
        elif n.op == "ldexp":
            v = torch.ldexp(a[0], vals[n.args[1]])
        elif n.op == "pow_c":
            v = torch.pow(a[0], n.value)
        elif n.op in _BINARY:
            v = _BINARY[n.op][1](*a)
        else:
            v = _UNARY[n.op][1](*a)
        vals.append(v.to(n.dtype))
    out = vals[ir.out]
    shape = torch.broadcast_shapes(x.shape, y.shape)
    return out if out.shape == shape else out.expand(shape).clone()


# ---------------------------------------------------------------------------
# the CUDA rendering


def _literal(v, dtype):
    if dtype == torch.bool:
        return "true" if v else "false"
    if dtype == torch.float32:
        if v != v:
            return "__int_as_float(0x7fc00000)"
        if v in (float("inf"), float("-inf")):
            return ("-" if v < 0 else "") + "__int_as_float(0x7f800000)"
        return repr(float(v)) + "f"
    if dtype == torch.float64:
        if v != v:
            return "__longlong_as_double(0x7ff8000000000000LL)"
        if v in (float("inf"), float("-inf")):
            return (("-" if v < 0 else "")
                    + "__longlong_as_double(0x7ff0000000000000LL)")
        return repr(float(v))
    ct = _C_TYPES[dtype]
    if dtype == torch.int64 and v == -(1 << 63):
        return "(int64_t)(-9223372036854775807LL - 1)"
    return f"({ct})({v}LL)"


def _pow_c(a, e, ct, dtype):
    """x ** e for a constant e, as torch's CPU pow_tensor_scalar (its
    special cases for 2, 3, 0.5, -0.5, -1 and -2 on floats)."""
    if dtype.is_floating_point:
        special = {2: f"gen::mul({a}, {a})",
                   3: f"gen::mul(gen::mul({a}, {a}), {a})",
                   0.5: f"gen::m_sqrt({a})", -0.5: f"gen::rsqrt_({a})",
                   -1: f"gen::reciprocal({a})",
                   -2: f"gen::reciprocal(gen::mul({a}, {a}))"}
        if e in special:
            return special[e]
    return f"gen::pow_<{ct}>({a}, {_literal(_const_value(e, dtype), dtype)})"


def _expr(n, a, ct):
    """The C++ expression of node n over operand expressions a (cast to
    its cdt)."""
    if n.op in _INFIX:
        return f"({a[0]} {_INFIX[n.op]} {a[1]})"
    if n.op == "logical_not":
        return f"(!{a[0]})"
    if n.op == "bitwise_not":
        return f"(!{a[0]})" if n.cdt == torch.bool else f"(~{a[0]})"
    if n.op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if n.op == "clamp":
        lo, hi = n.value
        cdt = _C_TYPES[n.cdt]
        return (f"gen::clamp<{cdt}>({a[0]}, {'true' if lo is not None else 'false'}, "
                f"{_literal(lo if lo is not None else 0, n.cdt)}, "
                f"{'true' if hi is not None else 'false'}, "
                f"{_literal(hi if hi is not None else 0, n.cdt)})")
    if n.op == "ldexp":
        return f"gen::ldexp_({a[0]}, {a[1]})"
    if n.op == "pow_c":
        return _pow_c(a[0], n.value, _C_TYPES[n.cdt], n.cdt)
    fn = (_BINARY.get(n.op) or _UNARY[n.op])[0]
    return f"{fn}<{_C_TYPES[n.cdt]}>({', '.join(a)})"


def _word(typ):
    """The C type of typ's kernel words, and of its held values."""
    return ("float" if typ.__name__ == "FP32" else
            "uint32_t" if typ.__name__ == "UINT32" else "int32_t",
            _C_TYPES[typ.torch_dtype])


def functor(ir, typ, name):
    """The IR as a CUDA functor struct `name` over typ's kernel words: a
    word is read as its held value (UINT16 and UINT32 words as their
    bit views), the result cast to the held dtype, then widened back
    (UINT16 zero-extended), as ``_kernels.to_words`` widens."""
    w, h = _word(typ)
    body = []
    for i, n in enumerate(ir.nodes):
        ct = _C_TYPES[n.dtype]
        if n.op == "arg":
            e = f"gen::cast<{h}>(w{n.value})"
        elif n.op == "const":
            e = _literal(n.value, n.dtype)
        elif n.op == "cast":
            e = f"v{n.args[0]}"
        else:
            ops = []
            for k, j in enumerate(n.args):
                cdt = (torch.bool if n.op == "where" and k == 0 else
                       None if n.op == "ldexp" and k == 1 else n.cdt)
                src = ir.nodes[j].dtype
                ops.append(f"v{j}" if cdt is None or src == cdt else
                           f"gen::cast<{_C_TYPES[cdt]}>(v{j})")
            e = _expr(n, ops, ct)
        body.append(f"    const {ct} v{i} = gen::cast<{ct}>({e});")
    out = f"gen::cast<{h}>(v{ir.out})"
    if typ.__name__ == "UINT16":
        ret = f"(int32_t)(uint16_t){out}"
    else:
        ret = f"gen::cast<{w}>({out})"
    return (f"struct {name} {{\n"
            f"  __device__ __forceinline__ {w} operator()({w} w0, {w} w1) "
            f"const {{\n" + "\n".join(body) + f"\n    return {ret};\n"
            f"  }}\n}};\n")


_UNIT = """\
// Generated by pygraphblas_tpu_torch/_opgen.py: {what} at {typ}.
#include "gen.cuh"
#include "scan.cuh"
#include "spgemm.cuh"

namespace {{

{functors}
constexpr int kDtype = {code};
using Word = {word};

}}  // namespace

extern "C" int pgb_segfold_gen(const void* vals, const void* flags, void* out,
                               int64_t n, int dtype, void* status,
                               uint32_t epoch, void* ticket, void* stream) {{
  if (n <= 0) return 0;
  if (n % 1024 || epoch == 0 || epoch >= (1u << 29) || dtype != kDtype)
    return -1;
  return scan::launch_segfold<Word, GenFold>(vals, flags, out, n, status,
                                             epoch, ticket,
                                             (cudaStream_t)stream);
}}
{pair_fold}"""

_PAIR_FOLD = """
extern "C" int pgb_pair_fold_gen(const void* a, const void* av, int64_t a_len,
                                 const void* b, const void* bv, int64_t b_len,
                                 const void* ast, const void* wa,
                                 const void* bst, const void* wb, void* cnt,
                                 void* out, int64_t n_edges, int width,
                                 int runs, int dtype, uint32_t ident_bits,
                                 void* stream) {
  if (n_edges <= 0) return 0;
  if (dtype != kDtype) return -1;
  return spgemm::launch_fold<Word>(
      (const int32_t*)a, av, a_len, (const int32_t*)b, bv, b_len,
      (const int32_t*)ast, (const int32_t*)wa, (const int32_t*)bst,
      (const int32_t*)wb, (int32_t*)cnt, out, n_edges, width, runs != 0,
      GenMul{}, GenFold{}, ident_bits, (cudaStream_t)stream);
}
"""


def source(add, typ, mul=None):
    """The translation unit for add monoid `add` (and multiply `mul`)
    at Type `typ`; raises Unlowered."""
    fold = functor(lower(add, typ), typ, "GenFold")
    funcs = fold + ("\n" + functor(lower(mul, typ), typ, "GenMul")
                    if mul is not None else "")
    what = f"fold {add.name}" + (f", multiply {mul.name}" if mul else "")
    return _UNIT.format(what=what, typ=typ.__name__, functors=funcs,
                        code=_kernels.TYPE_CODES[typ.__name__],
                        word=_word(typ)[0],
                        pair_fold=_PAIR_FOLD if mul is not None else "")


def digest(src):
    """The unit's build hash: its source, the kernel headers, the
    flags."""
    h = hashlib.sha1(src.encode())
    for name in _HEADERS:
        with open(os.path.join(_kernels.CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(_kernels.COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def build(src):
    """Compile a unit (reusing a finished build of the same hash); its
    path.  Raises RuntimeError with nvcc's output where it fails."""
    out = os.path.join(GEN_DIR, digest(src) + ".so")
    if os.path.exists(out):
        return out
    nvcc = _kernels._nvcc()
    os.makedirs(GEN_DIR, exist_ok=True)
    cu = out[:-3] + f".{os.getpid()}.cu"
    tmp = out + f".{os.getpid()}.tmp"
    with open(cu, "w") as f:
        f.write(src)
    t0 = time.perf_counter()
    try:
        p = subprocess.run([nvcc, *_kernels.COMPILE_FLAGS, "-I",
                            _kernels.CSRC, "-shared", cu, "-o", tmp],
                           capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed on a generated kernel "
                               f"({src.splitlines()[0]}):\n{p.stdout}"
                               f"{p.stderr}")
        os.replace(tmp, out)
    finally:
        for f in (cu, tmp):
            if os.path.exists(f):
                os.remove(f)
    build_seconds[os.path.basename(out)[:-3]] = time.perf_counter() - t0
    return out


# unit hash -> loaded library; (fold functor, type name) -> a loaded
# library whose pgb_segfold_gen folds with it
_LIBS = {}
_FOLDS = {}


def unit(add, typ, mul=None):
    """The loaded library of the unit for (add, typ, mul), built at
    first use; raises Unlowered where an op does not lower."""
    src = source(add, typ, mul)
    key = digest(src)
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(build(src))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pgb_segfold_gen.argtypes = [p, p, p, i64, i32, p,
                                        ctypes.c_uint32, p, p]
        lib.pgb_segfold_gen.restype = i32
        if mul is not None:
            lib.pgb_pair_fold_gen.argtypes = [p, p, i64, p, p, i64, p, p, p,
                                              p, p, p, i64, i32, i32, i32,
                                              ctypes.c_uint32, p]
            lib.pgb_pair_fold_gen.restype = i32
        _LIBS[key] = lib
        _FOLDS[(functor(lower(add, typ), typ, "GenFold"), typ.__name__)] = lib
    return lib


def fold_unit(add, typ):
    """A loaded library whose ``pgb_segfold_gen`` folds with `add` at
    `typ`: one already loaded for a semiring with this monoid (so that
    a semiring's products and folds share one build), else its own."""
    lib = _FOLDS.get((functor(lower(add, typ), typ, "GenFold"),
                      typ.__name__))
    return lib if lib is not None else unit(add, typ)
