"""Scalar semantics for every built-in GraphBLAS operator, over torch
tensors.

The port's copy of ``pygraphblas_tpu/ops/table.py``: the same tables
(``BINARY``, ``UNARY``, ``UNARY_POSITIONAL``, ``MONOIDS``,
``BOOL_MONOIDS``, ``SEMIRING_FAMILIES``), names, type lists and result
type rules.  Each closure takes the operands and the GraphBLAS type
``T`` they hold (a class of ``types.py``): a torch dtype alone does not
say whether an int32 tensor holds INT32 or UINT32 values, because
UINT16, UINT32 and UINT64 are held as bit views in int16, int32 and
int64 (torch cannot add, compare or divide its own unsigned dtypes).
Their order, division and logical right shift are the unsigned ones.

Integer semantics follow C / SuiteSparse: truncating division, x / 0
saturating at the type's max (min for x < 0; 0 / 0 is 0), wrap-around,
and boolean arithmetic mapped PLUS -> OR, TIMES -> AND, MINUS -> XOR,
DIV -> FIRST, MIN -> AND, MAX -> OR.
"""

import numpy as np
import torch

# ---------------------------------------------------------------------------
# type lists (names as in the JAX package)
# ---------------------------------------------------------------------------

ALL_TYPES = ("BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
             "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64")
INT_TYPES = ("INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
             "UINT64")
UINT_TYPES = ("UINT8", "UINT16", "UINT32", "UINT64")
FP_TYPES = ("FP32", "FP64")
FC_TYPES = ("FC32", "FC64")
REAL_TYPES = INT_TYPES + FP_TYPES
NONBOOL_TYPES = INT_TYPES + FP_TYPES + FC_TYPES
NONBOOL_REAL = INT_TYPES + FP_TYPES


def _is_bool(T):
    return T._kind == "b"


def _is_int(T):
    return T._kind in "iu"


def _is_uint(T):
    return T._kind == "u"


def _imax(T):
    """The type's max in its held representation (a Python int)."""
    return -1 if T._view else int(np.iinfo(T.numpy_dtype).max)


def _imin(T):
    return 0 if T._view else int(np.iinfo(T.numpy_dtype).min)


def _full(x, v):
    return torch.full_like(x, v)


# ---------------------------------------------------------------------------
# unsigned bit views: order, division, logical shifts
# ---------------------------------------------------------------------------


def _key(x, T):
    """An order-preserving signed image of x: a bit view flips its sign
    bit, so that signed order is the unsigned one."""
    if T._view:
        return x ^ (-(1 << (T._bits - 1)))
    return x


def _lt(x, y, T):
    return _key(x, T) < _key(y, T)


def _shr_logical(x, s, T):
    """x >>> s, with s of x's dtype read as unsigned: 0 for s >= bits
    (XLA's rule)."""
    bits = T._bits
    ok = (s >= 0) & (s < bits)
    s = torch.where(ok, s, torch.zeros_like(s)).to(x.dtype)
    if T.torch_dtype == torch.uint8:
        r = x >> s
    elif bits < 64:
        w = x.to(torch.int64) & ((1 << bits) - 1)
        r = (w >> s.to(torch.int64)).to(x.dtype)
    else:
        low = ~(torch.full_like(x, -1) << (64 - s.clamp(min=1)))
        r = torch.where(s > 0, (x >> s) & low, x)
    return torch.where(ok, r, torch.zeros_like(x))


def _shl(x, s, T):
    """x << s, with s read as unsigned: 0 for s >= bits."""
    ok = (s >= 0) & (s < T._bits)
    s = torch.where(ok, s, torch.zeros_like(s)).to(x.dtype)
    return torch.where(ok, x << s, torch.zeros_like(x))


def _udiv(x, y, T):
    """Unsigned x // y for a bit view, y != 0."""
    bits = T._bits
    if bits < 64:
        w = torch.int64
        m = (1 << bits) - 1
        return ((x.to(w) & m) // (y.to(w) & m)).to(x.dtype)
    # 64 bits: halve, divide, correct once; y >= 2^63 gives 0 or 1
    big = y < 0
    q_big = (~_lt(x, y, T)).to(x.dtype)
    ys = torch.where(big, torch.ones_like(y), y)
    q = ((_shr_logical(x, torch.ones_like(x), T)) // ys) << 1
    r = x - q * ys
    q = q + (~_lt(r, ys, T)).to(x.dtype)
    return torch.where(big, q_big, q)


# ---------------------------------------------------------------------------
# C-style arithmetic primitives
# ---------------------------------------------------------------------------


def _idiv(x, y, T):
    """C truncating integer division with SuiteSparse div-by-zero rules:
    x/0 -> 0 if x==0 else the type's max (its min for negative x), at
    the type itself (INT8: 5 / 0 is 127)."""
    z = y == 0
    if T._view:
        q = _udiv(x, torch.where(z, torch.ones_like(y), y), T)
        div0 = torch.where(x == 0, torch.zeros_like(x), _full(x, -1))
    elif _is_uint(T):
        q = torch.div(x, torch.where(z, torch.ones_like(y), y),
                      rounding_mode="trunc")
        div0 = torch.where(x == 0, torch.zeros_like(x), _full(x, _imax(T)))
    else:
        # y == -1 negates (wrapping: min / -1 is min), as C on the card
        m1 = y == -1
        safe = torch.where(z | m1, torch.ones_like(y), y)
        q = torch.where(m1, -x, torch.div(x, safe, rounding_mode="trunc"))
        div0 = torch.where(x == 0, torch.zeros_like(x),
                           torch.where(x < 0, _full(x, _imin(T)),
                                       _full(x, _imax(T))))
    return torch.where(z, div0, q)


def _div(x, y, T):
    if _is_bool(T):
        return x  # boolean division == FIRST
    if _is_int(T):
        return _idiv(x, y, T)
    return x / y


def _minus(x, y, T):
    if _is_bool(T):
        return torch.logical_xor(x, y)
    return x - y


def _plus(x, y, T):
    if _is_bool(T):
        return torch.logical_or(x, y)
    return x + y


def _times(x, y, T):
    if _is_bool(T):
        return torch.logical_and(x, y)
    return x * y


def _min(x, y, T):
    if _is_bool(T):
        return torch.logical_and(x, y)
    if T._view:
        return torch.where(_lt(y, x, T), y, x)
    return torch.minimum(x, y)


def _max(x, y, T):
    if _is_bool(T):
        return torch.logical_or(x, y)
    if T._view:
        return torch.where(_lt(x, y, T), y, x)
    return torch.maximum(x, y)


def _ipow(x, e):
    """Integer x ** e as the JAX package computes it (``jnp.power``'s
    ``_pow_int_int``): square and multiply over e's low six bits only,
    wrapping, from 0 where x == 0 and e != 0.  Six fixed rounds, so no
    value is read on the host."""
    r = torch.where((x == 0) & (e != 0), torch.zeros_like(x),
                    torch.ones_like(x))
    for k in range(6):
        r = torch.where(((e >> k) & 1) == 1, r * x, r)
        x = x * x
    return r


def power(x, y):
    """torch's pow, but an integer tensor ** tensor is the JAX
    package's (``_ipow``): the lowered user ops' ``pow``."""
    if x.dtype.is_floating_point or x.dtype.is_complex \
            or x.dtype == torch.bool:
        return torch.pow(x, y)
    return _ipow(x, y)


def _pow(x, y, T):
    if _is_bool(T):
        return torch.logical_or(x, torch.logical_not(y))
    if _is_int(T):
        # C-style: negative exponent -> integer reciprocal of x**|y|
        # (|y| wrapping at the type's minimum, as jnp.abs)
        if _is_uint(T):
            return _ipow(x, y)
        mag = _ipow(x, y.abs())
        recip = _idiv(torch.ones_like(mag), mag, T)
        return torch.where(y < 0, recip, mag)
    return torch.pow(x, y)


def _bool01(x, T):
    """truthiness of a value in its own type."""
    if _is_bool(T):
        return x
    return x != 0


def _logic(f):
    def op(x, y, T):
        r = f(_bool01(x, T), _bool01(y, T))
        return r if _is_bool(T) else r.to(x.dtype)
    return op


def _lxnor_fn(a, b):
    return torch.logical_not(torch.logical_xor(a, b))


def _bget(x, y, T):
    return _shr_logical(x, y, T) & 1


def _bset(x, y, T):
    return x | _shl(torch.ones_like(x), y, T)


def _bclr(x, y, T):
    return x & ~_shl(torch.ones_like(x), y, T)


def _bshift(x, y, T):
    # positive y: left shift; negative: logical right shift (y read as
    # int32, as the JAX package's y.astype(int32), and negated there with
    # wrap: -2^31 shifts by 0)
    yi = y.to(torch.int32)
    if T._view and T._bits == 16:
        yi = yi & 0xFFFF
    left = _shl(x, yi.to(torch.int64).clamp(min=0), T)
    right = _shr_logical(x, (-yi).to(torch.int64).clamp(min=0), T)
    return torch.where(yi >= 0, left, right)


def _remainder(x, y, T):
    # IEEE remainder: x - round(x/y)*y
    return x - torch.round(x / y) * y


def _cmp(f):
    def op(x, y, T):
        return f(_key(x, T), _key(y, T))
    return op


def _is(f):
    def op(x, y, T):
        return f(_key(x, T), _key(y, T)).to(x.dtype)
    return op


# ---------------------------------------------------------------------------
# Binary op table.
#
# Entry: name -> dict(fn, types, ztype, positional); fn(x, y, T).
#   ztype: "T" result is the operand type; "BOOL" boolean result;
#          "CMPLX" FPnn -> FCnn.  Positional ops take a `pos` namespace.
# ---------------------------------------------------------------------------

BINARY = {}


def _defbin(name, fn, types=ALL_TYPES, ztype="T", positional=None):
    BINARY[name] = dict(fn=fn, types=tuple(types), ztype=ztype,
                        positional=positional)


_NO_MINMAX_FC = tuple(t for t in ALL_TYPES if t not in FC_TYPES)

_defbin("FIRST", lambda x, y, T: x)
_defbin("SECOND", lambda x, y, T: y)
_defbin("ANY", lambda x, y, T: y)  # "any" picks an arbitrary operand
_defbin("PAIR", lambda x, y, T: torch.ones_like(x))
_defbin("MIN", _min, _NO_MINMAX_FC)
_defbin("MAX", _max, _NO_MINMAX_FC)
_defbin("PLUS", _plus)
_defbin("MINUS", _minus)
_defbin("RMINUS", lambda x, y, T: _minus(y, x, T))
_defbin("TIMES", _times)
_defbin("DIV", _div)
_defbin("RDIV", lambda x, y, T: _div(y, x, T))
_defbin("POW", _pow, _NO_MINMAX_FC + FC_TYPES)

_defbin("EQ", lambda x, y, T: x == y, ALL_TYPES, "BOOL")
_defbin("NE", lambda x, y, T: x != y, ALL_TYPES, "BOOL")
_defbin("GT", _cmp(torch.gt), _NO_MINMAX_FC, "BOOL")
_defbin("LT", _cmp(torch.lt), _NO_MINMAX_FC, "BOOL")
_defbin("GE", _cmp(torch.ge), _NO_MINMAX_FC, "BOOL")
_defbin("LE", _cmp(torch.le), _NO_MINMAX_FC, "BOOL")

# IS* comparators: result in the operand type (used inside semirings)
_defbin("ISEQ", _is(torch.eq), NONBOOL_REAL)
_defbin("ISNE", _is(torch.ne), NONBOOL_REAL)
_defbin("ISGT", _is(torch.gt), NONBOOL_REAL)
_defbin("ISLT", _is(torch.lt), NONBOOL_REAL)
_defbin("ISGE", _is(torch.ge), NONBOOL_REAL)
_defbin("ISLE", _is(torch.le), NONBOOL_REAL)

_defbin("LOR", _logic(torch.logical_or), _NO_MINMAX_FC)
_defbin("LAND", _logic(torch.logical_and), _NO_MINMAX_FC)
_defbin("LXOR", _logic(torch.logical_xor), _NO_MINMAX_FC)
_defbin("LXNOR", _logic(_lxnor_fn), ("BOOL",))

_defbin("BOR", lambda x, y, T: x | y, INT_TYPES)
_defbin("BAND", lambda x, y, T: x & y, INT_TYPES)
_defbin("BXOR", lambda x, y, T: x ^ y, INT_TYPES)
_defbin("BXNOR", lambda x, y, T: ~(x ^ y), INT_TYPES)
_defbin("BGET", _bget, INT_TYPES)
_defbin("BSET", _bset, INT_TYPES)
_defbin("BCLR", _bclr, INT_TYPES)
_defbin("BSHIFT", _bshift, INT_TYPES)

_defbin("ATAN2", lambda x, y, T: torch.atan2(x, y), FP_TYPES)
_defbin("HYPOT", lambda x, y, T: torch.hypot(x, y), FP_TYPES)
_defbin("FMOD", lambda x, y, T: torch.fmod(x, y), FP_TYPES)
_defbin("REMAINDER", _remainder, FP_TYPES)
_defbin("LDEXP", lambda x, y, T: torch.ldexp(x, y.to(torch.int32)).to(
    x.dtype), FP_TYPES)
_defbin("COPYSIGN", lambda x, y, T: torch.copysign(x, y), FP_TYPES)
_defbin("CMPLX", lambda x, y, T: torch.complex(x, y), FP_TYPES, "CMPLX")

# Positional ops: fn(pos) where pos has i0/j0 (first operand's indices) and
# i1/j1 (second operand's), already as int tensors broadcast to the output.
for _name, _key_, _off in (
    ("FIRSTI", "i0", 0),
    ("FIRSTI1", "i0", 1),
    ("FIRSTJ", "j0", 0),
    ("FIRSTJ1", "j0", 1),
    ("SECONDI", "i1", 0),
    ("SECONDI1", "i1", 1),
    ("SECONDJ", "j1", 0),
    ("SECONDJ1", "j1", 1),
):
    _defbin(_name, None, ("INT32", "INT64"), "T", positional=(_key_, _off))


# ---------------------------------------------------------------------------
# Unary op table: name -> dict(fn, types, ztype); fn(x, T)
# ---------------------------------------------------------------------------

UNARY = {}


def _defun(name, fn, types=ALL_TYPES, ztype="T"):
    UNARY[name] = dict(fn=fn, types=tuple(types), ztype=ztype)


def _abs(x, T):
    if _is_bool(T) or _is_uint(T):
        return x
    return torch.abs(x)


def _ainv(x, T):
    if _is_bool(T):
        return x
    return -x            # wraps, as C unsigned negation does


def _minv(x, T):
    if _is_bool(T):
        return torch.ones_like(x)
    if _is_int(T):
        return _idiv(torch.ones_like(x), x, T)
    return 1.0 / x


def _lnot(x, T):
    r = torch.logical_not(_bool01(x, T))
    return r if _is_bool(T) else r.to(x.dtype)


def _tgamma(x, T):
    # log|Gamma(x)| with the sign restored by the reflection pattern:
    # Gamma is negative exactly where x < 0 and floor(x) is odd
    neg = torch.remainder(torch.floor(x), 2.0) == 1.0
    sign = torch.where((x < 0) & neg, -1.0, 1.0).to(x.dtype)
    return sign * torch.exp(torch.lgamma(x))


def _frexpe(x, T):
    return torch.frexp(x)[1].to(x.dtype)


def _f(fn):
    return lambda x, T: fn(x)


_defun("IDENTITY", lambda x, T: x)
_defun("AINV", _ainv)
_defun("MINV", _minv)
_defun("ONE", lambda x, T: torch.ones_like(x))
_defun("ABS", _abs, ALL_TYPES, "ABSZ")
_defun("LNOT", _lnot, _NO_MINMAX_FC)

_FLOATY = FP_TYPES + FC_TYPES
for _name, _fn in (("SQRT", torch.sqrt), ("LOG", torch.log),
                   ("EXP", torch.exp), ("LOG2", torch.log2),
                   ("LOG10", torch.log10), ("LOG1P", torch.log1p),
                   ("EXP2", torch.exp2), ("EXPM1", torch.expm1),
                   ("SIN", torch.sin), ("COS", torch.cos),
                   ("TAN", torch.tan), ("ASIN", torch.asin),
                   ("ACOS", torch.acos), ("ATAN", torch.atan),
                   ("SINH", torch.sinh), ("COSH", torch.cosh),
                   ("TANH", torch.tanh), ("ASINH", torch.asinh),
                   ("ACOSH", torch.acosh), ("ATANH", torch.atanh)):
    _defun(_name, _f(_fn), _FLOATY)
_defun("SIGNUM", _f(torch.sign), FP_TYPES)
_defun("CEIL", _f(torch.ceil), FP_TYPES)
_defun("FLOOR", _f(torch.floor), FP_TYPES)
_defun("ROUND", _f(torch.round), FP_TYPES)
_defun("TRUNC", _f(torch.trunc), FP_TYPES)
_defun("LGAMMA", _f(torch.lgamma), FP_TYPES)
_defun("TGAMMA", _tgamma, FP_TYPES)
_defun("ERF", _f(torch.erf), FP_TYPES)
_defun("ERFC", _f(torch.erfc), FP_TYPES)
_defun("FREXPX", lambda x, T: torch.frexp(x)[0], FP_TYPES)
_defun("FREXPE", _frexpe, FP_TYPES)
_defun("ISINF", _f(torch.isinf), _FLOATY, "BOOL")
_defun("ISNAN", _f(torch.isnan), _FLOATY, "BOOL")
_defun("ISFINITE", _f(torch.isfinite), _FLOATY, "BOOL")
_defun("CONJ", _f(torch.conj_physical), FC_TYPES)
_defun("CREAL", _f(torch.real), FC_TYPES, "REAL")
_defun("CIMAG", _f(torch.imag), FC_TYPES, "REAL")
_defun("CARG", _f(torch.angle), FC_TYPES, "REAL")

UNARY_POSITIONAL = {
    "POSITIONI": ("i", 0),
    "POSITIONI1": ("i", 1),
    "POSITIONJ": ("j", 0),
    "POSITIONJ1": ("j", 1),
}
for _name in UNARY_POSITIONAL:
    UNARY[_name] = dict(fn=None, types=("INT32", "INT64"), ztype="T",
                        positional=UNARY_POSITIONAL[_name])


# ---------------------------------------------------------------------------
# Monoid table: op name -> (binop name, identity fn(numpy dtype), types).
# Identities are numpy values of the numpy dtype (np.uint16 for UINT16).
# ---------------------------------------------------------------------------


def _id_zero(dt):
    return np.zeros((), dt)


def _id_one(dt):
    if dt == np.bool_:
        return np.bool_(True)
    return np.ones((), dt)


def _id_min(dt):
    # identity of MIN = +inf / int max
    if np.issubdtype(dt, np.floating):
        return np.array(np.inf, dt)
    return np.array(np.iinfo(dt).max, dt)


def _id_max(dt):
    if np.issubdtype(dt, np.floating):
        return np.array(-np.inf, dt)
    return np.array(np.iinfo(dt).min, dt)


def _id_true(dt):
    return np.bool_(True)


def _id_false(dt):
    return np.bool_(False)


def _id_allbits(dt):
    return np.array(-1, "int64").astype(dt)


MONOIDS = {
    # name: (binop name, identity fn, types)
    "MIN": ("MIN", _id_min, NONBOOL_REAL),
    "MAX": ("MAX", _id_max, NONBOOL_REAL),
    "PLUS": ("PLUS", _id_zero, NONBOOL_TYPES),
    "TIMES": ("TIMES", _id_one, NONBOOL_TYPES),
    "ANY": ("ANY", _id_zero, NONBOOL_TYPES),
    "BOR": ("BOR", _id_zero, UINT_TYPES),
    "BAND": ("BAND", _id_allbits, UINT_TYPES),
    "BXOR": ("BXOR", _id_zero, UINT_TYPES),
    "BXNOR": ("BXNOR", _id_allbits, UINT_TYPES),
}

BOOL_MONOIDS = {
    "LOR": ("LOR", _id_false),
    "LAND": ("LAND", _id_true),
    "LXOR": ("LXOR", _id_false),
    "LXNOR": ("LXNOR", _id_true),
    "EQ": ("LXNOR", _id_true),
    "ANY": ("ANY", _id_false),
}

# ---------------------------------------------------------------------------
# Semiring families (the JAX package's five, ops/table.py:466-518).
# ---------------------------------------------------------------------------

SEMIRING_FAMILIES = [
    # non-boolean
    dict(
        adds=("MIN", "MAX", "PLUS", "TIMES", "ANY"),
        muls=(
            "FIRST", "FIRSTI", "FIRSTJ", "FIRSTI1", "FIRSTJ1",
            "SECOND", "SECONDI", "SECONDJ", "SECONDI1", "SECONDJ1",
            "MIN", "MAX", "PLUS", "MINUS", "RMINUS", "TIMES", "DIV", "RDIV",
            "ISEQ", "ISNE", "ISGT", "ISLT", "ISGE", "ISLE",
            "LOR", "LAND", "LXOR", "PAIR",
        ),
        types=NONBOOL_REAL,
        ztype="T",
    ),
    # boolean-producing comparators
    dict(
        adds=("LOR", "LAND", "LXOR", "EQ", "ANY"),
        muls=("EQ", "NE", "GT", "LT", "GE", "LE"),
        types=NONBOOL_REAL,
        ztype="BOOL",
    ),
    # pure boolean
    dict(
        adds=("LOR", "LAND", "LXOR", "EQ", "ANY"),
        muls=("FIRST", "SECOND", "LOR", "LAND", "LXOR", "EQ", "GT", "LT",
              "GE", "LE", "PAIR"),
        types=("BOOL",),
        ztype="T",
    ),
    # complex
    dict(
        adds=("PLUS", "TIMES", "ANY"),
        muls=("FIRST", "SECOND", "PLUS", "MINUS", "RMINUS", "TIMES", "DIV",
              "RDIV", "PAIR"),
        types=FC_TYPES,
        ztype="T",
    ),
    # bitwise
    dict(
        adds=("BOR", "BAND", "BXOR", "BXNOR"),
        muls=("BOR", "BAND", "BXOR", "BXNOR"),
        types=UINT_TYPES,
        ztype="T",
    ),
]
