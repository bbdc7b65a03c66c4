"""User operators at the unsigned bit-view types, and integer ``**``.

UINT16, UINT32 and UINT64 are held as signed bit views (int16, int32,
int64: ``types.py``), while the JAX package hands a user operator the
unsigned values.  ``call`` applies a user op's function as the JAX
package does: UINT16 values widened to int32 and UINT32 ones to int64
(their unsigned values), the result narrowed back to the held bit view
(a BOOL result stays BOOL; a float one converted as XLA converts it,
saturating).  Torch cannot widen UINT64, so a UINT64 function is handed
:class:`Wrapping64` values, which compute uint64's answers on the int64
bits: the comparisons, ``//``, ``%`` and ``>>`` are the unsigned ones
(``x // 0`` is 2^64-1 and ``x % 0`` is 0, as the JAX package's),
``/`` divides the float64 values, ``**`` is integer ``**`` as below,
and the operations that give the same bits in the int64 view (``+``,
``-``, ``*``, negation, ``&``, ``|``, ``^``, ``~``, ``<<``,
``torch.where``, ``torch.minimum``/``maximum``) wrap as uint64 does.
Anything else (a float operand, a tensor method) raises TypeError:
never the signed answer.

An integer ``tensor ** tensor`` in a user op is ``jnp.power``'s, as the
JAX package traces it: square and multiply over the exponent's low six
bits (``ops/table.py:_ipow``).  ``call`` applies that rule through a
torch function mode; an exponent that is a Python int keeps torch's
``pow`` (the whole exponent, as ``lax.integer_pow``).  ``_opgen`` traces
a user op with the mode off (``lowering``), so that its ``pow`` lowers
to ``csrc/gen.cuh``'s ``ipow``, which computes the same rule.
"""

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from . import types
from .ops import table

_FLIP64 = -(1 << 63)
_POW_NAMES = ("pow", "__pow__", "__rpow__")
_expand_pow = [True]


class _IntPow(TorchFunctionMode):
    """Integer tensor ** tensor as ``table._ipow`` (see the module's
    note); every other call as it is."""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _POW_NAMES and not kwargs and len(args) == 2:
            x, e = args[::-1] if name == "__rpow__" else args
            if isinstance(e, torch.Tensor) \
                    and (isinstance(x, torch.Tensor)
                         or (isinstance(x, int) and not isinstance(x, bool))):
                dt = torch.result_type(x, e)
                if not (dt.is_floating_point or dt.is_complex
                        or dt == torch.bool):
                    x = (x.to(dt) if isinstance(x, torch.Tensor)
                         else torch.full_like(e, x, dtype=dt))
                    x, e = torch.broadcast_tensors(x, e.to(dt))
                    return table._ipow(x, e)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def lowering():
    """User ops called in this scope keep torch's ``pow`` (the operator
    compiler traces it as one aten op)."""
    _expand_pow[0] = False
    try:
        yield
    finally:
        _expand_pow[0] = True


def call(fn, T, *args):
    """fn(*args) for a user op at Type T (held tensors in and out)."""
    with _IntPow() if _expand_pow[0] else contextlib.nullcontext():
        if not getattr(T, "_view", False):
            return fn(*args)
        if T._bits == 64:
            z = fn(*(Wrapping64(a) for a in args))
            z = z.bits if isinstance(z, Wrapping64) else z
        else:
            wide = torch.int32 if T._bits == 16 else torch.int64
            low = (1 << T._bits) - 1
            z = fn(*(a.to(wide) & low for a in args))
    if not isinstance(z, torch.Tensor) or z.dtype == torch.bool:
        return z
    if z.is_floating_point():
        z = _from_float(z, T._bits)
    return z.to(T.torch_dtype)


def _from_float(z, bits):
    """Float values as XLA converts them to an unsigned type of `bits`
    bits (NaN and negatives 0, saturating at 2^bits - 1), as int64 bits."""
    z = torch.nan_to_num(z.double(), nan=0.0).clamp(min=0)
    if bits < 64:
        return z.clamp(max=(1 << bits) - 1).to(torch.int64)
    hi = z >= 2.0 ** 63
    low = torch.where(hi, z - 2.0 ** 63, z).clamp(max=2.0 ** 63 - 1024)
    low = low.to(torch.int64)
    out = torch.where(hi, low ^ _FLIP64, low)
    return torch.where(z >= 2.0 ** 64, torch.full_like(out, -1), out)


def _refuse(what):
    raise TypeError(
        f"a user operator at UINT64 computes on its values (which torch "
        f"holds as int64 bits) with Python ints and other UINT64 values "
        f"through the operators, torch.where and torch.minimum/maximum; "
        f"not {what}: torch has no uint64 arithmetic")


def _bits(x):
    """A Wrapping64's bits, or a Python int's as int64 bits."""
    if isinstance(x, Wrapping64):
        return x.bits
    if isinstance(x, int) and not isinstance(x, bool) \
            and -(1 << 63) <= x < (1 << 64):
        return x - (1 << 64) if x >= (1 << 63) else x
    _refuse(type(x).__name__)


def _tensor(x, like):
    b = _bits(x)
    return b if isinstance(b, torch.Tensor) else torch.full_like(like, b)


def _f64(b):
    """The unsigned values of int64 bits as float64, rounded once (the
    halved value keeps the lost bit sticky)."""
    half = ((b >> 1) & ~_FLIP64) | (b & 1)
    return torch.where(b >= 0, b.double(), half.double() * 2)


def _floordiv(a, b):
    z = b == 0
    q = table._udiv(a, torch.where(z, torch.ones_like(b), b), types.UINT64)
    return torch.where(z, torch.full_like(a, -1), q)


def _mod(a, b):
    b = torch.where(b == 0, torch.ones_like(b), b)
    return a - table._udiv(a, b, types.UINT64) * b


def _pow(a, e):
    if isinstance(e, int):
        if e < 0:
            _refuse(f"a negative power {e}")
        r = torch.ones_like(a)
        while e:               # the whole exponent (lax.integer_pow)
            if e & 1:
                r = r * a
            a, e = a * a, e >> 1
        return r
    return table._ipow(a, e)


def _binary(f, reflected=False, wrap=True, int_right=False):
    """A Wrapping64 operator from f over int64 bit tensors (`int_right`:
    f takes the right operand as a Python int unchanged)."""
    def op(self, other):
        if int_right and not reflected and isinstance(other, int) \
                and not isinstance(other, bool):
            r = f(self.bits, other)
        else:
            o = _tensor(other, self.bits)
            r = f(o, self.bits) if reflected else f(self.bits, o)
        return Wrapping64(r) if wrap else r
    return op


def _order(f):
    def op(self, other):
        return f(self.bits ^ _FLIP64, _bits(other) ^ _FLIP64)
    return op


def _shr(a, s):
    return table._shr_logical(a, s, types.UINT64)


def _shl(a, s):
    return table._shl(a, s, types.UINT64)


def _div(a, b):
    return _f64(a) / _f64(b)


class Wrapping64:
    """UINT64 values held as their int64 bits, as a user operator sees
    them (see the module's note)."""

    __slots__ = ("bits",)
    __hash__ = None

    def __init__(self, bits):
        self.bits = bits

    __add__ = _binary(lambda a, b: a + b)
    __radd__ = _binary(lambda a, b: a + b, True)
    __sub__ = _binary(lambda a, b: a - b)
    __rsub__ = _binary(lambda a, b: a - b, True)
    __mul__ = _binary(lambda a, b: a * b)
    __rmul__ = _binary(lambda a, b: a * b, True)
    __and__ = _binary(lambda a, b: a & b)
    __rand__ = _binary(lambda a, b: a & b, True)
    __or__ = _binary(lambda a, b: a | b)
    __ror__ = _binary(lambda a, b: a | b, True)
    __xor__ = _binary(lambda a, b: a ^ b)
    __rxor__ = _binary(lambda a, b: a ^ b, True)
    __floordiv__ = _binary(_floordiv)
    __rfloordiv__ = _binary(_floordiv, True)
    __mod__ = _binary(_mod)
    __rmod__ = _binary(_mod, True)
    __lshift__ = _binary(_shl)
    __rlshift__ = _binary(_shl, True)
    __rshift__ = _binary(_shr)
    __rrshift__ = _binary(_shr, True)
    __pow__ = _binary(_pow, int_right=True)
    __rpow__ = _binary(_pow, True)
    __truediv__ = _binary(_div, wrap=False)
    __rtruediv__ = _binary(_div, True, wrap=False)
    __lt__ = _order(lambda a, b: a < b)
    __le__ = _order(lambda a, b: a <= b)
    __gt__ = _order(lambda a, b: a > b)
    __ge__ = _order(lambda a, b: a >= b)

    def __divmod__(self, other):
        return self // other, self % other

    def __rdivmod__(self, other):
        return other // self, other % self

    def __eq__(self, other):
        return self.bits == _bits(other)

    def __ne__(self, other):
        return self.bits != _bits(other)

    def __neg__(self):
        return Wrapping64(-self.bits)

    def __invert__(self):
        return Wrapping64(~self.bits)

    def __pos__(self):
        return self

    __abs__ = __pos__

    def __bool__(self):
        _refuse("truth testing")

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        if kwargs:
            _refuse(f"{getattr(func, '__name__', func)} with keywords")
        if func is torch.where and len(args) == 3:
            cond, a, b = args
            like = a.bits if isinstance(a, Wrapping64) else b.bits
            return Wrapping64(torch.where(cond, _tensor(a, like),
                                          _tensor(b, like)))
        if func in (torch.minimum, torch.maximum) and len(args) == 2:
            a, b = (x if isinstance(x, Wrapping64) else Wrapping64(_tensor(
                x, args[0].bits if isinstance(args[0], Wrapping64)
                else args[1].bits)) for x in args)
            lt = a < b
            pick = lt if func is torch.minimum else ~lt
            return Wrapping64(torch.where(pick, a.bits, b.bits))
        _refuse(getattr(func, "__name__", str(func)))

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        _refuse(f"attribute {name!r}")


def _refuse_op(name):
    def op(self, *args):
        _refuse(name)
    op.__name__ = name
    return op


for _name in ("int", "float", "index", "getitem"):
    setattr(Wrapping64, f"__{_name}__", _refuse_op(f"__{_name}__"))
del _name
