"""GraphBLAS type system on torch dtypes, including User Defined Types.

The port's counterpart of ``pygraphblas_tpu/types.py``: the 13 built-in
scalar types (BOOL, signed and unsigned ints of 8 to 64 bits, FP32/64,
FC32/64) are Python classes carrying a numpy dtype and the torch dtype
that holds their values, their default ops, formatting rules, and the
promotion lattice.  Operators, monoids and semirings are attached as
attributes when the package is imported (``FP32.PLUS_TIMES``,
``INT8.PLUS_MONOID``, ``UINT32.BOR``).

How values are held (``torch_dtype``): torch cannot add, compare or
divide its unsigned 16-, 32- and 64-bit dtypes, so UINT16, UINT32 and
UINT64 are held as bit views in int16, int32 and int64 (``_view``): the
same bits, and the op closures (``ops/table.py``) give them unsigned
order, division and shifts.  UINT8 is torch.uint8; FC32 and FC64 are
complex64 and complex128.  ``to_torch`` and ``to_numpy`` convert
without copying the bits.

On the card, every type of 4 bytes or less reaches the kernels as
4-byte words (``_kernels.to_words``): FP32 as float32, INT32 and UINT32
as int32, and BOOL, INT8, INT16, UINT8 and UINT16 widened to int32
(sign- or zero-extended), narrowed again on the way out.

User defined types are struct-of-tensors: a UDT declares named members,
each held in its own tensor of the mapped dtype; they never reach a
kernel (nor did they in the JAX package).
"""

import numpy
import torch

__all__ = [
    "Type", "BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
    "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64", "binop", "promote",
]


class MetaType(type):
    """Metaclass registry: name <-> Type class <-> numpy dtype."""

    _name_type_map = {}
    _dtype_type_map = {}

    def __new__(meta, type_name, bases, attrs):
        if attrs.get("base", False):
            return super().__new__(meta, type_name, bases, attrs)
        cls = super().__new__(meta, type_name, bases, attrs)
        meta._name_type_map[type_name] = cls
        if getattr(cls, "_numpy_t", None) is not None:
            meta._dtype_type_map.setdefault(
                numpy.dtype(cls._numpy_t).type, cls)
        cls._c_type = attrs.get("_c_type", type_name)
        meta._name_type_map.setdefault(cls._c_type, cls)
        return cls

    @property
    def name(cls):
        return cls.__name__

    @property
    def numpy_dtype(cls):
        return numpy.dtype(cls._numpy_t)

    @property
    def _dtype_gb_map(cls):
        return MetaType._dtype_type_map

    def new_monoid(cls, op, identity):
        """Create a new monoid from a binary op and identity value."""
        from .monoid import Monoid

        m = Monoid(op.name.split("_")[0], cls.__name__, op_obj=op,
                   identity=identity, attach=False)
        setattr(cls, m.op + "_MONOID", m)
        setattr(cls, m.op.lower() + "_monoid", m)
        return m

    def new_semiring(cls, monoid, op):
        """Create a new semiring from a monoid and a binary op."""
        from .semiring import Semiring

        sr = Semiring(monoid.op, op.name.split("_")[0], cls.__name__,
                      add=monoid, mul_op=op, attach=False, type_cls=cls)
        setattr(cls, f"{sr.pls}_{sr.mul}", sr)
        setattr(cls, f"{sr.pls}_{sr.mul}".lower(), sr)
        return sr

    def gb_from_name(cls, name):
        return MetaType._name_type_map[name]

    def __repr__(cls):
        return f"<class 'pygraphblas_tpu_torch.types.{cls.__name__}'>"


def _gb_from_dtype(dtype):
    """numpy dtype -> Type class."""
    return MetaType._dtype_type_map[numpy.dtype(dtype).type]


class Type(metaclass=MetaType):
    """Base class for GraphBLAS types."""

    default_one = 1
    """The default value used to represent 1 for filling in types."""
    default_zero = 0
    """The default value used to represent 0 for filling in types."""
    base = True
    _typecode = None
    _numpy_t = None
    torch_dtype = None        # the dtype that holds the values
    _kind = None              # numpy kind: b i u f c
    _bits = 0
    _view = False             # held as a signed bit view (UINT16/32/64)
    _allows_bitmap = True
    members = None  # UDTs override

    @classmethod
    def format_value(cls, val, width=2, prec=None):
        """Return the value as a formatted string for display."""
        return f"{val:{width}}"

    @classmethod
    def _default_addop(cls):
        return cls.PLUS

    @classmethod
    def _default_multop(cls):
        return cls.TIMES

    @classmethod
    def _default_semiring(cls):
        return cls.PLUS_TIMES

    @classmethod
    def _from_value(cls, value):
        return value

    @classmethod
    def _to_value(cls, data):
        """Convert a raw array element to a Python scalar."""
        return data.item() if hasattr(data, "item") else data

    @classmethod
    def _coerce(cls, value):
        """Coerce a Python value into this type's numpy scalar."""
        return numpy.dtype(cls._numpy_t).type(value)

    @classmethod
    def to_torch(cls, a, device="cpu"):
        """numpy array (any dtype castable to this type) -> tensor of the
        held dtype on `device`, the same bits."""
        a = numpy.ascontiguousarray(numpy.asarray(a).astype(cls._numpy_t))
        if cls._view:
            a = a.view(_SIGNED[cls._bits])
        return torch.from_numpy(a.copy()).to(device)

    @classmethod
    def to_numpy(cls, t):
        """tensor of the held dtype -> numpy array of this type."""
        a = t.detach().cpu().numpy()
        return a.view(cls._numpy_t) if cls._view else a.astype(
            cls._numpy_t, copy=False)

    @classmethod
    def scalar(cls, v):
        """numpy or Python scalar of this type -> a Python scalar of the
        held dtype (a bit view's value as its signed image)."""
        v = numpy.asarray(v).astype(cls._numpy_t)
        if cls._view:
            v = v.view(_SIGNED[cls._bits])
        return v.item()


_SIGNED = {16: numpy.int16, 32: numpy.int32, 64: numpy.int64}


class BOOL(Type):
    """GraphBLAS Boolean Type."""

    _c_type = "_Bool"
    default_one = True
    default_zero = False
    _typecode = "B"
    _numpy_t = numpy.bool_
    torch_dtype = torch.bool
    _kind, _bits = "b", 8

    @classmethod
    def _default_addop(cls):
        return cls.LOR

    @classmethod
    def _default_multop(cls):
        return cls.LAND

    @classmethod
    def _default_semiring(cls):
        return cls.LOR_LAND

    @classmethod
    def format_value(cls, val, width=2, prec=None):
        f = "{:>%s}" % width
        if not isinstance(val, (bool, numpy.bool_)):
            return f.format(val)
        return f.format("t") if val else f.format("f")

    @classmethod
    def _to_value(cls, data):
        return bool(data)


class INT8(Type):
    """GraphBLAS 8 bit signed integer."""

    _c_type = "int8_t"
    _typecode = "b"
    _numpy_t = numpy.int8
    torch_dtype = torch.int8
    _kind, _bits = "i", 8


class UINT8(Type):
    """GraphBLAS 8 bit unsigned integer."""

    _c_type = "uint8_t"
    _typecode = "B"
    _numpy_t = numpy.uint8
    torch_dtype = torch.uint8
    _kind, _bits = "u", 8


class INT16(Type):
    """GraphBLAS 16 bit signed integer."""

    _c_type = "int16_t"
    _typecode = "i"
    _numpy_t = numpy.int16
    torch_dtype = torch.int16
    _kind, _bits = "i", 16


class UINT16(Type):
    """GraphBLAS 16 bit unsigned integer (held as an int16 bit view)."""

    _c_type = "uint16_t"
    _typecode = "I"
    _numpy_t = numpy.uint16
    torch_dtype = torch.int16
    _kind, _bits, _view = "u", 16, True


class INT32(Type):
    """GraphBLAS 32 bit signed integer."""

    _c_type = "int32_t"
    _typecode = "l"
    _numpy_t = numpy.int32
    torch_dtype = torch.int32
    _kind, _bits = "i", 32


class UINT32(Type):
    """GraphBLAS 32 bit unsigned integer (held as an int32 bit view)."""

    _c_type = "uint32_t"
    _typecode = "L"
    _numpy_t = numpy.uint32
    torch_dtype = torch.int32
    _kind, _bits, _view = "u", 32, True


class INT64(Type):
    """GraphBLAS 64 bit signed integer."""

    _c_type = "int64_t"
    _typecode = "q"
    _numpy_t = numpy.int64
    torch_dtype = torch.int64
    _kind, _bits = "i", 64


class UINT64(Type):
    """GraphBLAS 64 bit unsigned integer (held as an int64 bit view)."""

    _c_type = "uint64_t"
    _typecode = "Q"
    _numpy_t = numpy.uint64
    torch_dtype = torch.int64
    _kind, _bits, _view = "u", 64, True


class FP32(Type):
    """GraphBLAS 32 bit float."""

    default_one = 1.0
    default_zero = 0.0
    _c_type = "float"
    _typecode = "f"
    _numpy_t = numpy.float32
    torch_dtype = torch.float32
    _kind, _bits = "f", 32

    @classmethod
    def format_value(cls, val, width=2, prec=2):
        return f"{val:>{width}.{prec}}"


class FP64(Type):
    """GraphBLAS 64 bit float."""

    default_one = 1.0
    default_zero = 0.0
    _c_type = "double"
    _typecode = "d"
    _numpy_t = numpy.float64
    torch_dtype = torch.float64
    _kind, _bits = "f", 64

    @classmethod
    def format_value(cls, val, width=2, prec=2):
        return f"{val:>{width}.{prec}}"


class FC32(Type):
    """GraphBLAS 32 bit float complex."""

    default_one = complex(1.0)
    default_zero = complex(0.0)
    _c_type = "float _Complex"
    _numpy_t = numpy.complex64
    torch_dtype = torch.complex64
    _kind, _bits = "c", 64


class FC64(Type):
    """GraphBLAS 64 bit float complex."""

    default_one = complex(1.0)
    default_zero = complex(0.0)
    _c_type = "double _Complex"
    _numpy_t = numpy.complex128
    torch_dtype = torch.complex128
    _kind, _bits = "c", 128


# torch dtype -> the type its values are read as when no type is named
# (the bit-view types always travel with their type)
_BY_TORCH = {t.torch_dtype: t for t in (BOOL, INT8, INT16, INT32, INT64,
                                        UINT8, FP32, FP64, FC32, FC64)}


def from_torch_dtype(dtype):
    """The type a tensor of torch dtype `dtype` is read as when no type
    is named: the signed or natural one (int32 -> INT32, not UINT32)."""
    return _BY_TORCH[dtype]


def _type_from_value(value):
    """Infer a Type from a Python or numpy scalar value."""
    if isinstance(value, (bool, numpy.bool_)):
        return BOOL
    if isinstance(value, numpy.generic):
        return _gb_from_dtype(value.dtype)
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FP64
    if isinstance(value, complex):
        return FC64
    raise TypeError(f"cannot infer GraphBLAS type from {value!r}")


def cast(t, src, dst):
    """Tensor `t` of type `src`'s held dtype -> `dst`'s, converting the
    values as numpy's ``astype`` does (a bit view is read as its
    unsigned value first, and written back as the bits of one)."""
    if src is dst or (src.torch_dtype == dst.torch_dtype
                      and src._view == dst._view and not src._view):
        return t
    if src._view:
        if src._bits < 64:
            t = t.to(torch.int64) & ((1 << src._bits) - 1)
        elif dst._kind in "fc":
            t = t.to(torch.float64) + torch.where(
                t < 0, 2.0 ** 64, 0.0).to(torch.float64)
    if dst._kind == "b":
        return t != 0
    if dst._kind in "iu" and t.dtype.is_floating_point:
        # float -> integer truncates towards zero, through int64 (numpy's
        # astype to a narrow type wraps the same way)
        t = t.to(torch.int64)
    return t.to(dst.torch_dtype)


def _gb_from_type(typ):
    if typ is int:
        return INT64
    if typ is float:
        return FP64
    if typ is bool:
        return BOOL
    if typ is complex:
        return FC64
    if isinstance(typ, type) and issubclass(typ, numpy.generic):
        return _gb_from_dtype(typ)
    raise TypeError(f"cannot turn {typ!r} into GraphBLAS type.")


# --------------------------------------------------------------------------
# User Defined Types: struct-of-tensors.  A UDT subclass declares `members`
# as a list of "ctype name" strings and each member is held in its own
# tensor of the mapped dtype.
# --------------------------------------------------------------------------

_C_TO_NUMPY = {
    "bool": numpy.bool_,
    "_Bool": numpy.bool_,
    "int8_t": numpy.int8,
    "uint8_t": numpy.uint8,
    "int16_t": numpy.int16,
    "uint16_t": numpy.uint16,
    "int32_t": numpy.int32,
    "uint32_t": numpy.uint32,
    "int64_t": numpy.int64,
    "uint64_t": numpy.uint64,
    "float": numpy.float32,
    "double": numpy.float64,
}


class MetaUDT(MetaType):
    """Metaclass for struct user-defined types.

    ``members = ["double w", "int64_t pi"]`` builds a numpy structured
    dtype; values are struct-of-tensors (``to_dict``: each member its
    own tensor, of the member type's held dtype) and structured numpy
    arrays on the host (``from_dict``)."""

    def __new__(meta, type_name, bases, attrs):
        if "members" in attrs and attrs["members"]:
            members = [m.split() for m in attrs["members"]]
            attrs["member_def"] = members
            attrs["_member_dtypes"] = {
                name: _C_TO_NUMPY[ctype] for ctype, name in members}
            attrs["_base_name"] = "UDT"
            attrs["_numpy_t"] = numpy.dtype(
                [(name, _C_TO_NUMPY[ctype]) for ctype, name in members])
            attrs["_allows_bitmap"] = False

            def _coerce(cls, value):
                if isinstance(value, numpy.void):
                    return value
                return numpy.asarray([tuple(value)], cls._numpy_t)[0]

            def _from_value(cls, value):
                return value

            def _to_value(cls, data):
                return tuple(
                    data[name].item() if hasattr(data[name], "item")
                    else data[name] for _, name in cls.member_def)

            def format_value(cls, val, width=2, prec=None):
                if val == "" or val is None:
                    return f"{'':>{width}}"
                return f"{str(tuple(val)):>{width}}"

            def to_dict(cls, arr, device="cpu"):
                """structured numpy array -> dict of member tensors."""
                arr = numpy.asarray(arr)
                return {name: _gb_from_dtype(cls._member_dtypes[name])
                        .to_torch(arr[name], device)
                        for _, name in cls.member_def}

            def from_dict(cls, d, n=None):
                """dict of member tensors or arrays -> structured numpy
                array."""
                first = next(iter(d.values()))
                n = len(first) if n is None else n
                out = numpy.empty(n, cls._numpy_t)
                for _, name in cls.member_def:
                    v = d[name]
                    if isinstance(v, torch.Tensor):
                        v = _gb_from_dtype(cls._member_dtypes[name]) \
                            .to_numpy(v)
                    out[name] = numpy.asarray(v)
                return out

            attrs.setdefault("_coerce", classmethod(_coerce))
            attrs.setdefault("_from_value", classmethod(_from_value))
            attrs.setdefault("_to_value", classmethod(_to_value))
            attrs.setdefault("format_value", classmethod(format_value))
            attrs.setdefault("to_dict", classmethod(to_dict))
            attrs.setdefault("from_dict", classmethod(from_dict))
        return super().__new__(meta, type_name, bases, attrs)


def binop(boolean=False):
    """Decorator for defining a UDT binary op as a class member: the
    decorated Python function runs on the members' tensors."""
    from .binaryop import BinaryOp

    class inner:
        def __init__(self, func):
            self.func = func

        def __set_name__(self, cls, name):
            op = BinaryOp(self.func.__name__, cls.__name__, fn=self.func,
                          boolean=boolean, udt=cls)
            setattr(cls, self.func.__name__, op)

    return inner


_int_types = (INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64)

_float_types = (FP32, FP64)

_promotion_order = (FC64, FC32, FP64, FP32, INT64, UINT64, INT32, UINT32,
                    INT16, UINT16, INT8, UINT8)


def promote(left, right):
    """Type promotion: result type of an operation inferred from operands.

    The JAX package's lattice (types.py:464): BOOL promotes to the other
    type; otherwise the earlier entry in the order wins."""
    if left == right:
        return left
    elif left == BOOL:
        return right
    elif right == BOOL:
        return left
    for t in _promotion_order:
        if left == t or right == t:
            return t
    raise TypeError("inconvertable types %s and %s"
                    % (repr(left), repr(right)))  # pragma: no cover
