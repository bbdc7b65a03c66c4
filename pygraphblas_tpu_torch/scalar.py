"""GraphBLAS Scalar: a 0-or-1-entry container (the JAX package's
``scalar.py``), used mostly as the thunk argument of a select."""

from .types import _gb_from_type

__all__ = ["Scalar"]


class Scalar:
    """GraphBLAS Scalar.

    >>> s = Scalar.from_value(42)
    >>> s[0]
    42
    >>> s.nvals
    1
    >>> s.clear()
    >>> s.nvals
    0
    >>> bool(s)
    False
    """

    __slots__ = ("_value", "_present", "type")

    def __init__(self, value, typ, present=True):
        self.type = typ
        self._value = value
        self._present = present

    def __len__(self):
        return self.nvals

    def __repr__(self):
        return f"<Scalar value: {self._value if self._present else None}>"

    def dup(self):
        """Create a duplicate Scalar."""
        return Scalar(self._value, self.type, self._present)

    @classmethod
    def from_type(cls, typ):
        """Create an empty Scalar of the given type."""
        return cls(None, typ, present=False)

    @classmethod
    def from_value(cls, value):
        """Create a Scalar holding the value; type is inferred."""
        typ = _gb_from_type(type(value))
        return cls(typ._coerce(value), typ)

    @property
    def gb_type(self):
        """The GraphBLAS type object of the Scalar."""
        return self.type

    def clear(self):
        """Clear the scalar."""
        self._value = None
        self._present = False

    def __getitem__(self, index):
        if not self._present:
            raise KeyError
        return self.type._to_value(self._value)

    def __setitem__(self, index, value):
        self._value = self.type._coerce(value)
        self._present = True

    def wait(self):
        pass

    @property
    def nvals(self):
        """Number of values in the scalar (0 or 1)."""
        return 1 if self._present else 0

    def __bool__(self):
        return bool(self.nvals)
