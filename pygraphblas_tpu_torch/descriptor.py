"""Descriptors: per-call option records.

Descriptors "describe" options controlling GraphBLAS operations: input
transposition (T0/T1), mask complement (C) and structural-mask (S) modes,
and output replace (R).  All 27 standard combinations are pre-built, and
descriptors merge with ``&`` (reference surface:
``pygraphblas/descriptor.py``; the port's copy of the JAX package's
``descriptor.py``).  A Descriptor is a plain Python record read by the
dispatch layer before any kernel launch.

Descriptor | Description
--- | ---
`T0`      | Transpose First Argument
`T1`      | Transpose Second Argument
`T0T1`    | Transpose Both First and Second Argument
`C`       | Complement Mask
`R`       | Replace Result
`S`       | Structural Mask
(and all of their `&` combinations, e.g. `RSCT0T1`)
"""

import contextvars
from itertools import product

current_desc = contextvars.ContextVar("current_desc")

_FIELDS = ("inp0", "inp1", "complement", "structural", "replace",
           "nthreads", "chunk", "axb_method", "sort")


class Descriptor:
    """Wrapper class around per-call GraphBLAS options.

    Descriptors can be combined with the ``&`` operator and used as
    context managers to scope a default descriptor over a block.
    """

    __slots__ = _FIELDS + ("token", "name")

    def __init__(self, name="", inp0=False, inp1=False, complement=False,
                 structural=False, replace=False, nthreads=None, chunk=None,
                 axb_method=None, sort=False):
        self.name = name
        self.inp0 = inp0
        self.inp1 = inp1
        self.complement = complement
        self.structural = structural
        self.replace = replace
        self.nthreads = nthreads
        self.chunk = chunk
        self.axb_method = axb_method
        self.sort = sort
        self.token = None

    def get_desc(self):
        return self

    def __enter__(self):
        self.token = current_desc.set(self)
        return self

    def __exit__(self, *errors):
        current_desc.reset(self.token)

    def __and__(self, other):
        d = Descriptor(name=self.name + other.name)
        for f in _FIELDS:
            s = getattr(self, f)
            o = getattr(other, f)
            if isinstance(s, bool) or isinstance(o, bool):
                setattr(d, f, bool(s) or bool(o))
            else:
                setattr(d, f, o if o is not None else s)
        return d

    def __eq__(self, other):
        if not isinstance(other, Descriptor):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f) for f in _FIELDS)

    def __hash__(self):
        return hash(tuple(getattr(self, f) for f in _FIELDS))

    def __contains__(self, other):
        """``T0 in desc`` tests whether desc includes the given flags."""
        for f in ("inp0", "inp1", "complement", "structural", "replace"):
            if getattr(other, f) and not getattr(self, f):
                return False
        return True

    def __repr__(self):
        return f"<Descriptor {self.name}>"


Default = Descriptor("Default")


# Build the 27 standard descriptor constants: {R}{S}{C}{T0}{T1} combos.
_names = []
for r, s, c, t in product(("", "R"), ("", "S"), ("", "C"),
                          ("", "T0", "T1", "T0T1")):
    nm = r + s + c + t
    if not nm:
        continue
    _names.append(nm)

for _nm in _names:
    globals()[_nm] = Descriptor(
        _nm,
        inp0="T0" in _nm,
        inp1="T1" in _nm,
        complement="C" in _nm,
        structural="S" in _nm,
        replace="R" in _nm,
    )

__all__ = ["Descriptor"] + _names
