"""The dense ("bitmap"/"full") tier: a container's (vals, mask) tensors,
the element-wise operations over them and the semiring matmul.

Counterpart of ``pygraphblas_tpu/core/dense.py``.  The element-wise half
(``effective_mask``, ``writeback``, ``eadd``, ``emult``,
``apply_unary``, ``apply_binary_bound``, ``select``, ``reduce_all``,
``reduce_axis``, ``gather2d``, ``scatter2d``) is plain torch on the
tensors' device, as the JAX package's is XLA outside any Pallas kernel.
Every function takes and returns values in the held dtype of a type it
is told (``types.py``: UINT16/32/64 as signed bit views) and applies
each op at that type (``binaryop.at_type``).

The algebras a matmul computes
exactly (PLUS_PAIR, PLUS_TIMES, and LOR or ANY with LAND, PAIR, FIRST,
SECOND or TIMES into BOOL) are ``torch.matmul`` here, as the JAX package
computes them with XLA matmuls outside any Pallas kernel, in full
float32 on the card (TF32 off).  Every other semiring takes the generic
k-blocked broadcast-reduce in plain torch, which folds only present
products, in k order ("the first present product initialises"), so no
identity value is ever injected.
"""

import contextlib

import numpy as np
import torch

from .. import types
from ..binaryop import at_type
from ..unaryop import at_type as unary_at_type
from ..semiring import ops_at

# cells of one (m, kb, n) block of the generic path (dense.py:23)
_GEN_MXM_BUDGET = 1 << 22


def _matmul_ok(dtype, device):
    """Whether the device's matmul takes this dtype exactly: anything on
    the CPU; float32 and float16 on the card (the JAX package's TPU rule,
    dense.py:271-280, whose bfloat16 the port's types do not have)."""
    if device.type == "cpu":
        return True
    return np.dtype(dtype) in (np.float32, np.float16)


@contextlib.contextmanager
def _full_fp32():
    """Float32 matmuls in full float32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def apply_present(f, mask, *xs):
    """f.apply(*xs) (f an op or a monoid; xs of one shape), a user op's
    only where `mask` (a bool tensor of that shape, or a slice) selects,
    zeros elsewhere: applied to the zeros of absent cells or pads it may
    divide by zero, which raises on the CPU, where the JAX package's XLA
    does not.  Built-in ops are total: applied everywhere."""
    op = getattr(f, "binaryop", f)
    if op.builtin or op.positional is not None \
            or getattr(op, "udt", None) is not None:
        return f.apply(*xs)
    z = f.apply(*(x[mask] for x in xs))
    out = torch.zeros(xs[0].shape, dtype=z.dtype, device=z.device)
    out[mask] = z
    return out


def _truthy(vals):
    return vals if vals.dtype == torch.bool else vals != 0


def effective_mask(mask_vals, mask_mask, complement, structural):
    """The boolean write mask of a mask container's (vals, mask)."""
    if mask_mask is None:
        w = None
    elif structural:
        w = mask_mask
    else:
        w = mask_mask & _truthy(mask_vals)
    if complement:
        w = ~w
    return w


def writeback(c_vals, c_mask, t_vals, t_mask, mask_vals, mask_mask,
              accum=None, complement=False, structural=False, replace=False,
              typ=None):
    """The GraphBLAS masked-accumulate-write C<M> (accum)= T, with C of
    type `typ` and T already in its held dtype.

    Z = accum(C, T) (union pattern) or T; entries of C in the mask
    region become Z's; outside it they are kept, or deleted when
    `replace`."""
    t_vals = t_vals.to(c_vals.dtype)
    if mask_mask is None and complement:
        w = torch.zeros_like(c_mask)     # complement of no mask: nothing
    elif mask_mask is None:
        w = None
    else:
        w = effective_mask(mask_vals, mask_mask, complement, structural)

    if accum is None:
        z_vals, z_mask = t_vals, t_mask
    else:
        both = c_mask & t_mask
        acc = apply_present(at_type(accum, typ), both, c_vals, t_vals)
        z_vals = torch.where(both, acc.to(c_vals.dtype),
                             torch.where(t_mask, t_vals, c_vals))
        z_mask = c_mask | t_mask

    if w is None:
        return torch.where(z_mask, z_vals, c_vals), z_mask
    out_vals = torch.where(w & z_mask, z_vals, c_vals)
    if replace:
        out_mask = w & z_mask
    else:
        out_mask = torch.where(w, z_mask, c_mask)
    return out_vals, out_mask


def _pos_grids(shape, device):
    if len(shape) == 1:
        i = torch.arange(shape[0], device=device)
        return dict(i=i, j=i)
    i = torch.arange(shape[0], device=device)[:, None].expand(shape)
    j = torch.arange(shape[1], device=device)[None, :].expand(shape)
    return dict(i=i, j=j)


def _binary_pos(shape, device):
    g = _pos_grids(shape, device)
    return dict(i0=g["i"], j0=g["j"], i1=g["i"], j1=g["j"])


def _zero(typ, device):
    return torch.zeros((), dtype=typ.torch_dtype, device=device)


def eadd(a_vals, a_mask, b_vals, b_mask, op, a_typ, b_typ, out_typ):
    """T = A (+) B: union pattern; op applied (at out_typ) where both
    are present."""
    a_c = types.cast(a_vals, a_typ, out_typ)
    b_c = types.cast(b_vals, b_typ, out_typ)
    both = a_mask & b_mask
    f = at_type(op, out_typ)
    pos = _binary_pos(a_vals.shape, a_vals.device) \
        if op.positional is not None else None
    z = f.apply(a_c, b_c, pos) if pos is not None else \
        apply_present(f, both, a_c, b_c)
    z = types.cast(z, f.ztype(out_typ), out_typ)
    t_vals = torch.where(both, z, torch.where(a_mask, a_c, b_c))
    return t_vals, a_mask | b_mask


def emult(a_vals, a_mask, b_vals, b_mask, op, a_typ, b_typ, out_typ):
    """T = A (*) B: intersection pattern; the op applies at out_typ, or
    (a BOOL-valued op) at the operands' promoted type."""
    if op.ztype_rule == "BOOL":
        in_typ = types.promote(a_typ, b_typ)
    else:
        in_typ = out_typ
    a_c = types.cast(a_vals, a_typ, in_typ)
    b_c = types.cast(b_vals, b_typ, in_typ)
    f = at_type(op, in_typ)
    pos = _binary_pos(a_vals.shape, a_vals.device) \
        if op.positional is not None else None
    t_mask = a_mask & b_mask
    z = f.apply(a_c, b_c, pos) if pos is not None else \
        apply_present(f, t_mask, a_c, b_c)
    z = types.cast(z, f.ztype(in_typ), out_typ)
    return torch.where(t_mask, z, _zero(out_typ, z.device)), t_mask


def apply_unary(vals, mask, op, in_typ, out_typ):
    """T = op(A) on the present entries."""
    pos = _pos_grids(vals.shape, vals.device) \
        if op.positional is not None else None
    f = unary_at_type(op, in_typ)
    z = f.apply(vals, pos) if pos is not None else \
        apply_present(f, mask, vals)
    z = types.cast(z, f.ztype(in_typ), out_typ)
    return torch.where(mask, z, _zero(out_typ, z.device)), mask


def apply_binary_bound(vals, mask, scalar, op, in_typ, out_typ, bind_first):
    """apply_first / apply_second: one operand bound to a scalar (a
    value of in_typ)."""
    f = at_type(op, in_typ)
    if op.positional is not None:
        z = f.apply(vals, vals, _binary_pos(vals.shape, vals.device))
    else:
        s = torch.full_like(vals, in_typ.scalar(scalar))
        z = apply_present(f, mask, s, vals) if bind_first else \
            apply_present(f, mask, vals, s)
    z = types.cast(z, f.ztype(in_typ), out_typ)
    return torch.where(mask, z, _zero(out_typ, z.device)), mask


def select(vals, mask, thunk, op):
    """Keep the entries where the predicate holds."""
    g = _pos_grids(vals.shape, vals.device)
    if isinstance(thunk, torch.Tensor):
        th = thunk
    else:
        th = torch.as_tensor(np.asarray(thunk), device=vals.device)
    keep = op.apply(g["i"], g["j"], vals, th)
    t_mask = mask & keep
    return torch.where(t_mask, vals, torch.zeros_like(vals)), t_mask


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _flip(typ):
    """The sign-bit flip that turns a bit view's order into a signed one."""
    return -(1 << (typ._bits - 1)) if typ._view else 0


def _masked_tree_reduce(vals, mask, add_fn, dim=0):
    """log2-depth fold of present entries along `dim`; absent entries
    never touch the combiner."""
    n = vals.shape[dim]
    size = 1
    while size < n:
        size *= 2
    v = vals.movedim(dim, 0)
    m = mask.movedim(dim, 0)
    if size > n:
        pad = (size - n,) + tuple(v.shape[1:])
        v = torch.cat([v, torch.zeros(pad, dtype=v.dtype,
                                      device=v.device)])
        m = torch.cat([m, torch.zeros(pad, dtype=torch.bool,
                                      device=m.device)])
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        lo, hi = v[:half], v[half:2 * half]
        lo_m, hi_m = m[:half], m[half:2 * half]
        both = lo_m & hi_m
        v = torch.where(both, add_fn(lo, hi).to(v.dtype),
                        torch.where(hi_m, hi, lo))
        m = lo_m | hi_m
    return v[0], m[0]


def _tree(x, f, ident):
    """Fold a 1-d tensor with the associative `f` in log2 passes (pads
    with `ident`)."""
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, ident.reshape(1)])
        x = f(x[0::2], x[1::2])
    return x[0] if x.numel() else ident


def reduce_all(vals, mask, monoid, typ):
    """Reduce every present entry (values of `typ`) to a 0-d tensor with
    the monoid (absent all: its identity)."""
    ident = torch.tensor(typ.scalar(monoid.identity(typ._numpy_t)),
                         dtype=typ.torch_dtype, device=vals.device)
    filled = torch.where(mask, vals, ident)
    name = monoid.binaryop.op if monoid.binaryop.builtin else None
    fl = _flip(typ)
    if name == "PLUS":
        if typ._kind == "b":
            return (mask & vals).any()
        return torch.sum(torch.where(mask, vals, torch.zeros_like(vals)),
                         dtype=vals.dtype)
    if name == "TIMES":
        if typ._kind == "b":
            return torch.where(mask, vals, True).all()
        return torch.prod(filled.reshape(-1), dtype=vals.dtype)
    if name in ("MIN", "MAX") and typ._kind == "b":
        return (filled.all() if name == "MIN" else filled.any())
    if name in ("MIN", "MAX"):
        f = torch.amin if name == "MIN" else torch.amax
        return f(filled ^ fl) ^ fl if fl else f(filled)
    if name == "LOR":
        return (mask & _truthy(vals)).any()
    if name == "LAND":
        return torch.where(mask, _truthy(vals), True).all()
    if name == "LXOR":
        return (mask & _truthy(vals)).sum() % 2 == 1
    if name == "LXNOR":
        return ~((mask & ~_truthy(vals)).sum() % 2 == 1)
    if name in ("BOR", "BAND", "BXOR"):
        f = {"BOR": torch.bitwise_or, "BAND": torch.bitwise_and,
             "BXOR": torch.bitwise_xor}[name]
        return _tree(filled.reshape(-1), f, ident)
    if name == "BXNOR":
        r = _tree(filled.reshape(-1), torch.bitwise_xor,
                  torch.zeros_like(ident))
        return r if filled.numel() % 2 == 1 else ~r
    if name == "ANY":
        flat = mask.reshape(-1)
        if not bool(flat.any()):
            return ident
        return vals.reshape(-1)[int(torch.argmax(flat.to(torch.int8)))]
    add = at_type(monoid.binaryop, typ)
    v, m = _masked_tree_reduce(vals.reshape(-1), mask.reshape(-1),
                               add.apply)
    return torch.where(m, v, ident)


def reduce_axis(vals, mask, monoid, dim, typ):
    """Row (dim=1) or column (dim=0) reduction to a (vals, mask) vector."""
    ident = torch.tensor(typ.scalar(monoid.identity(typ._numpy_t)),
                         dtype=typ.torch_dtype, device=vals.device)
    filled = torch.where(mask, vals, ident)
    name = monoid.binaryop.op if monoid.binaryop.builtin else None
    fl = _flip(typ)
    if typ._kind == "b" and name in ("PLUS", "MAX", "TIMES", "MIN"):
        name = {"PLUS": "LOR", "MAX": "LOR", "TIMES": "LAND",
                "MIN": "LAND"}[name]
    if name == "PLUS":
        out = torch.sum(torch.where(mask, vals, torch.zeros_like(vals)),
                        dim=dim, dtype=vals.dtype)
    elif name == "TIMES":
        out = torch.prod(filled, dim=dim, dtype=vals.dtype)
    elif name in ("MIN", "MAX"):
        f = torch.amin if name == "MIN" else torch.amax
        out = f(filled ^ fl, dim=dim) ^ fl if fl else f(filled, dim=dim)
    elif name == "LOR":
        out = (mask & _truthy(vals)).any(dim=dim)
    elif name == "LAND":
        out = torch.where(mask, _truthy(vals), True).all(dim=dim)
    elif name == "LXOR":
        out = ((mask & _truthy(vals)).sum(dim=dim) % 2) == 1
    else:
        add = at_type(monoid.binaryop, typ)
        out, _ = _masked_tree_reduce(vals, mask, add.apply, dim=dim)
    return out.to(typ.torch_dtype), mask.any(dim=dim)


def kronecker(a_vals, a_mask, b_vals, b_mask, op, a_typ, b_typ, out_typ):
    """T = kron(A, B): op(A[i, j], B[k, l]) at (i*p + k, j*q + l), one
    broadcast of the op at out_typ over (m, p, n, q)."""
    m, n = a_vals.shape
    p, q = b_vals.shape
    a_c = types.cast(a_vals, a_typ, out_typ)
    b_c = types.cast(b_vals, b_typ, out_typ)
    f = at_type(op, out_typ)
    t_mask = a_mask[:, None, :, None] & b_mask[None, :, None, :]
    z = apply_present(f, t_mask, a_c[:, None, :, None].expand(m, p, n, q),
                      b_c[None, :, None, :].expand(m, p, n, q))
    t_vals = types.cast(z, f.ztype(out_typ), out_typ).reshape(m * p, n * q)
    t_mask = t_mask.reshape(m * p, n * q)
    return torch.where(t_mask, t_vals, _zero(out_typ, t_vals.device)), t_mask


def gather2d(vals, mask, row_idx, col_idx):
    """Extract a submatrix by row/col index vectors."""
    return vals[row_idx][:, col_idx], mask[row_idx][:, col_idx]


def scatter2d(c_vals, c_mask, row_idx, col_idx, t_vals, t_mask):
    """Assign a submatrix into C at row/col index vectors (pattern
    write)."""
    rr = row_idx[:, None]
    cc = col_idx[None, :]
    v = c_vals.clone()
    m = c_mask.clone()
    v[rr, cc] = t_vals.to(c_vals.dtype)
    m[rr, cc] = t_mask
    return v, m


def _f32_pattern_matmul(a_mask, b_mask):
    """Structural pattern of the product: a float32 matmul of the
    bitmaps."""
    return torch.matmul(a_mask.to(torch.float32),
                        b_mask.to(torch.float32)) > 0


def mxm(a_vals, a_mask, b_vals, b_mask, semiring, out_dtype):
    """Dense semiring matmul T = A (+).(*) B with its structural pattern;
    returns (values of out_dtype's type (held dtype), bool pattern).
    PLUS_PAIR counts accumulate in float32 on the card (exact while
    k <= 2^24, as on a TPU) and in float64 on the CPU."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    tdt = typ.torch_dtype
    dev = a_vals.device
    m, k = a_vals.shape
    n = b_vals.shape[1]
    is_bool = out_dtype == np.bool_
    builtin = (semiring.add_monoid.binaryop.builtin
               and semiring.mul_op.builtin)
    add = semiring.add_monoid.binaryop.op if builtin else None
    mul = semiring.mul_op.op if builtin else None
    with _full_fp32():
        t_mask = _f32_pattern_matmul(a_mask, b_mask)
        if add == "PLUS" and mul == "PAIR" and not is_bool \
                and (dev.type != "cuda" or k <= (1 << 24)):
            acc = torch.float32 if dev.type == "cuda" else torch.float64
            prod = torch.matmul(a_mask.to(acc), b_mask.to(acc))
            return prod.to(tdt), t_mask
        if add == "PLUS" and mul == "TIMES" and not is_bool \
                and _matmul_ok(out_dtype, dev):
            av = torch.where(a_mask, a_vals, 0).to(tdt)
            bv = torch.where(b_mask, b_vals, 0).to(tdt)
            return torch.matmul(av, bv), t_mask
        if add in ("LOR", "ANY") and is_bool and mul in (
                "LAND", "PAIR", "FIRST", "SECOND", "TIMES"):
            # (dense.py:327-340) a product is true where both entries are
            # present and the operands the multiply reads are true
            av = a_mask & _truthy(a_vals) \
                if mul in ("LAND", "TIMES", "FIRST") else a_mask
            bv = b_mask & _truthy(b_vals) \
                if mul in ("LAND", "TIMES", "SECOND") else b_mask
            prod = torch.matmul(av.to(torch.float32), bv.to(torch.float32))
            return prod > 0, t_mask

    # generic semiring (dense.py:342-394): k-blocked masked fold
    addf, mulf = ops_at(semiring, typ)
    kb = max(1, min(k, _GEN_MXM_BUDGET // max(1, m * n)))
    a_v = a_vals.to(tdt)
    b_v = b_vals.to(tdt)

    def combine(acc, acc_m, val, val_m):
        both = acc_m & val_m
        merged = torch.where(both,
                             apply_present(addf, both, acc, val).to(tdt),
                             torch.where(val_m, val, acc))
        return merged, acc_m | val_m

    acc = torch.zeros((m, n), dtype=tdt, device=dev)
    acc_m = torch.zeros((m, n), dtype=torch.bool, device=dev)
    for k0 in range(0, k, kb):
        k1 = min(k, k0 + kb)
        x = a_v[:, k0:k1, None].expand(m, k1 - k0, n)
        y = b_v[None, k0:k1, :].expand(m, k1 - k0, n)
        pm = a_mask[:, k0:k1, None] & b_mask[None, k0:k1, :]
        if mulf.positional is not None:
            ii = torch.arange(m, device=dev)[:, None, None]
            kk = torch.arange(k0, k1, device=dev)[None, :, None]
            jj = torch.arange(n, device=dev)[None, None, :]
            pos = dict(i0=ii, j0=kk, i1=kk, j1=jj)
            z = torch.broadcast_to(mulf.apply(None, None, pos).to(tdt),
                                   (m, k1 - k0, n))
        else:
            z = apply_present(mulf, pm, x, y).to(tdt)
        part, part_m = z[:, 0, :], pm[:, 0, :]
        for q in range(1, k1 - k0):
            part, part_m = combine(part, part_m, z[:, q, :], pm[:, q, :])
        acc, acc_m = combine(acc, acc_m, part, part_m)
    acc = torch.where(acc_m, acc, torch.zeros_like(acc))
    return acc, acc_m
