"""Device element-wise union/intersect/select for the sorted-COO tier.

Counterpart of ``pygraphblas_tpu/core/dewise.py``, the JAX package's
XLA engine for large element-wise operations on matrices too big for the
bitmap tier (its host twin is ``core/coosem.py`` + ``core/coosparse.py``).
The JAX package makes every irregular step a sort, because gathers and
scatters are slow on a TPU.  The port keeps the design's shape in torch
on the container's device: one stable sort of the tagged concatenation
(both inputs are canonical), adjacent-equal matching, the op applied to
each matched pair, then an order-keeping compaction of the kept entries
(boolean indexing, which is a scan on the card).  Coordinates must fit
int32 (``eligible``); the 2^60-dimension hypersparse tier keeps the host
path.
"""

import numpy as np
import torch

from .. import types


def _key(r, c):
    """One int64 sort key a (row, col) pair (both < 2^31)."""
    return (r.to(torch.int64) << 31) | c.to(torch.int64)


def _to(t, ctyp, otyp):
    """An op's result (held dtype of ctyp, or of its result type) ->
    otyp's held dtype."""
    src = ctyp if t.dtype == ctyp.torch_dtype else \
        types.from_torch_dtype(t.dtype)
    return types.cast(t, src, otyp)


def ewise(ra, ca, va, rb, cb, vb, fn, compute_dtype, out_dtype, union=True,
          device="cpu"):
    """Union (eadd) / intersection (emult) of two canonical COOs on
    `device`.  fn: binary op over tensors of compute_dtype's type (held
    dtype).  Returns canonical (rows, cols, vals) numpy triples in
    out_dtype.  (The JAX package's ``fn_id`` argument keys its compiled
    executables; torch compiles nothing, so the port takes none.)"""
    ctyp = types._gb_from_dtype(np.dtype(compute_dtype))
    otyp = types._gb_from_dtype(np.dtype(out_dtype))
    r, c, v = merge(*concat(ra, ca, va, rb, cb, vb, ctyp, device), fn,
                    ctyp, otyp, union)
    return r.cpu().numpy(), c.cpu().numpy(), otyp.to_numpy(v)


def concat(ra, ca, va, rb, cb, vb, ctyp, device):
    """The two COOs' (rows, cols, values) concatenated, A then B, as
    tensors on `device` (values in Type ctyp's held dtype): ``merge``'s
    operands."""
    r = torch.as_tensor(np.concatenate([np.asarray(ra, np.int64),
                                        np.asarray(rb, np.int64)]),
                        device=device)
    c = torch.as_tensor(np.concatenate([np.asarray(ca, np.int64),
                                        np.asarray(cb, np.int64)]),
                        device=device)
    v = ctyp.to_torch(np.concatenate([np.asarray(va).astype(ctyp._numpy_t),
                                      np.asarray(vb).astype(ctyp._numpy_t)]),
                      device)
    return r, c, v


def merge(r, c, v, fn, ctyp, otyp, union=True):
    """The merge on the operands' device: ``concat``'s tensors in, the
    canonical (rows, cols, values in otyp's held dtype) tensors out."""
    device = r.device
    # stable sort: an equal (r, c) keeps the concatenation's order, A
    # then B
    _, order = torch.sort(_key(r, c), stable=True)
    r, c, v = r[order], c[order], v[order]
    same = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
    false = torch.zeros(1, dtype=torch.bool, device=device)
    nxt_same = torch.cat([same, false])
    prv_same = torch.cat([false, same])
    combined = _to(fn(v, torch.cat([v[1:], v[:1]])), ctyp, otyp)
    if union:
        keep = ~prv_same
        out_v = torch.where(nxt_same, combined, types.cast(v, ctyp, otyp))
    else:
        keep = nxt_same
        out_v = combined
    return r[keep], c[keep], out_v[keep]


def select(rows, cols, vals, fn, thunk=0, device="cpu"):
    """Predicate compaction of a canonical COO on `device`.  fn(r, c, v,
    thunk) -> bool tensor.  Returns canonical numpy triples."""
    vals = np.asarray(vals)
    vtyp = types._gb_from_dtype(vals.dtype)
    r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
    v = vtyp.to_torch(vals, device)
    # the thunk keeps its own dtype: positional ops (TRIL/TRIU/...)
    # compare an int64 offset against coordinates, not values
    th = torch.as_tensor(np.asarray(thunk), device=device)
    keep = fn(r, c, v, th)
    return (r[keep].cpu().numpy(), c[keep].cpu().numpy(),
            vtyp.to_numpy(v[keep]))


def eligible(na, nb, max_row, max_col, vdtype, out_dtype):
    """Device-tier eligibility: combined size over the threshold (or
    forced), int32-expressible coordinates, plain numeric dtypes."""
    from ..base import config

    if config.ewise_engine == "host":
        return False
    if max(max_row, max_col) >= (1 << 31) - 1:
        return False
    for dt in (np.dtype(vdtype), np.dtype(out_dtype)):
        if dt.kind not in "biuf" or dt.itemsize > 8:
            return False
    if config.ewise_engine == "device":
        return True
    return na + nb >= config.ewise_device_min
