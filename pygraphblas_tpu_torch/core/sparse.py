"""The sparse tier's device reductions over COO index arrays, and its
host generic fold.

Counterpart of ``pygraphblas_tpu/core/sparse.py``: semiring SpMV over
COO triples (``coo_spmv``) and monoid segment reductions
(``coo_segment_reduce``, ``coo_segment_reduce_compact``) in plain torch
on the tensors' device: ``index_add_`` and ``scatter_reduce_`` for the
monoids that have one (PLUS, MIN, MAX, TIMES, ANY as MAX, LOR, LAND,
LXOR), the identity-free host fold ``segment_fold_generic`` for the
others.  The JAX package has no Pallas kernel here (XLA's
scatter-reduce), so neither has the port.
"""

import numpy as np
import torch

from .. import types
from ..binaryop import at_type, np_binop
from ..ops import table

# the monoids a torch reduction computes (index_add_, scatter_reduce_)
_REDUCES = ("PLUS", "MIN", "MAX", "TIMES", "ANY", "LOR", "LAND", "LXOR")


def _segment_reduce(name, data, seg, nseg, ident, typ):
    """Reduce `data` (typ's held dtype) by segment id into `nseg` cells
    that start at `ident`."""
    dev = data.device
    if typ._kind == "b" or name in ("LOR", "LAND", "LXOR"):
        d = data if data.dtype == torch.bool else data != 0
        if name == "LXOR":
            out = torch.zeros(nseg, dtype=torch.int64, device=dev)
            out.index_add_(0, seg, d.to(torch.int64))
            return (out % 2) == 1
        lo = name in ("MIN", "TIMES", "LAND")
        out = torch.full((nseg,), bool(ident), dtype=torch.int8, device=dev)
        out.scatter_reduce_(0, seg, d.to(torch.int8),
                            reduce="amin" if lo else "amax")
        return out > 0
    if name == "PLUS":
        out = torch.zeros(nseg, dtype=data.dtype, device=dev)
        return out.index_add_(0, seg, data)
    if name == "TIMES":
        out = torch.full((nseg,), ident, dtype=data.dtype, device=dev)
        return out.scatter_reduce_(0, seg, data, reduce="prod")
    # MIN, MAX, ANY (as MAX, from the type's least value, so that the
    # result is one of the values folded): a bit view reduces its
    # order-preserving signed image (the sign bit flipped)
    if name == "ANY":
        ident = typ.scalar(table.MONOIDS["MAX"][1](typ.numpy_dtype))
    flip = (-(1 << (typ._bits - 1))) if typ._view else 0
    out = torch.full((nseg,), ident, dtype=data.dtype, device=dev) ^ flip \
        if flip else torch.full((nseg,), ident, dtype=data.dtype, device=dev)
    out.scatter_reduce_(0, seg, data ^ flip if flip else data,
                        reduce="amin" if name == "MIN" else "amax")
    return out ^ flip if flip else out


def _generic_fold(ids, data, nseg, monoid, typ):
    """Segment fold with a monoid no torch reduction computes: the
    identity-free host fold; returns (folded values, present mask)."""
    dev = data.device
    ids_h = ids.cpu().numpy()
    order = np.argsort(ids_h, kind="stable")
    vals_h = typ.to_numpy(data)[order]
    uids, red = segment_fold_generic(ids_h[order], vals_h,
                                     np_binop(monoid.binaryop))
    out = torch.zeros(nseg, dtype=typ.torch_dtype, device=dev)
    m = torch.zeros(nseg, dtype=torch.bool, device=dev)
    if len(uids):
        u = torch.as_tensor(uids, device=dev)
        out[u] = typ.to_torch(red, dev)
        m[u] = True
    return out, m


def coo_segment_reduce(ids, vals, monoid, out_dtype, out_size):
    """Monoid-reduce COO values by row (or column) id into a dense
    (vals, mask) vector pair on the tensors' device."""
    typ = types._gb_from_dtype(np.dtype(out_dtype))
    dev = vals.device
    ids = ids.long()
    mon = monoid
    name = mon.binaryop.op if mon.binaryop.builtin else None
    cnt = torch.zeros(out_size, dtype=torch.int32, device=dev)
    cnt.index_add_(0, ids, torch.ones(ids.shape, dtype=torch.int32,
                                      device=dev))
    y_mask = cnt > 0
    data = vals.to(typ.torch_dtype)
    if name not in _REDUCES:
        y, _ = _generic_fold(ids, data, out_size, mon, typ)
    else:
        ident = typ.scalar(mon.identity(np.dtype(out_dtype)))
        y = _segment_reduce(name, data, ids, out_size, ident, typ)
    y = torch.where(y_mask, y.to(typ.torch_dtype),
                    torch.zeros((), dtype=typ.torch_dtype, device=dev))
    return y, y_mask


def segment_fold_generic(ids_sorted, vals, add):
    """Segment reduce with the binary function `add` (numpy arrays in,
    numpy array out): ids sorted.  log(max segment) passes of vectorized
    adjacent-pair combining, so no identity value is needed.

    Returns (unique_ids, folded_vals)."""
    ids = np.asarray(ids_sorted)
    vals = np.asarray(vals)
    while len(ids):
        starts = np.ones(len(ids), bool)
        starts[1:] = ids[1:] != ids[:-1]
        if starts.all():
            break
        run_id = np.cumsum(starts) - 1
        run0 = np.zeros(run_id[-1] + 1, np.int64)
        run0[run_id[np.nonzero(starts)[0]]] = np.nonzero(starts)[0]
        within = np.arange(len(ids)) - run0[run_id]
        # pair each even-offset element with its odd-offset successor
        is_left = (within % 2 == 0)
        has_right = np.zeros(len(ids), bool)
        has_right[:-1] = is_left[:-1] & (~starts[1:])
        left = np.nonzero(has_right)[0]
        lone = np.nonzero(is_left & ~has_right)[0]
        merged = add(vals[left], vals[left + 1])
        keep_ids = np.concatenate([ids[left], ids[lone]])
        keep_vals = np.concatenate([np.asarray(merged, vals.dtype),
                                    vals[lone]])
        order = np.argsort(keep_ids, kind="stable")
        ids, vals = keep_ids[order], keep_vals[order]
    return ids, vals


def coo_segment_reduce_compact(ids_host, vals_host, monoid, out_dtype,
                               device):
    """Sparse-output segment reduce: monoid-reduce values by arbitrary
    (up to 2^60) ids.  The id space is compacted on the host, the
    reduction runs over the distinct segments on `device`, and the
    result comes back as host (unique_ids, values): every segment is
    present.  vals_host may be a tensor on `device` already."""
    out_dtype = np.dtype(out_dtype)
    uids, inv = np.unique(ids_host, return_inverse=True)
    nseg = len(uids)
    if nseg == 0:
        return uids, np.empty(0, out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    if torch.is_tensor(vals_host):
        vt = vals_host
    else:
        vh = np.asarray(vals_host)
        vt = types._gb_from_dtype(vh.dtype).to_torch(vh, device)
    tv, _ = coo_segment_reduce(torch.as_tensor(inv.reshape(-1),
                                               device=device),
                               vt, monoid, out_dtype, nseg)
    return uids, typ.to_numpy(tv)


def coo_spmv(ids_out, ids_in, vals, x_vals, x_mask, semiring, out_dtype,
             out_size, flip_mul=False):
    """Generalized semiring SpMV over COO triples (tensors on one device):

    y[i] = add-reduce over entries e with ids_out[e] == i of
           mul(vals[e], x[ids_in[e]]), restricted to present x entries.

    Returns a dense (vals, mask) pair of size `out_size`."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    tdt = typ.torch_dtype
    dev = x_vals.device
    ids_out = ids_out.long()
    ids_in = ids_in.long()
    mon = semiring.add_monoid
    add = mon.binaryop.op if mon.binaryop.builtin else None
    mul = at_type(semiring.mul_op, typ)
    xg = x_vals[ids_in]
    present = x_mask[ids_in]
    if mul.positional is not None:
        # operand roles: mxv y=A.x -> first=A (i0=row=out, j0=col=in),
        # second=x (i1=in, j1=0); vxm w=x'.A (flip_mul) -> first=x'
        # (i0=0, j0=in), second=A (i1=in row, j1=out col)
        z = torch.zeros_like(ids_in)
        if flip_mul:
            pos = dict(i0=z, j0=ids_in, i1=ids_in, j1=ids_out)
        else:
            pos = dict(i0=ids_out, j0=ids_in, i1=ids_in, j1=z)
        prod = mul.apply(None, None, pos).to(tdt)
    else:
        vt = vals.to(tdt)
        xt = xg.to(tdt)
        prod = mul.apply(xt, vt) if flip_mul else mul.apply(vt, xt)
        prod = prod.to(tdt)
    # absent entries go to a scratch segment so they do not contribute
    seg = torch.where(present, ids_out, out_size)
    if add not in _REDUCES:
        y, _ = _generic_fold(seg, prod, out_size + 1, mon, typ)
    else:
        ident = typ.scalar(mon.identity(out_dtype))
        y = _segment_reduce(add, prod, seg, out_size + 1, ident, typ)
    y = y[:-1]
    cnt = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, seg, present.to(torch.int32))
    y_mask = cnt[:-1] > 0
    y = torch.where(y_mask, y.to(tdt), torch.zeros((), dtype=tdt,
                                                   device=dev))
    return y, y_mask
