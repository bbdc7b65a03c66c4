"""Device-resident unmasked SpGEMM: expand / sort / compact (ESC).

Counterpart of ``pygraphblas_tpu/core/esc.py``: C = A (+.x) B with no
mask, canonical COO in and out.  The host relabels the three index
spaces and plans the expansion in O(nnz) (the same numpy code as the JAX
package, esc.py:230-330); the device then runs, as eager torch ops
around two kernels (esc.py:168-227 is one jitted XLA program):

1. the seeds scattered at each A entry's first expansion slot, and three
   segmented PLUS scans (kernel 12, ``segfold``) that give every slot its
   position in B, its output row and its A value;
2. the group-window encoding of the positions (``qg`` per 1024 slots,
   ``dm``) and the dual-source gather of B's columns and values (kernel
   13, ``esc_gather``);
3. the products (the semiring's mul op at the output type, a torch
   closure as the JAX package's is a traced one), int32 keys
   row * nc + col where they fit, ``torch.sort`` (a library sort standing in for XLA's
   ``lax.sort``, which is not a Pallas kernel) and a fourth ``segfold``
   with the add monoid over the sorted products;
4. the segment ends, found with ``torch.nonzero`` on the device; their
   keys and totals come back in one transfer (the JAX package packs a
   bitmap for the TPU's transfer instead: the same output).

Every structural match gives an output entry, even where the value
folds to zero.  Returns None where the JAX package's would (the caller
then takes the host tiers, core/gustavson.py): the same caps (span,
expansion, B's residency), with "the device is ``cuda``" where the JAX
code asks for a TPU; on the card the values must be of 4 bytes or less
and the add monoid one that ``segfold`` folds (a user monoid through
its generated fold, ``_opgen``; one that does not lower takes the host
tiers).  Values travel as 4-byte words (``_kernels.to_words``):
float32 for FP32, int32 for the other types, BOOL among them.
"""

import time

import numpy as np
import torch

from .. import _kernels, _opgen, types
from .._device import as_tensor, resolve_device
from ..semiring import ops_at
from .dense import apply_present
from .scan import segfold
from .spgemm import _pull, add_seconds

# group-window span cap (source rows per 1024-slot group)
_SPAN_CAP = 120
# B's source arrays must fit the TPU kernel's VMEM; kept on the card as
# the dispatch rule, so that both packages take the same paths
_B_RESIDENT = 5 << 20
# F (padded) budget: the sort's scratch is the memory high-water mark
MAX_F = 1 << 27

# summed over esc_spgemm calls since reset_stats(): calls and host
# seconds by phase ("device" includes waiting for the card)
stats = {}


def reset_stats():
    stats.clear()
    stats.update(calls=0, seconds={})


reset_stats()


def _next_pow2(x):
    p = 1024
    while p < x:
        p *= 2
    return p


def esc_supported(semiring, out_dtype, va_dtype, vb_dtype, device):
    """Static (pre-plan) support check (esc.py:66-82): a non-positional
    mul and an add monoid with an identity in the value dtype; on the
    card no dtype wider than 4 bytes (as on a TPU) and an add monoid
    ``segfold`` folds: a fold code (``_kernels.fold_code``), or a user
    monoid that lowers to a generated fold (``_opgen.lowers``), as the
    JAX kernel folds with any traced monoid."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    add, mul = ops_at(semiring, typ)
    if mul.positional is not None:
        return False
    try:
        add.identity(out_dtype if out_dtype != np.bool_ else np.int32)
    except (KeyError, ValueError, TypeError, AttributeError):
        return False
    if device.type == "cuda":
        for dt in (out_dtype, va_dtype, vb_dtype):
            dt = np.dtype(dt)
            if dt != np.bool_ and dt.itemsize > 4:
                return False
        try:
            _kernels.fold_code(add, typ, "segfold")
        except TypeError:
            return _opgen.lowers(add, typ)
    return True


def _words(typ):
    """The dtype ESC moves values of type `typ` in, and the PLUS monoid
    that broadcasts them through a scan: 4-byte words (float32 for
    FP32, int32 for the other types of 4 bytes or less), else the
    type's own dtype (the CPU takes 8-byte types)."""
    if typ.numpy_dtype.itemsize <= 4 and typ._kind != "c":
        if typ.__name__ == "FP32":
            return torch.float32, types.FP32.PLUS_MONOID
        return torch.int32, types.INT32.PLUS_MONOID
    return typ.torch_dtype, typ.PLUS_MONOID


def _esc_gather_plain(cols2d, vals2d, qg, dm):
    """Plain version of kernel 13 (esc.py:91-97): the flat positions
    128 * qg[group] + dm, clipped to the sources, and two takes."""
    S = dm.shape[0]
    idx = qg.long().repeat_interleave(8)[:, None] * 128 + dm.long()
    flat = idx.reshape(-1).clamp_(0, cols2d.numel() - 1)
    return (cols2d.reshape(-1)[flat].reshape(S, 128),
            vals2d.reshape(-1)[flat].reshape(S, 128))


def esc_gather(cols2d, vals2d, qg, dm):
    """Kernel 13: ``out[s] = src[128 * qg[s // 1024] + dm[s]]`` for B's
    columns (int32) and values (float32 or int32) together; cols2d and
    vals2d (rows_src, 128), qg (S / 8,) int32, dm (S, 128) int32.  The
    row is clamped to [0, rows_src) as the TPU kernel clamps it."""
    if dm.device.type == "cpu":
        return _esc_gather_plain(cols2d, vals2d, qg, dm)
    name = "esc_gather"
    if dm.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dm.device}")
    vals2d, back = _kernels.widen(vals2d.contiguous())
    if vals2d.element_size() != 4:
        raise TypeError(f"{name}: the kernel moves values of 4 bytes or "
                        f"less, not {vals2d.dtype}")
    _kernels.cuda_args(name, cols2d, vals2d, qg, dm)
    S = dm.shape[0]
    if (cols2d.dtype != torch.int32 or qg.dtype != torch.int32
            or dm.dtype != torch.int32 or dm.dim() != 2
            or dm.shape[1] != 128 or S % 8 or qg.numel() != S // 8
            or cols2d.shape != vals2d.shape or cols2d.dim() != 2
            or cols2d.shape[1] != 128 or cols2d.shape[0] == 0):
        raise TypeError(f"{name}: int32 cols2d (R, 128), values of its "
                        "shape, int32 qg (S/8,) and dm (S, 128)")
    if dm.data_ptr() % 16:
        raise ValueError(f"{name}: dm must be 16-byte aligned")
    out_c = torch.empty((S, 128), dtype=torch.int32, device=dm.device)
    out_v = torch.empty((S, 128), dtype=vals2d.dtype, device=dm.device)
    rc = _kernels.lib().pgb_esc_gather(
        cols2d.data_ptr(), vals2d.data_ptr(), cols2d.shape[0],
        qg.data_ptr(), dm.data_ptr(), out_c.data_ptr(), out_v.data_ptr(),
        S * 128, _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return out_c, back(out_v)


def _esc_device(ptr, sb_e, ri_e, va_e, cols2d, vals2d, F, nc, add, mul, typ,
                F_pad, narrow):
    """The device pipeline (esc.py:168-227): scans -> gather -> products
    -> sort -> segment fold -> segment ends.  Values arrive as words
    (``_words``); products and the fold run at type `typ`.  Returns the
    output keys and totals (of typ's held dtype), compacted, on the
    device."""
    dev = cols2d.device
    vdt, scan_plus = _words(typ)
    # the seeds: only the true entries (the JAX package's pads point out
    # of bounds, where XLA's scatter drops them and torch's would raise)
    flags = torch.zeros(F_pad, dtype=torch.bool, device=dev)
    flags[ptr] = True
    stepb = torch.ones(F_pad, dtype=torch.int32, device=dev)
    stepb[ptr] = sb_e
    riv = torch.zeros(F_pad, dtype=torch.int32, device=dev)
    riv[ptr] = ri_e
    avv = torch.zeros(F_pad, dtype=vdt, device=dev)
    avv[ptr] = va_e

    plus = types.INT32.PLUS_MONOID
    bpos = segfold(stepb, flags, plus)
    ri = segfold(riv, flags, plus)
    av = segfold(avv, flags, scan_plus)
    del stepb, riv, avv, flags

    bpos[F:] = 0                        # dead slots read row 0, lane 0
    b2 = bpos.view(-1, 1024)
    qg = (b2.amin(dim=1) >> 7).to(torch.int32)
    dm = (b2 - qg[:, None] * 128).reshape(-1, 128)
    del bpos, b2
    ci, bv = esc_gather(cols2d, vals2d, qg, dm)
    del dm
    if vdt != typ.torch_dtype:
        av = _kernels.from_words(av, typ)
        bv = _kernels.from_words(bv, typ)
    # a user op sees the expansion's F products only, not the pads
    prod = apply_present(mul, slice(0, F), av,
                         bv.reshape(F_pad)).to(typ.torch_dtype)
    del av, bv
    ci = ci.reshape(F_pad)
    if narrow:
        key = ri * nc + ci
        sent = 2 ** 31 - 1
    else:
        key = ri.long() * nc + ci.long()
        sent = 2 ** 62
    del ri, ci
    key[F:] = sent
    key_s, order = torch.sort(key, stable=True)
    del key
    prod_s = prod[order]
    del prod, order

    boundary = torch.empty(F_pad, dtype=torch.bool, device=dev)
    boundary[0] = True
    torch.ne(key_s[1:], key_s[:-1], out=boundary[1:])
    tot = segfold(prod_s, boundary, add)
    last = torch.empty_like(boundary)
    last[:-1] = boundary[1:]
    last[-1] = True
    # the sentinel run's end marks no output
    last &= key_s != sent
    ends = torch.nonzero(last).squeeze(1)
    return key_s[ends], tot[ends]


def esc_spgemm(ra, ca, va, rb, cb, vb, semiring, out_dtype, device=None):
    """C = A (+.x) B unmasked, canonical COO in and out, on `device`
    (default ``cuda``; raises without a card).  Returns (rows, cols,
    vals) or None when unsupported (the caller falls back)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sec = stats["seconds"]
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    add, mul = ops_at(semiring, typ)

    def empty():
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, out_dtype)

    if not esc_supported(semiring, out_dtype, va.dtype, vb.dtype, dev):
        return None
    if len(ra) == 0 or len(rb) == 0:
        return empty()

    from .gustavson import _relabel

    (ur, ri), (uk, ka, kb), (uc, ci) = _relabel(ra, ca, rb, cb)

    # restrict B to inner indices that A actually uses, so scanned
    # positions advance only over useful segments
    used = np.unique(ka)
    keep = np.isin(kb, used)
    kb2 = kb[keep]
    ci2 = ci[keep].astype(np.int64)
    vb2 = vb[keep]
    if len(kb2) == 0:
        return empty()
    ku = np.searchsorted(used, kb2)          # compact used-k ids, sorted
    db = np.bincount(ku, minlength=len(used)).astype(np.int64)
    sb = np.concatenate([[0], np.cumsum(db)])[:-1]

    # A entries in inner-index order; drop entries with empty B rows
    order = np.argsort(ka, kind="stable")
    ke = np.searchsorted(used, ka[order])
    d_e = db[ke]
    nz = d_e > 0
    ri_s = ri[order][nz].astype(np.int64)
    va_s = va[order][nz]
    sb_e = sb[ke[nz]]
    d_e = d_e[nz]
    if len(d_e) == 0:
        return empty()

    F = int(d_e.sum())
    F_pad = _next_pow2(F)
    d_max = int(d_e.max())
    span_max = -(-((1024 + d_max) // 128 + 2) // 16) * 16  # quantized
    rows_b = -(-len(kb2) // 128) + span_max + 2
    if (F_pad > MAX_F or span_max > _SPAN_CAP + 8
            or (dev.type == "cuda" and rows_b * 128 * 4 > _B_RESIDENT)):
        return None

    ptr = np.concatenate([[0], np.cumsum(d_e)])[:-1]
    mc, nc = len(ur), len(uc)
    narrow = mc * nc < 2**31 and F_pad < 2**31
    rows_b = _next_pow2(rows_b)

    vdt, _ = _words(typ)

    def words(arr):
        return _kernels.to_words(typ.to_torch(arr, dev), typ).to(vdt)

    cols2d = np.zeros(rows_b * 128, np.int32)
    cols2d[:len(ci2)] = ci2
    vals2d = torch.zeros(rows_b * 128, dtype=vdt, device=dev)
    vals2d[:len(vb2)] = words(vb2)
    args = (as_tensor(ptr.astype(np.int64), dev),
            as_tensor(sb_e.astype(np.int32), dev),
            as_tensor(ri_s.astype(np.int32), dev), words(va_s),
            as_tensor(cols2d.reshape(rows_b, 128), dev),
            vals2d.reshape(rows_b, 128))
    stats["calls"] += 1
    t0 = add_seconds(sec, "relabel+plan", t0)
    key_d, tot_d = _esc_device(*args, F, nc, add, mul, typ, F_pad, narrow)
    del args
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = add_seconds(sec, "device", t0)
    out_key, out_val = _pull([key_d, tot_d])
    out_key = out_key.astype(np.int64)
    rr = out_key // nc
    cc = out_key - rr * nc
    res = (ur[rr], uc[cc], out_val.view(out_dtype))
    add_seconds(sec, "pull+assemble", t0)
    return res

