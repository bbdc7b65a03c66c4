"""Masked sparse SpGEMM: C<M> = A (+.x) B, one sparse dot product per
mask entry: c_ij = (+)_k a_ik (x) b_kj over k in rowA(i) ∩ colB(j).

Counterpart of ``pygraphblas_tpu/core/spgemm.py``.  The host side is
the same numpy code: ``_csr_of`` and ``_row_lookup`` (spgemm.py:32-65),
the heavy-edge host intersect above ``WIDTH_CAP`` (809-848), the pow2
width menu and its width-bucket order (857-862, 947-951), the dispatch
between the fused paths and the generic intersect (885-935) and the
result assembly, which drops zero-count edges (1072-1106).

Kernels (``csrc/spgemm.cu``), each beside its plain PyTorch version:
  - ``pair_count`` replaces spgemm.py:179 ``_pallas_fill_merge_count``:
    per mask edge, |A row ∩ B^T row|.  The PAIR path of triangle
    counting and k-truss, one launch per width bucket.
  - ``fill_keys`` replaces spgemm.py:68 ``_pallas_fill_keys``: the
    (E, W) side-tagged key rows of the unfused chain
    (``PYGB_PAIR_FUSED=0``, spgemm.py:627-632), which sorts them with
    ``torch.sort`` and counts equal neighbours.
  - ``pair_fold`` replaces spgemm.py:388 ``_pallas_fill_merge_fold``:
    the same intersect with ``mul(a, b)`` at each match, folded per edge
    with the add monoid (4-byte values), one launch per width bucket.
Their plain versions build the TPU kernels' key rows and sort them:
an algorithm apart from the kernels', which search and probe bitmaps.
The generic intersect (spgemm.py:684-771, XLA in the JAX package) is
torch ops here.

The fused paths run where the JAX package's would on a TPU, with "the
device is ``cuda``" (``_fast_paths``) in place of the TPU backend test.
The TPU's 24 MB VMEM residency caps are kept as dispatch rules so that
both packages take the same paths; the valued path also needs an
output of 4 bytes or less (the JAX package lets 8-byte ones into 4-byte
slabs) and ops the kernel has codes for (built-in ones: the JAX
package's kernel traces user closures too).  Products and folds run at
the output's type (``semiring.ops_at``): 1- and 2-byte values reach the
kernels as 4-byte words and come back narrowed (``_kernels.to_words``).
"""

import os
import time

import numpy as np
import torch

from .. import _kernels, _opgen, types
from .._device import as_tensor, resolve_device
from ..semiring import ops_at
from .dense import apply_present
from .sparse import segment_fold_generic

WIDTH_CAP = 32768
# fused-path residency rule of the TPU kernels (spgemm.py:901-911): the
# column arrays plus 2560 entries of slab padding, 4 bytes an entry (8
# with values), within 24 MB
_RESIDENT_CAP = 24 << 20
_RESIDENT_PAD = 2560
# one (E, W) expansion holds at most this many cells (spgemm.py:990)
_CHUNK_CELLS = 1 << 24
# pad key base: pads sort after every key of a column id < 2^29
_SENT = 1 << 30

# summed over masked_spgemm calls since reset_stats(): calls, heavy
# edges and host seconds by phase
stats = {}


def reset_stats():
    stats.clear()
    stats.update(calls=0, heavy_edges=0, seconds={})


reset_stats()


def add_seconds(seconds, phase, t0):
    """Add the host seconds since perf_counter() value t0 to
    ``seconds[phase]``; returns the time now."""
    t1 = time.perf_counter()
    seconds[phase] = seconds.get(phase, 0.0) + (t1 - t0)
    return t1


def _fast_paths(dev):
    """Whether the fused kernels apply on device `dev` (the JAX
    package's ``jax.default_backend() == "tpu"``)."""
    return dev.type == "cuda"


def _scalar(x, dtype):
    """A Python scalar of numpy scalar x: torch.where takes it with no
    copy to the device."""
    if dtype == torch.bool:
        return bool(x)
    return complex(x) if dtype.is_complex else (
        float(x) if dtype.is_floating_point else int(x))


def _csr_of(rows, cols, vals):
    """rows sorted -> (unique rows, starts, degrees).  O(n) run-length
    scan: np.unique would re-sort the already-sorted rows."""
    n = len(rows)
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z.copy(), z.copy()
    newr = np.empty(n, bool)
    newr[0] = True
    np.not_equal(rows[1:], rows[:-1], out=newr[1:])
    s = np.flatnonzero(newr)
    return rows[s], s, np.diff(np.append(s, n))


def _row_lookup(u, s, d, query):
    """(start, degree) per queried row id.  Dense O(1) tables when the
    id space is small; sorted search otherwise (no dense per-dimension
    arrays, so 2^60 logical dims cost O(nnz) only)."""
    if len(u) == 0:
        z = np.zeros(len(query), np.int64)
        return z, z.copy()
    hi = int(u[-1]) + 1
    if hi <= max(1 << 22, 4 * len(u)):
        st = np.zeros(hi + 1, np.int64)
        dg = np.zeros(hi + 1, np.int64)
        st[u] = s
        dg[u] = d
        q = np.minimum(query, hi)
        return st[q], dg[q]
    pos = np.searchsorted(u, query)
    pos_c = np.minimum(pos, len(u) - 1)
    found = (pos < len(u)) & (u[pos_c] == query)
    return (np.where(found, s[pos_c], 0).astype(np.int64),
            np.where(found, d[pos_c], 0).astype(np.int64))


def _chunks(n, width):
    """Edge ranges of at most _CHUNK_CELLS // width edges."""
    step = max(1, _CHUNK_CELLS // width)
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


# ---------------------------------------------------------------------------
# plain versions of the three kernels


def _fill_plain(a_cols, b_cols, a_st, wa, b_st, wb, width, a_vals=None,
                b_vals=None, ident=0):
    """Key rows of the TPU layout, lane p of edge e:
    ``2·a[a_st+p]`` for p < wa, ``2·b[b_st+W-1-p]+1`` for p >= W-wb
    (A ascending, B descending at the end), ``(1<<30)+2p`` between.
    With values: A's and B's values on their lanes, `ident` between."""
    lane = torch.arange(width, device=a_cols.device)
    in_a = lane < wa.long()[:, None]
    in_b = lane >= width - wb.long()[:, None]
    ia = (a_st.long()[:, None] + lane).clamp_(0, a_cols.numel() - 1)
    ib = (b_st.long()[:, None] + (width - 1 - lane)).clamp_(
        0, b_cols.numel() - 1)
    keys = torch.where(in_a, a_cols[ia] * 2,
                       torch.where(in_b, b_cols[ib] * 2 + 1,
                                   (_SENT + 2 * lane).to(torch.int32)))
    if a_vals is None:
        return keys
    f = _scalar(ident, a_vals.dtype)
    return keys, torch.where(in_a, a_vals[ia],
                             torch.where(in_b, b_vals[ib], f))


def _match(ks):
    """Adjacent keys of one column id (an A entry, then a B entry)."""
    return (ks[:, :-1] >> 1) == (ks[:, 1:] >> 1)


def _sorted_counts(fill, a_cols, b_cols, a_st, wa, b_st, wb, width):
    """Keys from `fill`, torch.sort along each row, count of adjacent
    matches: int32 (E,), in (1<<24)//width-edge chunks."""
    out = [torch.zeros(0, dtype=torch.int32, device=a_cols.device)]
    for lo, hi in _chunks(a_st.numel(), width):
        keys = fill(a_cols, b_cols, a_st[lo:hi], wa[lo:hi], b_st[lo:hi],
                    wb[lo:hi], width)
        ks = torch.sort(keys, dim=1).values
        out.append(_match(ks).sum(1, dtype=torch.int32))
    return torch.cat(out)


def _pair_count_plain(a_cols, b_cols, a_st, wa, b_st, wb, width):
    """Plain version of kernel 10 (``pair_count``): the keys, sorted,
    counted."""
    return _sorted_counts(_fill_plain, a_cols, b_cols, a_st, wa, b_st, wb,
                          width)


def _tree_fold(foldf, x):
    """Fold each row of x (E, n) with the closure `foldf`: log2(n)
    passes of halves (every row holds at least one column)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        top = foldf(x[:, :h], x[:, h:2 * h])
        x = torch.cat([top, x[:, 2 * h:]], 1) if x.shape[1] % 2 else top
    return x[:, 0]


def _masked_fold(add, typ, match, prod, ident):
    """Fold each row's products where `match` with add monoid `add` over
    type `typ` (`ident` the fill of the other lanes): torch's reductions
    where they equal the monoid's fold, else a tree of its closure; ANY
    as MAX, as the kernels fold it."""
    nm = add.binaryop.op if add.binaryop.builtin else None
    if nm == "ANY":
        # any product: the largest (an edge with no match is dropped)
        add = typ.LOR_MONOID if typ._kind == "b" else typ.MAX_MONOID
        ident = _kernels.fold_fill(add, typ)
        nm = add.binaryop.op
    f = _scalar(ident, prod.dtype)
    x = torch.where(match, prod, f)
    plain = not typ._view and typ._kind in "iuf"
    if nm == "PLUS" and typ._kind != "b":
        return x.sum(1, dtype=prod.dtype)
    if nm == "MIN" and plain:
        return x.amin(1)
    if nm == "MAX" and plain:
        return x.amax(1)
    if nm == "TIMES" and typ._kind != "b":
        return x.prod(1, dtype=prod.dtype)
    return _tree_fold(add.apply, x)


def _pair_fold_plain(a_cols, a_vals, b_cols, b_vals, a_st, wa, b_st, wb,
                     width, mul, add):
    """Plain version of kernel 11 (``pair_fold``): keys and values,
    sorted together (the values follow the sort's indices), products at
    the matches, a masked fold per row (ANY as the kernel folds it)."""
    typ = _kernels.value_type(a_vals, add, mul)
    mul = _kernels.binaryop_of(mul, typ)
    add = _kernels.monoid_of(add, typ)
    ident = _kernels.fold_fill(add, typ)
    cnts = [torch.zeros(0, dtype=torch.int32, device=a_cols.device)]
    vals = [torch.zeros(0, dtype=a_vals.dtype, device=a_cols.device)]
    for lo, hi in _chunks(a_st.numel(), width):
        keys, v = _fill_plain(a_cols, b_cols, a_st[lo:hi], wa[lo:hi],
                              b_st[lo:hi], wb[lo:hi], width, a_vals, b_vals,
                              typ.scalar(ident))
        ks, order = torch.sort(keys, dim=1)
        v = torch.gather(v, 1, order)
        match = _match(ks)
        prod = apply_present(mul, match, v[:, :-1], v[:, 1:])
        cnts.append(match.sum(1, dtype=torch.int32))
        vals.append(_masked_fold(add, typ, match, prod, typ.scalar(ident)))
    return torch.cat(cnts), torch.cat(vals)


# ---------------------------------------------------------------------------
# kernel wrappers: plain version for CPU tensors, the kernel for CUDA ones


def _check_intersect(name, a_cols, b_cols, a_st, wa, b_st, wb, *vals):
    """Device, dtype, contiguity and size checks shared by the three
    wrappers.  Row segments must lie inside the column arrays (the bucket
    plan guarantees it; the kernels clip a segment that does not to its
    array, where the plain versions clip each index)."""
    if a_cols.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a_cols.device}")
    _kernels.cuda_args(name, a_cols, b_cols, a_st, wa, b_st, wb, *vals)
    for t in (a_cols, b_cols, a_st, wa, b_st, wb):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: column arrays and per-edge arrays "
                            f"are 1-D int32, not {t.dtype} {t.dim()}-D")
    if not a_st.numel() == wa.numel() == b_st.numel() == wb.numel():
        raise ValueError(f"{name}: per-edge arrays of unequal lengths")
    if not a_cols.numel() or not b_cols.numel():
        raise ValueError(f"{name}: empty column arrays")


def pair_count(a_cols, b_cols, a_st, wa, b_st, wb, width):
    """Kernel 10: per mask edge e, the number of column ids common to
    ``a_cols[a_st[e] : a_st[e] + wa[e]]`` and
    ``b_cols[b_st[e] : b_st[e] + wb[e]]`` (each sorted, unique), as int32
    (E,).  `width` (the bucket's, >= wa + wb) shapes the plain version's
    key rows and picks the kernel's path and lanes per edge."""
    if a_cols.device.type == "cpu":
        return _pair_count_plain(a_cols, b_cols, a_st, wa, b_st, wb, width)
    name = "pair_count"
    _check_intersect(name, a_cols, b_cols, a_st, wa, b_st, wb)
    out = torch.empty(a_st.numel(), dtype=torch.int32, device=a_cols.device)
    rc = _kernels.lib().pgb_pair_count(
        a_cols.data_ptr(), a_cols.numel(), b_cols.data_ptr(), b_cols.numel(),
        a_st.data_ptr(), wa.data_ptr(), b_st.data_ptr(), wb.data_ptr(),
        out.data_ptr(), a_st.numel(), int(width), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return out


def fill_keys(a_cols, b_cols, a_st, wa, b_st, wb, width):
    """Kernel 9: the (E, width) int32 key rows of the TPU layout (see
    ``_fill_plain``); width a multiple of 128."""
    if a_cols.device.type == "cpu":
        return _fill_plain(a_cols, b_cols, a_st, wa, b_st, wb, width)
    name = "fill_keys"
    _check_intersect(name, a_cols, b_cols, a_st, wa, b_st, wb)
    if width % 128 or width > WIDTH_CAP:
        raise ValueError(f"{name}: width {width} is not a multiple of 128 "
                         f"up to {WIDTH_CAP}")
    out = torch.empty((a_st.numel(), width), dtype=torch.int32,
                      device=a_cols.device)
    rc = _kernels.lib().pgb_fill_keys(
        a_cols.data_ptr(), a_cols.numel(), b_cols.data_ptr(), b_cols.numel(),
        a_st.data_ptr(), wa.data_ptr(), b_st.data_ptr(), wb.data_ptr(),
        out.data_ptr(), a_st.numel(), width, _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return out


# pair_fold's path rule (csrc/spgemm.cu, the note above its kernels): a
# bucket of width _RUNS_WIDTH or more with _RUNS_EDGES edges or more
# takes the runs kernel, the others the search kernel
_RUNS_WIDTH = 1024
_RUNS_EDGES = 32768


def fold_path(width, n_edges):
    """pair_fold's kernel for a bucket of `n_edges` edges of `width`:
    "runs" or "search".  Reads only the bucket's shape, before launch."""
    return ("runs" if width >= _RUNS_WIDTH and n_edges >= _RUNS_EDGES
            else "search")


def _fold_ops(mul, add, typ):
    """Whether ``pair_fold`` takes (mul, add) at `typ`: built-in codes, or
    ops that lower (``_opgen``).  Static: nothing is launched."""
    try:
        _kernels.mul_code(mul, typ, "pair_fold")
        _kernels.fold_code(add, typ, "pair_fold")
        return True
    except TypeError:
        return _opgen.lowers(mul, typ) and _opgen.lowers(add, typ)


def pair_fold(a_cols, a_vals, b_cols, b_vals, a_st, wa, b_st, wb, width,
              mul, add):
    """Kernel 11: per mask edge, the match count (int32) and the fold
    with add monoid `add` of ``mul(a_val, b_val)`` over the matches (the
    fill of ``_kernels.fold_fill`` where none: ANY folds as MAX); values
    of any type of 4 bytes or less (held dtype), ops as objects or names
    at the type the values' dtype is read as.  `width` (the bucket's,
    >= wa + wb) shapes the plain version's key rows; with the edge count
    it picks the kernel (``fold_path``) and its lanes per edge; a mul or
    fold the algebra added (ISEQ .. ISLE, LOR, LAND, LXOR, POW ..
    COPYSIGN; the logical and bitwise folds) takes the first port's
    warp kernel at every width (csrc/spgemm.cu).  A user mul or monoid
    (an op without a code) that lowers takes the kernels instantiated
    at the generated functors of both (``_opgen``: ``pgb_pair_fold_gen``,
    by ``fold_path`` as the arithmetic codes); one that does not lower
    raises TypeError (``masked_spgemm`` decides before)."""
    if a_cols.device.type == "cpu":
        return _pair_fold_plain(a_cols, a_vals, b_cols, b_vals, a_st, wa,
                                b_st, wb, width, mul, add)
    name = "pair_fold"
    typ = _kernels.value_type(a_vals, add, mul)
    mul = _kernels.binaryop_of(mul, typ)
    add = _kernels.monoid_of(add, typ)
    code = _kernels.dtype_code(typ, name)
    try:
        mop = _kernels.mul_code(mul, typ, name)
        fop = _kernels.fold_code(add, typ, name)
        gen = None
    except TypeError:
        if not _fold_ops(mul, add, typ):
            raise
        gen = _opgen.unit(add, typ, mul)
    if b_vals.dtype != a_vals.dtype:
        raise TypeError(f"{name}: values of two dtypes")
    a_w = _kernels.to_words(a_vals, typ)
    b_w = _kernels.to_words(b_vals, typ)
    _check_intersect(name, a_cols, b_cols, a_st, wa, b_st, wb, a_w, b_w)
    E = a_st.numel()
    cnt = torch.empty(E, dtype=torch.int32, device=a_cols.device)
    vals = torch.empty(E, dtype=a_w.dtype, device=a_cols.device)
    if a_w.numel() != a_cols.numel() or b_w.numel() != b_cols.numel():
        raise ValueError(f"{name}: values and column ids of unequal lengths")
    args = (a_cols.data_ptr(), a_w.data_ptr(), a_cols.numel(),
            b_cols.data_ptr(), b_w.data_ptr(), b_cols.numel(),
            a_st.data_ptr(), wa.data_ptr(), b_st.data_ptr(), wb.data_ptr(),
            cnt.data_ptr(), vals.data_ptr(), E, int(width),
            int(fold_path(width, E) == "runs"), code)
    ident = _kernels.fill_bits(_kernels.fold_fill(add, typ), typ)
    if gen is None:
        rc = _kernels.lib().pgb_pair_fold(*args, mop, fop, ident,
                                          _kernels.stream())
    else:
        rc = gen.pgb_pair_fold_gen(*args, ident, _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name, None if gen is None else f"{add.name} {mul.name}")
    return cnt, _kernels.from_words(vals, typ)


def _pair_count_chain(a_cols, b_cols, a_st, wa, b_st, wb, width):
    """The unfused chain (spgemm.py:627-632): kernel 9's keys,
    ``torch.sort`` along each row (every key of a row is distinct, so any
    sort gives the same row), count of adjacent matches."""
    return _sorted_counts(fill_keys, a_cols, b_cols, a_st, wa, b_st, wb,
                          width)


# ---------------------------------------------------------------------------
# the generic intersect: torch ops (XLA in the JAX package)


def _generic_intersect(a_cols, a_vals, b_cols, b_vals, a_st, wa, b_st, wb,
                       mi, mj, add, mul, typ, width, narrow):
    """One chunk of one width bucket (spgemm.py:684-771): lanes [0, wa)
    hold A's entries, [wa, wa+wb) B's, the rest distinct pad sentinels;
    one sort along each row, adjacent matches, products (a positional
    mul reads the matched column and the mask edge's row `mi` and
    column `mj`), masked fold, all at type `typ`.  Returns (values,
    int32 counts)."""
    lane = torch.arange(width, device=a_cols.device)
    wa_ = wa.long()[:, None]
    in_a = lane < wa_
    in_b = (lane >= wa_) & (lane < wa_ + wb.long()[:, None])
    src_a = (a_st.long()[:, None] + lane).clamp_(0, a_cols.numel() - 1)
    src_b = (b_st.long()[:, None] + lane - wa_).clamp_(0, b_cols.numel() - 1)
    # int32 keys when column ids fit in 30 bits (halves the sort's bytes)
    kt = torch.int32 if narrow else torch.int64
    sent = (1 << 30) if narrow else (1 << 62)
    keys = torch.where(in_a, a_cols[src_a].to(kt) * 2,
                       torch.where(in_b, b_cols[src_b].to(kt) * 2 + 1,
                                   sent + 2 * lane.to(kt)))
    ident = typ.scalar(add.identity(typ.numpy_dtype))
    out_dt = typ.torch_dtype
    if mul.builtin and mul.positional is None and mul.op == "PAIR":
        # PAIR never reads the values: sort the keys alone
        ks = torch.sort(keys, dim=1).values
        match = _match(ks)
        prod = torch.ones(match.shape, dtype=out_dt, device=keys.device)
    elif mul.positional is not None:
        ks = torch.sort(keys, dim=1).values
        match = _match(ks)
        kk = (ks[:, :-1] >> 1).long()
        pos = dict(i0=mi.long()[:, None], j0=kk, i1=kk, j1=mj.long()[:, None])
        prod = torch.broadcast_to(mul.apply(None, None, pos).to(out_dt),
                                  match.shape)
    else:
        zero = torch.zeros((), dtype=out_dt, device=keys.device)
        va = torch.where(in_a, a_vals[src_a], zero)
        vb = torch.where(in_b, b_vals[src_b], zero)
        ks, order = torch.sort(keys, dim=1)
        va = torch.gather(va, 1, order)
        vb = torch.gather(vb, 1, order)
        match = _match(ks)
        prod = apply_present(mul, match, va[:, :-1], vb[:, 1:]).to(out_dt)
    return (_masked_fold(add, typ, match, prod, ident),
            match.sum(1, dtype=torch.int32))


# ---------------------------------------------------------------------------


def _pull(tensors):
    """Copy tensors to the host in ONE transfer (their bytes packed);
    returns numpy arrays."""
    flat = [t.reshape(-1).contiguous().view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        npdt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[off:off + n].view(npdt))
        off += n
    return out


def _lookup(a_rows, a_cols, bt_rows, bt_cols, m_rows, m_cols):
    """Per mask edge: the start and length of its row of A and of its
    row of B^T (int64 arrays a_st, wa, b_st, wb)."""
    a_st, wa = _row_lookup(*_csr_of(a_rows, a_cols, None), m_rows)
    b_st, wb = _row_lookup(*_csr_of(bt_rows, bt_cols, None), m_cols)
    return a_st, wa, b_st, wb


def _buckets(total, min_width):
    """The light edges (total = wa + wb <= WIDTH_CAP) by width bucket:
    [(width, edge ids)] in increasing width, widths the pow2 menu from
    `min_width` up (spgemm.py:857-858, 928, 947-951)."""
    widths = np.maximum(min_width, 2 ** np.ceil(
        np.log2(np.maximum(total, 1))).astype(np.int64))
    light_idx = np.nonzero(total <= WIDTH_CAP)[0]
    worder = np.argsort(widths[light_idx], kind="stable")
    wsorted = widths[light_idx][worder]
    wstarts = np.flatnonzero(np.concatenate(
        [[True], wsorted[1:] != wsorted[:-1]]))
    wends = np.append(wstarts[1:], len(wsorted))
    return [(int(wsorted[s0]), light_idx[worder[s0:s1]])
            for s0, s1 in zip(wstarts, wends) if s1 > s0]


def _heavy(a_cols, a_vals, bt_cols, bt_vals, a_st, wa, b_st, wb, heavy,
           m_rows, m_cols, add, mul, typ, out_vals, out_cnt):
    """Edges whose lists exceed WIDTH_CAP: host-side sorted intersections,
    products and one generic segment fold (spgemm.py:809-848), with the
    ops' torch closures at type `typ`."""
    vas, vbs, coms, eids = [], [], [], []
    for e in np.nonzero(heavy)[0]:
        ka = a_cols[a_st[e]:a_st[e] + wa[e]]
        kb = bt_cols[b_st[e]:b_st[e] + wb[e]]
        common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                        return_indices=True)
        if len(common):
            vas.append(a_vals[a_st[e] + ia])
            vbs.append(bt_vals[b_st[e] + ib])
            coms.append(common)
            eids.append(np.full(len(common), e, np.int64))
            out_cnt[e] = len(common)
    if not eids:
        return
    eid = np.concatenate(eids)
    if mul.positional is not None:
        key, off = mul.positional
        com = np.concatenate(coms)
        src = dict(i0=m_rows[eid], j0=com, i1=com, j1=m_cols[eid])
        prods = (src[key] + off).astype(typ.numpy_dtype)
    else:
        prods = typ.to_numpy(mul.apply(typ.to_torch(np.concatenate(vas)),
                                       typ.to_torch(np.concatenate(vbs))))

    def fold(x, y):
        return typ.to_numpy(add.apply(typ.to_torch(x), typ.to_torch(y)))

    ue, red = segment_fold_generic(eid, prods, fold)
    out_vals[ue] = red


def masked_spgemm(a_rows, a_cols, a_vals, bt_rows, bt_cols, bt_vals,
                  m_rows, m_cols, semiring, out_dtype, device=None):
    """C<M> = A (+.x) B with B supplied TRANSPOSED (bt = rows of B^T).

    All index arrays are canonical (row-sorted) host numpy COO.  Runs on
    `device` (default ``cuda``; raises without a card).  Returns host
    numpy (rows, cols, vals) of C restricted to present results: mask
    edges with no match are dropped.  The device's results come back in
    one transfer."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    stats["calls"] += 1
    sec = stats["seconds"]
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    add, mul = ops_at(semiring, typ)
    nmask = len(m_rows)
    if nmask == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, out_dtype))

    a_st, wa, b_st, wb = _lookup(a_rows, a_cols, bt_rows, bt_cols, m_rows,
                                 m_cols)
    total = wa + wb
    out_vals = np.zeros(nmask, out_dtype)
    out_cnt = np.zeros(nmask, np.int64)
    t0 = add_seconds(sec, "csr+lookup", t0)

    heavy = total > WIDTH_CAP
    if heavy.any():
        stats["heavy_edges"] += int(heavy.sum())
        _heavy(a_cols, np.asarray(a_vals).astype(out_dtype), bt_cols,
               np.asarray(bt_vals).astype(out_dtype), a_st, wa, b_st, wb,
               heavy, m_rows, m_cols, add, mul, typ, out_vals, out_cnt)
    t0 = add_seconds(sec, "heavy", t0)

    maxcol = max(int(a_cols.max()) if len(a_cols) else 0,
                 int(bt_cols.max()) if len(bt_cols) else 0)
    narrow = maxcol < (1 << 29)

    def fits(n, itemsize):
        return (n + _RESIDENT_PAD) * itemsize <= _RESIDENT_CAP

    card = _fast_paths(dev)
    add_name = add.binaryop.op if add.binaryop.builtin else None
    # PAIR products are all 1: PLUS folds to the match count, and the
    # idempotent monoids to 1 wherever a match exists (spgemm.py:886-906;
    # BXOR, BXNOR, LXOR, EQ and user monoids take the generic intersect)
    add_is_plus = add_name == "PLUS"
    add_is_one = add_name in ("MIN", "MAX", "TIMES", "ANY", "LOR", "LAND",
                              "BOR", "BAND")
    builtin_mul = mul.builtin and mul.positional is None
    pair_fast = (narrow and builtin_mul and mul.op == "PAIR"
                 and (add_is_plus or add_is_one) and card
                 and fits(len(a_cols), 4) and fits(len(bt_cols), 4))
    # the valued path (spgemm.py:907-913): a non-positional, non-UDT
    # semiring with an int or float output of 4 bytes or less, whose ops
    # the kernel has codes for or that lower to its generated functors
    val_fast = (not pair_fast and narrow and mul.positional is None
                and mul.udt is None and out_dtype.kind in "fi"
                and out_dtype.itemsize <= 4 and card
                and _fold_ops(mul, add, typ)
                and fits(len(a_cols), 8) and fits(len(bt_cols), 8)
                and os.environ.get("PYGB_VAL_FUSED", "1") != "0")
    # the fused paths take whole 128-lane rows
    buckets = _buckets(total, 128 if pair_fast or val_fast else 8)

    parts = []          # (edge ids, int32 counts, values or None)
    if pair_fast or val_fast:
        def cols(c):
            c = c if len(c) else np.zeros(1, np.int64)
            return as_tensor(c.astype(np.int32), dev)

        a_c, b_c = cols(a_cols), cols(bt_cols)
        order = np.concatenate([sel for _, sel in buckets] + [[]]).astype(
            np.int64)
        meta = as_tensor(np.stack([a_st[order], wa[order], b_st[order],
                                   wb[order]]).astype(np.int32), dev)
        if val_fast:
            a_v, b_v = (typ.to_torch(v if len(v) else np.zeros(1, out_dtype),
                                     dev) for v in (a_vals, bt_vals))
        fused = os.environ.get("PYGB_PAIR_FUSED", "1") != "0"
        t0 = add_seconds(sec, "plan", t0)
        off = 0
        for w, sel in buckets:
            m = [meta[k, off:off + len(sel)] for k in range(4)]
            off += len(sel)
            if val_fast:
                cnt, v = pair_fold(a_c, a_v, b_c, b_v, *m, w, mul, add)
                parts.append((sel, cnt, v))
            elif fused:
                parts.append((sel, pair_count(a_c, b_c, *m, w), None))
            else:
                parts.append((sel, _pair_count_chain(a_c, b_c, *m, w), None))
    else:
        # generic operands as int64 columns and values of the out type
        def ops(c, v):
            c = c if len(c) else np.zeros(1, np.int64)
            v = v if len(v) else np.zeros(1, out_dtype)
            return (as_tensor(np.asarray(c, np.int64), dev),
                    typ.to_torch(v, dev))

        a_c, a_v = ops(a_cols, a_vals)
        b_c, b_v = ops(bt_cols, bt_vals)
        meta = [as_tensor(x.astype(np.int32), dev)
                for x in (a_st, wa, b_st, wb)]
        mi_mj = [as_tensor(np.asarray(x, np.int64), dev)
                 for x in (m_rows, m_cols)]
        t0 = add_seconds(sec, "plan", t0)
        for w, sel in buckets:
            sel_t = as_tensor(sel, dev)
            for lo, hi in _chunks(len(sel), w):
                m = [x[sel_t[lo:hi]] for x in meta + mi_mj]
                c, cnt = _generic_intersect(a_c, a_v, b_c, b_v, *m, add, mul,
                                            typ, w, narrow)
                parts.append((sel[lo:hi], cnt, c))
    t0 = add_seconds(sec, "dispatch", t0)

    if parts:
        vparts = [p[2] for p in parts if p[2] is not None]
        pulled = _pull(([torch.cat(vparts)] if vparts else [])
                       + [torch.cat([p[1] for p in parts])])
        cnt_all = pulled[-1]
        t0 = add_seconds(sec, "pull", t0)
        off = voff = 0
        for sel, _, v in parts:
            cnt_h = cnt_all[off:off + len(sel)]
            off += len(sel)
            if v is not None:
                out_vals[sel] = pulled[0][voff:voff + len(sel)].view(
                    out_dtype)
                voff += len(sel)
            elif add_is_plus:
                out_vals[sel] = cnt_h.astype(out_dtype)
            else:   # an idempotent monoid over all-1 products
                out_vals[sel] = (cnt_h > 0).astype(out_dtype)
            out_cnt[sel] = cnt_h
    present = out_cnt > 0
    result = (m_rows[present], m_cols[present], out_vals[present])
    add_seconds(sec, "assemble", t0)
    return result
