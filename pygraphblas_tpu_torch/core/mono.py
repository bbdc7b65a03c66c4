"""Monotone windowed gather: ``out[i] = src[idx[i]]`` for a
non-decreasing ``idx``, planned once on the host and run as one kernel.

Counterpart of ``pygraphblas_tpu/core/mono.py``.  ``MonoPlan.build`` is
the same numpy code and gives the same arrays (``q0``, ``dm`` with -1 for
invalid lanes, ``qg``, ``wva``, ``S``, ``blk``, ``stream``, ``xb``,
``xblk``).  ``MonoPlan.to(device)`` moves the arrays into torch tensors.

Modes (ops as objects of ``binaryop`` / ``monoid``, or their names at
the type the source's dtype is read as: ``_kernels.value_type``):
  - plain:  out (S,128) = src[idx], with idx < 0 -> `fill`
  - fused multiply: mul(vals, gathered)
  - fold:   out (S/8,128) = lanewise fold of each 8-row slot group

Kernels (``csrc/mono.cu``, ``csrc/cascade.cu``), each beside its plain
PyTorch version:
  - ``mono_span`` replaces ``pygraphblas_tpu/core/mono.py:_mono_pallas_span``
    (resident, span-encoded plans: ``wva > 0``);
  - ``mono_rows`` replaces ``pygraphblas_tpu/core/mono.py:_mono_pallas``
    (per-row windows, ``wva == 0``, resident or streamed);
  - ``mono_cascade`` replaces ``pygraphblas_tpu/core/mono.py:mono_cascade``
    (every xspmv fold level and the final placement in one launch, as a
    per-row tree fold of the level-0 source: ``fold_plans``' table).
All three are bound by bytes: dm (2 or 4 B a cell), the output (4 B a
cell, or 4 B per 8 cells folded) and the source, each moved once; the
cascade reads the source, one table entry a row and writes the output.
On the card, a plan with ``ok == False`` (a streaming span wider than
``_MAX_XB`` rows) and a dtype wider than 4 bytes take the plain
version, as the JAX package sends them to its XLA gather
(pygraphblas_tpu/core/mono.py:209-210).
"""

import numpy as np
import torch

from .. import _kernels
from .._device import as_tensor

# resident-source limit: keep the whole source in fast memory below
# this (plan layout rule shared with the JAX package)
_RESIDENT_BYTES = 11 << 20
_MAX_XB = 8192           # streaming window block rows
# span encoding: groups spanning more source rows than this keep the
# per-row encoding
_SPAN_MAX_WVA = 48


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


class MonoPlan:
    """Static plan for one monotone gather: idx (N,) non-decreasing into
    a source of logical length src_n.  idx[i] < 0 marks invalid -> fill.

    Arrays are numpy after ``build`` and torch tensors after ``to``."""

    STATIC = ("S", "blk", "src_n", "src_rows", "max_w", "stream", "xb",
              "xblk_max", "ok", "wva")
    ARRAYS = ("q0", "dm", "xblk", "qg")
    # cascade: the CascadeRuns of the fold cascade this plan places (set
    # by fold_plans on a placement plan; None elsewhere)
    __slots__ = STATIC + ARRAYS + ("cascade",)

    @staticmethod
    def build(idx, src_n, itemsize=4):
        idx = np.asarray(idx, np.int64)
        n = len(idx)
        it = np.int32 if src_n < (1 << 31) else np.int64
        idx = idx.astype(it)
        # S multiple of 64: fold-mode outputs are S/8 rows
        S = max(64, -(-n // 128))
        S = -(-S // 64) * 64
        pad = S * 128 - n
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, it)])
        idxm = idx.reshape(S, 128)
        valid = idxm >= 0
        firsts = np.where(valid, idxm, np.iinfo(it).max).min(axis=1)
        # rows with no valid index carry the previous row's first forward
        firsts = np.where(valid.any(axis=1), firsts, it(-1))
        firsts = np.maximum.accumulate(firsts)
        firsts = np.where(firsts < 0, it(0), firsts)
        q0 = firsts >> 7
        dm64 = np.where(valid, idxm - (q0[:, None] << 7), it(-1))
        dm = dm64.astype(np.int16) if (n == 0 or dm64.max() < 32767) \
            else dm64.astype(np.int32)

        plan = MonoPlan()
        plan.cascade = None
        plan.S = S
        plan.src_n = src_n
        plan.src_rows = -(-src_n // 128)
        plan.dm = dm
        plan.max_w = int(dm.max() // 128 + 1) if n else 1
        plan.ok = True
        plan.wva = 0
        plan.qg = np.zeros((S // 8,), np.int32)

        blk = 512
        while S % blk:
            blk //= 2
        plan.blk = blk

        if (plan.src_rows + 2) * 128 * itemsize <= _RESIDENT_BYTES:
            plan.stream = False
            plan.q0 = q0.astype(np.int32)
            plan.xb = 0
            plan.xblk = np.zeros((S // blk,), np.int32)
            plan.xblk_max = 0
            # group-span encoding: qg = group base row, dm relative to
            # the GROUP base, wva = widest group span in source rows
            qg = q0[0::8]                       # q0 is non-decreasing
            ci = (q0[:, None] - np.repeat(qg, 8)[:, None]) * 128 + dm64
            ci_max = int(np.where(dm64 >= 0, ci, 0).max()) if n else 0
            wva = ci_max // 128 + 1
            if wva <= _SPAN_MAX_WVA:
                plan.wva = wva
                plan.dm = np.where(dm64 >= 0, ci, -1).astype(np.int16)
                plan.qg = qg.astype(np.int32)
            return plan

        # streaming: per output block, two consecutive source blocks of
        # XB rows must cover every window the block's rows touch
        plan.stream = True
        nblocks = S // blk
        q0b = q0.reshape(nblocks, blk)
        wrows = (dm.max(axis=1) // 128 + 1).reshape(nblocks, blk)
        lo = q0b.min(axis=1)
        hi = (q0b + wrows).max(axis=1)
        xb = _next_pow2(int((hi - lo).max()) + 2)
        while True:
            blo = lo // xb
            if int((hi - blo * xb).max()) <= 2 * xb - 1 or xb >= (1 << 30):
                break
            xb *= 2
        if xb > _MAX_XB:
            plan.ok = False   # pathological span: callers use the plain path
            xb = _MAX_XB
        plan.xb = xb
        xblk = (lo // xb).astype(np.int64)
        plan.xblk = xblk.astype(np.int32)
        plan.xblk_max = int(xblk.max()) if len(xblk) else 0
        plan.q0 = (q0 - np.repeat(xblk * xb, blk)).astype(np.int32)
        return plan

    def state(self):
        """Static fields and numpy arrays (the plan cache's format)."""
        d = {k: getattr(self, k) for k in self.STATIC}
        for k in self.ARRAYS:
            d[k] = np.asarray(getattr(self, k))
        if self.cascade is not None:
            c = self.cascade
            d["cascade"] = dict(start=np.asarray(c.start), levels=c.levels,
                                cells=c.cells)
        return d

    @staticmethod
    def from_state(d, device=None):
        p = MonoPlan()
        c = d.get("cascade")
        p.cascade = (CascadeRuns(np.asarray(c["start"]), int(c["levels"]),
                                 int(c["cells"])) if c is not None else None)
        for k in MonoPlan.STATIC:
            setattr(p, k, d[k])
        for k in MonoPlan.ARRAYS:
            setattr(p, k, np.asarray(d[k]))
        return p.to(device) if device is not None else p

    def to(self, device):
        p = MonoPlan()
        for k in self.STATIC:
            setattr(p, k, getattr(self, k))
        for k in self.ARRAYS:
            setattr(p, k, as_tensor(getattr(self, k), device))
        p.cascade = (self.cascade.to(device) if self.cascade is not None
                     else None)
        return p


def _fill_scalar(fill, dtype):
    """`fill` as a Python scalar: torch.where takes it with no copy to
    the device (a copy would wait for the stream)."""
    if dtype == torch.bool:
        return bool(fill)
    return float(fill) if dtype.is_floating_point else int(fill)


def gather_route(plan, src):
    """The kernel mono_gather launches for `src`, or None where it runs
    the plain version: a CPU tensor, and on the card a plan with ``ok ==
    False`` or a dtype wider than 4 bytes (the JAX package's XLA rule,
    mono.py:209-210); else ``mono_span`` for span-encoded plans and
    ``mono_rows`` for the others (mono.py:234-236).  Reads only the
    plan's ``ok`` and ``wva``, the device and the dtype's size."""
    if not _kernels.on_card(src, "mono_gather") or not plan.ok:
        return None
    return "mono_span" if plan.wva else "mono_rows"


def mono_gather(plan, src, fill, vals=None, mul=None, fold=None):
    """Execute the planned monotone gather.

    src: (>= src_n,) tensor, viewed as rows of 128.
    fill: scalar for invalid lanes (monoid identity / zero).
    vals/mul: optional fused product mul(vals, gathered); invalid -> fill.
    fold: optional add-monoid name, folding 8-row slot groups.
    The route is ``gather_route``'s.
    """
    route = gather_route(plan, src)
    if route is None:
        return mono_gather_plain(plan, src, fill, vals, mul, fold)
    kernel = mono_span if route == "mono_span" else mono_rows
    return kernel(plan, src, fill, vals, mul, fold)


def _repeat(t, k):
    """Each element of 1-D `t` k times in a row: repeat_interleave(k)
    as one broadcast view and one copy."""
    return t[:, None].expand(-1, k).reshape(-1)


def mono_gather_plain(plan, src, fill, vals=None, mul=None, fold=None):
    """Plain PyTorch version of the gather (both encodings), as the JAX
    package's non-TPU path (pygraphblas_tpu/core/mono.py:211-233)."""
    S = plan.S
    typ = _kernels.value_type(src, fold, mul)
    dm = plan.dm.long()
    valid = dm >= 0
    if plan.wva:
        # span encoding: dm is relative to the GROUP base row
        base = _repeat(plan.qg.long(), 8)
    else:
        base = plan.q0.long()
        if plan.stream:
            base = base + _repeat(plan.xblk.long() * plan.xb, plan.blk)
    idx = base[:, None] * 128 + dm
    g = src[idx.reshape(-1).clamp(0, src.shape[0] - 1)].reshape(S, 128)
    f = _fill_scalar(fill, src.dtype)
    g = torch.where(valid, g, f)
    if mul is not None:
        mulf = _kernels.binaryop_of(mul, typ).apply
        g = torch.where(valid, mulf(vals.reshape(S, 128).to(src.dtype), g),
                        f)
    if fold is not None:
        foldf = _kernels.fold_fn(_kernels.monoid_of(fold, typ), typ)
        g = g.reshape(S // 8, 8, 128)
        out = g[:, 0, :]
        for k in range(1, 8):
            out = foldf(out, g[:, k, :])
        return out
    return g


def _prepare(name, plan, src, vals, mul, fold, *index):
    """Checks and buffers shared by the gather kernels' wrappers: returns
    (source words, vals words pointer, output words, type, dtype code,
    mul code, fold code)."""
    typ = _kernels.value_type(src, fold, mul)
    code = _kernels.dtype_code(typ, name)
    mop = _kernels.mul_code(_kernels.binaryop_of(mul, typ), typ, name)
    fop = _kernels.fold_code(_kernels.monoid_of(fold, typ), typ, name)
    S = plan.S
    src = _kernels.to_words(src.contiguous(), typ)
    if mul is not None:
        vals = _kernels.to_words(vals.reshape(-1).to(typ.torch_dtype),
                                 typ).contiguous()
        if vals.numel() < S * 128:
            raise ValueError(f"{name}: vals shorter than the plan")
    _kernels.cuda_args(name, src, vals, plan.dm, *index)
    out = torch.empty((S // 8 if fold is not None else S, 128),
                      dtype=src.dtype, device=src.device)
    return (src, vals if mul is not None else None, out, typ, code, mop,
            fop)


# the folds of the per-row and cascade kernels: xspmv's (ANY folds as MAX)
_XSPMV_FOLDS = (-1, 0, 1, 2, 3, 4)
# over BOOL's 0/1 words LOR is MAX and LAND is MIN
_BOOL_ARITH = {_kernels.FOLDS["LOR"]: _kernels.FOLDS["MAX"],
               _kernels.FOLDS["LAND"]: _kernels.FOLDS["MIN"]}


def _arith_fold(fop, typ):
    """A fold code of the per-row and cascade kernels for `fop`."""
    return _BOOL_ARITH.get(fop, fop) if typ.__name__ == "BOOL" else fop


def mono_span(plan, src, fill, vals=None, mul=None, fold=None):
    """The span gather: the CUDA kernel (``csrc/mono.cu``) where
    ``_kernels.on_card``, else the plain version."""
    name = "mono_span"
    if not _kernels.on_card(src, name):
        return mono_gather_plain(plan, src, fill, vals, mul, fold)
    src, vw, out, typ, code, mop, fop = _prepare(name, plan, src, vals,
                                                 mul, fold, plan.qg)
    if plan.wva == 0 or plan.stream or plan.dm.dtype != torch.int16:
        raise ValueError(f"{name}: needs a resident span-encoded plan")
    rc = _kernels.lib().pgb_mono_span(
        plan.qg.data_ptr(), plan.dm.data_ptr(), src.data_ptr(), src.numel(),
        vw.data_ptr() if vw is not None else None, out.data_ptr(),
        plan.S // 8, code, mop, fop, _kernels.fill_bits(fill, typ),
        _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return _kernels.from_words(out, typ)


def mono_rows(plan, src, fill, vals=None, mul=None, fold=None):
    """The per-row gather (resident or streamed plans): the CUDA kernel
    (``csrc/mono.cu``) where ``_kernels.on_card``, else the plain
    version."""
    name = "mono_rows"
    if not _kernels.on_card(src, name):
        return mono_gather_plain(plan, src, fill, vals, mul, fold)
    xblk = plan.xblk if plan.stream else None
    src, vw, out, typ, code, mop, fop = _prepare(name, plan, src, vals,
                                                 mul, fold, plan.q0, xblk)
    if plan.wva or not plan.ok:
        raise ValueError(f"{name}: needs a per-row plan with ok == True")
    if plan.dm.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"{name}: dm must be int16 or int32")
    fop = _arith_fold(fop, typ)
    if fop not in _XSPMV_FOLDS:
        raise ValueError(f"{name}: folds PLUS, MIN, MAX, TIMES or ANY")
    # the kernel reads dm and vals, and writes out, in 16-byte words
    if plan.dm.data_ptr() % 16:
        raise ValueError(f"{name}: the plan's dm is not 16-byte aligned")
    if vw is not None and vw.data_ptr() % 16:
        vw = vw.clone()
    rc = _kernels.lib().pgb_mono_rows(
        plan.q0.data_ptr(), plan.dm.data_ptr(), plan.dm.element_size(),
        xblk.data_ptr() if xblk is not None else None, plan.xb, plan.blk,
        src.data_ptr(), src.numel(), vw.data_ptr() if vw is not None
        else None, out.data_ptr(), plan.S // 8, code, mop, fop,
        _kernels.fill_bits(fill, typ), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return _kernels.from_words(out, typ)


# the TPU kernel's VMEM budget for the whole cascade (mono.py:384): kept
# as the dispatch rule, so that both packages take the same path
_CASCADE_BUDGET = 90 << 20


def _cascade_applies(levels, place, dtype):
    """The JAX package's dispatch rules (mono.py:361-385)."""
    if not levels:
        return False
    isz = dtype.itemsize
    if isz > 4:
        return False
    plans = list(levels) + [place]
    if any((not p.ok) or p.stream or p.wva == 0 for p in plans):
        return False
    budget = (levels[0].src_rows + levels[0].wva + 2) * 128 * isz
    for l, p in enumerate(levels):
        budget += (p.S // 8 + plans[l + 1].wva + 2) * 128 * isz
    for p in plans:
        budget += p.dm.numel() * p.dm.element_size() + p.qg.numel() * 4
    budget += place.S * 128 * isz
    return budget <= _CASCADE_BUDGET


class CascadeRuns:
    """The table mono_cascade's kernel reads: placed output cell i folds
    the run ``src[start[i] : start[i + 1]]`` of the level-0 source
    through `levels` 8-ary levels (an empty run gives the fill).
    `start` is int32 numpy on the host, a tensor after ``to``; `cells`
    is its last entry, the source length the kernel reads."""

    __slots__ = ("start", "levels", "cells")

    def __init__(self, start, levels, cells):
        self.start, self.levels, self.cells = start, levels, cells

    def to(self, device):
        return CascadeRuns(as_tensor(self.start, device), self.levels,
                           self.cells)


def fold_index(counts):
    """xspmv's fold level over rows of `counts` consecutive cells (in row
    order, from cell 0): output cell (row r, group j) folds the row's
    cells 8j .. 8j + 7, -1 past the row's end.  Returns the gather index
    as MonoPlan.build takes it ((groups rounded up to 128) / 128, 8, 128
    flattened, -1 padded) and the next level's counts."""
    counts = np.asarray(counts, np.int64)
    off = np.zeros(len(counts), np.int64)
    off[1:] = np.cumsum(counts)[:-1]
    c_n = -(-counts // 8)
    off_n = np.zeros(len(counts), np.int64)
    off_n[1:] = np.cumsum(c_n)[:-1]
    m = int(c_n.sum())
    m_p = -(-m // 128) * 128
    gidx = np.full((m_p // 128, 8, 128), -1, np.int64)
    rr = np.repeat(np.arange(len(counts)), c_n)
    base = off[rr] + 8 * (np.arange(m) - off_n[rr])
    lim = off[rr] + counts[rr]
    cell = np.arange(m)
    for s in range(8):
        child = base + s
        gidx[cell // 128, s, cell % 128] = np.where(child < lim, child, -1)
    return gidx.reshape(-1), c_n


def fold_plans(counts, nrows, present, itemsize=4):
    """xspmv's fold levels and placement (core/xspmv.py) for the rows
    `present` (sorted, distinct, of `nrows`) whose level-0 runs hold
    `counts` cells (at least 1), one run after another from cell 0: the
    levels fold each row's cells 8 at a time until every row has one,
    and the placement puts row r's cell at output present[r].  Where
    there are levels, the placement carries the cascade's row table
    (``place.cascade``, ``cascade_table``).  Returns (levels, place),
    numpy plans; raises ValueError for runs of another shape."""
    c = np.asarray(counts, np.int64)
    present = np.asarray(present, np.int64)
    if (len(present) != len(c) or (c < 1).any()
            or (np.diff(present) < 1).any()
            or (len(c) and (present[0] < 0 or present[-1] >= nrows))):
        raise ValueError("fold_plans: every present row (sorted, distinct, "
                         f"of {nrows}) needs a run of at least one cell")
    if c.sum() >= 1 << 31:
        raise ValueError("fold_plans: the level-0 source has 2^31 cells "
                         "or more")
    levels = []
    while len(c) and c.max() > 1:
        n_in = int(c.sum())
        gidx, c = fold_index(c)
        levels.append(MonoPlan.build(gidx, n_in, itemsize))
    pos = np.full(nrows, -1, np.int64)
    pos[present] = np.arange(len(present))
    place = MonoPlan.build(pos, max(1, len(present)), itemsize)
    if levels:
        place.cascade = cascade_table(counts, present, place.S * 128,
                                      len(levels))
    return levels, place


def cascade_table(counts, present, n_out, levels):
    """The cascade's row table for `n_out` output cells: output
    present[r] folds the r-th run of `counts` cells of the level-0
    source (the runs one after another from cell 0) through `levels`
    levels; every other output cell has an empty run.  An O(rows) step
    of ``fold_plans``, which checks its inputs."""
    per = np.zeros(n_out, np.int64)
    per[present] = counts
    start = np.zeros(n_out + 1, np.int32)
    np.cumsum(per, out=start[1:])
    return CascadeRuns(start, levels, int(start[-1]))


def mono_cascade(levels, place, src, fill, fold):
    """Every fold level (add monoid `fold`, an object or a name) and the
    final placement
    in one launch.  Returns the placed (place.S, 128) tensor, or None
    where the JAX package's mono_cascade does not apply (no levels, a
    dtype wider than 4 bytes, a plan that is streamed, per-row or not
    ok, or its budget): callers then run the per-level chain.

    CPU tensors take the plain version, the chain of
    ``mono_gather_plain`` calls; CUDA tensors launch the per-row tree
    fold (``csrc/cascade.cu``), which reads the table ``fold_plans``
    attached to `place` with the levels."""
    if not _cascade_applies(levels, place, src.dtype):
        return None
    if src.device.type == "cpu":
        cur = src
        for lp in levels:
            cur = mono_gather_plain(lp, cur.reshape(-1), fill,
                                    fold=fold).reshape(-1)
        return mono_gather_plain(place, cur, fill)
    name = "mono_cascade"
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    typ = _kernels.value_type(src, fold)
    code = _kernels.dtype_code(typ, name)
    fop = _arith_fold(
        _kernels.fold_code(_kernels.monoid_of(fold, typ), typ, name), typ)
    if fop not in _XSPMV_FOLDS[1:]:
        raise ValueError(f"{name}: folds PLUS, MIN, MAX, TIMES or ANY")
    runs = place.cascade
    if (runs is None or runs.levels != len(levels)
            or runs.cells != levels[0].src_n):
        raise ValueError(f"{name}: the placement plan carries no row table "
                         f"for these {len(levels)} levels: build the plans "
                         "with fold_plans")
    src = _kernels.to_words(src.reshape(-1).contiguous(), typ)
    if src.numel() < runs.cells:
        raise ValueError(f"{name}: the source has {src.numel()} cells, "
                         f"the plans read {runs.cells}")
    _kernels.cuda_args(name, src, runs.start)
    out = torch.empty((place.S, 128), dtype=src.dtype, device=src.device)
    rc = _kernels.lib().pgb_mono_cascade(
        src.data_ptr(), src.numel(), runs.start.data_ptr(), out.data_ptr(),
        out.numel(), len(levels), code, fop, _kernels.fill_bits(fill, typ),
        _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return _kernels.from_words(out, typ)
