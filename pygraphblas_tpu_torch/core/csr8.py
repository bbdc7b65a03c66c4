"""Slot-major 8-aligned CSR SpMV with a scatter-free gather-pyramid
reduction.

Counterpart of ``pygraphblas_tpu/core/csr8.py``, the XLA tier the JAX
package takes for an SpMV whose xspmv plan is not warm (``spmv_engine``
"auto" on a cold matrix) or not wanted ("csr8"), and that the fused
loops take below ``xspmv.MIN_NNZ``.  The plan arrays are built on the
host as in the JAX package; the pyramid is torch gathers and axis-0
folds on the plan's device.  The JAX package has no Pallas kernel here,
so neither has the port.

Each row's edges are padded to a multiple of 8 and laid out slot-major
(slot s of block b at ``s*m + b``), so a (8, m) view folds each block
with one axis-0 reduction; per-row block runs are then combined by a
static pyramid of gather layers (8 children a block) until every row is
one value; empty slots read a reserved identity cell.
"""

import numpy as np
import torch

from .. import types
from .._device import as_tensor
from ..binaryop import at_type

BRANCH = 8


def _cdiv(a, b):
    return -(-a // b)


class Csr8Plan:
    """Static SpMV plan for one (matrix, orientation) on one device."""

    __slots__ = ("nrows", "ncols", "nnz", "cols_p", "vals_p", "typ",
                 "pad_mask", "levels", "final_src", "row_present",
                 "n_blocks")

    def __init__(self, rows, cols, vals, nrows, ncols, device="cpu",
                 typ=None):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if typ is None:
            typ = types._gb_from_dtype(vals.dtype)
        self.nrows = nrows
        self.ncols = ncols
        self.nnz = len(rows)

        urows, starts, degs = np.unique(rows, return_index=True,
                                        return_counts=True)
        # level-1 blocks: ceil(d/8) per present row
        b_r = _cdiv(degs, BRANCH)
        m = int(b_r.sum()) if len(b_r) else 0
        m = max(m, 1)
        P = m * BRANCH

        # slot-major fill: edge k of present-row i goes to block
        # (block_start[i] + k//8), slot (k%8) -> position slot*m + block
        blk_start = np.zeros(len(urows), np.int64)
        if len(b_r):
            blk_start[1:] = np.cumsum(b_r)[:-1]
        k_within = np.arange(self.nnz) - np.repeat(starts, degs)
        blk = np.repeat(blk_start, degs) + k_within // BRANCH
        slot = k_within % BRANCH
        pos = slot * m + blk

        cols_p = np.full(P, ncols, np.int64)  # pad -> reserved x cell
        vals_p = np.zeros(P, vals.dtype)
        cols_p[pos] = cols
        vals_p[pos] = vals
        pad_mask = np.zeros(P, bool)
        pad_mask[pos] = True

        self.cols_p = as_tensor(cols_p.astype(np.int64), device)
        self.typ = typ
        self.vals_p = typ.to_torch(vals_p, device)
        self.pad_mask = as_tensor(pad_mask, device)
        self.n_blocks = m

        # ---- reduction plan over block partials -----------------------
        # active rows hold a contiguous run [start, start+len) in the
        # previous level's output; retired rows record (level, pos)
        levels = []
        retire_level = np.zeros(len(urows), np.int64)
        retire_pos = blk_start.copy()
        lens = b_r.copy()
        starts_l = blk_start.copy()
        active = lens > 1
        level_sizes = [m]
        li = 0
        while active.any():
            li += 1
            a_lens = lens[active]
            a_starts = starts_l[active]
            nb = _cdiv(a_lens, BRANCH)
            m2 = int(nb.sum())
            # gather indices, slot-major (8, m2): child j of block q
            nb_start = np.zeros(len(nb), np.int64)
            nb_start[1:] = np.cumsum(nb)[:-1]
            q_within = np.arange(m2) - np.repeat(nb_start, nb)
            base = np.repeat(a_starts, nb) + q_within * BRANCH
            lim = np.repeat(a_starts + a_lens, nb)
            gidx = np.zeros((BRANCH, m2), np.int64)
            for s in range(BRANCH):
                src = base + s
                gidx[s] = np.where(src < lim, src + 1, 0)  # 0: ident cell
            levels.append(as_tensor(gidx.reshape(-1), device))
            level_sizes.append(m2)
            new_lens = lens.copy()
            new_starts = starts_l.copy()
            new_lens[active] = nb
            new_starts[active] = nb_start
            lens, starts_l = new_lens, new_starts
            newly_done = active & (lens == 1)
            retire_level[newly_done] = li
            retire_pos[newly_done] = starts_l[newly_done]
            active = lens > 1

        # final gather: concat buffer = [ident] + lvl0_out + lvl1_out + ...
        offsets = np.zeros(len(level_sizes), np.int64)
        offsets[0] = 1
        for i in range(1, len(level_sizes)):
            offsets[i] = offsets[i - 1] + level_sizes[i - 1]
        final = np.zeros(nrows, np.int64)  # 0 -> ident (empty rows)
        final[urows] = offsets[retire_level] + retire_pos
        self.levels = levels
        self.final_src = as_tensor(final, device)
        row_present = np.zeros(nrows, bool)
        row_present[urows] = True
        self.row_present = as_tensor(row_present, device)


def _fold(name, a):
    """Axis-0 fold of an (8, m) block of partials."""
    if name == "PLUS":
        return torch.sum(a, dim=0, dtype=a.dtype)
    if name in ("MIN", "LAND"):
        return torch.amin(a, dim=0)
    if name in ("MAX", "LOR", "ANY"):
        return torch.amax(a, dim=0)
    return torch.prod(a, dim=0, dtype=a.dtype)       # TIMES


_SUMS = ("PLUS", "MIN", "MAX", "TIMES", "LOR", "LAND", "ANY")


def plan_supported(semiring):
    add_op = semiring.add_monoid.binaryop
    mul = semiring.mul_op
    return (add_op.builtin and mul.builtin
            and add_op.op in _SUMS and mul.positional is None)


def reduce_partials(plan, prod, add_name, ident):
    """Run the gather-pyramid reduction of slot-major block partials down
    to one value per row.  `prod` has shape (8 * n_blocks,); `ident` is a
    0-d tensor of its dtype."""
    s = _fold(add_name, prod.reshape(BRANCH, plan.n_blocks))
    outs = [s]
    for gidx in plan.levels:
        src = torch.cat([ident.reshape(1), s])
        s = _fold(add_name, src[gidx].reshape(BRANCH, -1))
        outs.append(s)
    buf = torch.cat([ident.reshape(1)] + outs)
    return buf[plan.final_src]


def _ordered(name, typ):
    """The sign-bit flip that makes a bit view's MIN/MAX a signed one (0
    where none is needed)."""
    if typ._view and name in ("MIN", "MAX", "ANY"):
        return -(1 << (typ._bits - 1))
    return 0


def spmv_dense_x(plan, x, semiring, out_dtype):
    """y = A (+.x) x for a DENSE x tensor (no mask); returns (vals, mask).

    The pad column points at a reserved trailing x cell holding the add
    identity, so padding contributes the identity with no extra masking
    for FIRST/SECOND/TIMES/PLUS/MIN/MAX/DIV muls; PAIR-like muls apply
    the static pad mask instead."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    tdt = typ.torch_dtype
    dev = x.device
    add = semiring.add_monoid.binaryop.op
    mul = at_type(semiring.mul_op, typ)
    ident = torch.tensor(typ.scalar(semiring.add_monoid.identity(out_dtype)),
                         dtype=tdt, device=dev)
    if add in ("LOR", "LAND", "ANY"):
        ident_x = torch.tensor(0 if add != "LAND" else 1, dtype=x.dtype,
                               device=dev)
    else:
        ident_x = ident.to(x.dtype)
    x_ext = torch.cat([x, ident_x.reshape(1)])
    xe = x_ext[plan.cols_p]
    prod = mul.apply(types.cast(plan.vals_p, plan.typ, typ), xe.to(tdt))
    if mul.op in ("PAIR",) or add in ("LOR", "LAND", "ANY"):
        prod = torch.where(plan.pad_mask, prod.to(tdt), ident)
    if add in ("LOR", "LAND", "ANY"):
        prod = (prod != 0).to(torch.int8)
        y = reduce_partials(plan, prod, add, torch.tensor(
            0 if add != "LAND" else 1, dtype=torch.int8, device=dev))
        y = (y > 0).to(tdt)
    else:
        flip = _ordered(add, typ)
        p = prod.to(tdt)
        y = reduce_partials(plan, p ^ flip if flip else p, add,
                            ident ^ flip if flip else ident)
        y = y ^ flip if flip else y
    return y, plan.row_present


def spmv_masked_x(plan, x_vals, x_mask, semiring, out_dtype,
                  flip_mul=False):
    """Semiring SpMV with a (vals, mask) x: contributions only from
    present x entries; output mask = rows with >= 1 contribution."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    tdt = typ.torch_dtype
    dev = x_vals.device
    add = semiring.add_monoid.binaryop.op
    mul = at_type(semiring.mul_op, typ)
    ident = torch.tensor(typ.scalar(semiring.add_monoid.identity(out_dtype)),
                         dtype=tdt, device=dev)

    xm_ext = torch.cat([x_mask, torch.zeros(1, dtype=torch.bool,
                                            device=dev)])
    xv_ext = torch.cat([x_vals, torch.zeros(1, dtype=x_vals.dtype,
                                            device=dev)])
    xe = xv_ext[plan.cols_p]
    valid = plan.pad_mask & xm_ext[plan.cols_p]
    a = types.cast(plan.vals_p, plan.typ, typ)
    b = xe.to(tdt)
    prod = mul.apply(b, a) if flip_mul else mul.apply(a, b)
    if add in ("LOR", "LAND", "ANY"):
        pb = valid & (prod != 0 if prod.dtype != torch.bool else prod)
        if add == "LAND":
            data = torch.where(valid, pb, True).to(torch.int8)
            y = reduce_partials(plan, data, "LAND",
                                torch.tensor(1, dtype=torch.int8,
                                             device=dev))
        else:
            y = reduce_partials(plan, pb.to(torch.int8), "LOR",
                                torch.tensor(0, dtype=torch.int8,
                                             device=dev))
        y = y > 0
        if typ._kind != "b":
            y = y.to(tdt)
    else:
        flip = _ordered(add, typ)
        data = torch.where(valid, prod.to(tdt), ident)
        y = reduce_partials(plan, data ^ flip if flip else data, add,
                            ident ^ flip if flip else ident)
        y = y ^ flip if flip else y
    cnt = reduce_partials(plan, valid.to(torch.int32), "PLUS",
                          torch.tensor(0, dtype=torch.int32, device=dev))
    y_mask = cnt > 0
    y = torch.where(y_mask, y.to(tdt), torch.zeros((), dtype=tdt,
                                                   device=dev))
    return y, y_mask


def run_spmv_masked(plan, x_vals, x_mask, semiring, out_dtype,
                    flip_mul=False):
    return spmv_masked_x(plan, x_vals, x_mask, semiring, np.dtype(out_dtype),
                         flip_mul)
