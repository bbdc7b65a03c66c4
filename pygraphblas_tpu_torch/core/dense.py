"""Dense semiring matmul: the matmul tier of the unmasked SpGEMM.

Counterpart of ``pygraphblas_tpu/core/dense.py:271-394`` (``_matmul_ok``,
``_f32_pattern_matmul`` and ``mxm``).  The algebras a matmul computes
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


def _truthy(vals):
    return vals if vals.dtype == torch.bool else vals != 0


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
        merged = torch.where(both, addf.apply(acc, val).to(tdt),
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
            z = mulf.apply(x, y).to(tdt)
        part, part_m = z[:, 0, :], pm[:, 0, :]
        for q in range(1, k1 - k0):
            part, part_m = combine(part, part_m, z[:, q, :], pm[:, q, :])
        acc, acc_m = combine(acc, acc_m, part, part_m)
    acc = torch.where(acc_m, acc, torch.zeros_like(acc))
    return acc, acc_m
