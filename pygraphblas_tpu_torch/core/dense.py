"""Dense semiring matmul, at the size the port needs so far: the matmul
tier of the unmasked SpGEMM.

Counterpart of ``pygraphblas_tpu/core/dense.py:271-330`` (``_matmul_ok``,
``_f32_pattern_matmul`` and the matmul-lowered algebras of ``mxm``) for
the algebras that ``gustavson._dense_ok`` admits and the port's
semirings have: PLUS_TIMES and PLUS_PAIR.  The JAX package computes them
with XLA matmuls outside any Pallas kernel, so they stay
``torch.matmul`` here, in full float32 on the card (TF32 off).
"""

import contextlib

import numpy as np
import torch


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


def _f32_pattern_matmul(a_mask, b_mask):
    """Structural pattern of the product: a float32 matmul of the
    bitmaps."""
    return torch.matmul(a_mask.to(torch.float32),
                        b_mask.to(torch.float32)) > 0


def mxm(a_vals, a_mask, b_vals, b_mask, semiring, out_dtype):
    """Dense semiring matmul T = A (+).(*) B with its structural pattern;
    returns (values in out_dtype, bool pattern).  PLUS_PAIR counts
    accumulate in float32 on the card (exact while k <= 2^24, as on a
    TPU) and in float64 on the CPU."""
    out_dtype = np.dtype(out_dtype)
    tdt = torch.from_numpy(np.zeros(0, out_dtype)).dtype
    dev = a_vals.device
    k = a_vals.shape[1]
    is_bool = out_dtype == np.bool_
    add, mul = semiring.add, semiring.mul
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
    raise NotImplementedError(
        f"dense mxm: {semiring.name} into {out_dtype} (the JAX package's "
        "generic broadcast-reduce path is not ported; gustavson._dense_ok "
        "sends no such product here)")
