"""Monotone windowed gather: ``out[i] = src[idx[i]]`` for a
non-decreasing ``idx``, planned once on the host and run as one kernel.

Counterpart of ``pygraphblas_tpu/core/mono.py``.  ``MonoPlan.build`` is
the same numpy code and gives the same arrays (``q0``, ``dm`` with -1 for
invalid lanes, ``qg``, ``wva``, ``S``, ``blk``, ``stream``, ``xb``,
``xblk``).  ``MonoPlan.to(device)`` moves the arrays into torch tensors.

Modes (op names from ``semiring.ADDS`` / ``semiring.MULS``):
  - plain:  out (S,128) = src[idx], with idx < 0 -> `fill`
  - fused multiply: mul(vals, gathered)
  - fold:   out (S/8,128) = lanewise fold of each 8-row slot group

Kernel: ``mono_span`` (``csrc/mono.cu``) replaces the TPU kernel
``pygraphblas_tpu/core/mono.py:_mono_pallas_span`` for resident,
span-encoded plans (``wva > 0``) -- every plan of the xspmv pipeline at
kron-20.  It is bound by bytes: dm (2 B a cell), the output (4 B a
cell, or 4 B per 8 cells folded) and the source, each moved once.
Plans that need ``_mono_pallas`` (per-row windows, streaming sources)
raise on the card: that kernel is not ported yet.
"""

import numpy as np
import torch

from .. import _kernels
from .._device import as_tensor
from ..semiring import ADDS, MULS

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
    __slots__ = STATIC + ARRAYS

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
        return d

    @staticmethod
    def from_state(d, device=None):
        p = MonoPlan()
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
        return p


def _fill_scalar(fill, dtype):
    """`fill` as a Python scalar: torch.where takes it with no copy to
    the device (a copy would wait for the stream)."""
    return float(fill) if dtype.is_floating_point else int(fill)


def mono_gather(plan, src, fill, vals=None, mul=None, fold=None):
    """Execute the planned monotone gather.

    src: (>= src_n,) tensor, viewed as rows of 128.
    fill: scalar for invalid lanes (monoid identity / zero).
    vals/mul: optional fused product mul(vals, gathered); invalid -> fill.
    fold: optional add-monoid name, folding 8-row slot groups.
    On the card, span-encoded resident plans launch ``mono_span``; any
    other plan raises (its kernel, ``_mono_pallas``, is not ported).
    """
    if src.device.type == "cpu":
        return mono_gather_plain(plan, src, fill, vals, mul, fold)
    if plan.stream or not plan.ok or plan.wva == 0:
        raise NotImplementedError(
            "MonoPlan with per-row windows or a streamed source needs "
            "the _mono_pallas kernel (core/mono.py), not ported yet: "
            "ROADMAP Queue B")
    return mono_span(plan, src, fill, vals, mul, fold)


def _repeat(t, k):
    """Each element of 1-D `t` k times in a row: repeat_interleave(k)
    as one broadcast view and one copy."""
    return t[:, None].expand(-1, k).reshape(-1)


def mono_gather_plain(plan, src, fill, vals=None, mul=None, fold=None):
    """Plain PyTorch version of the gather (both encodings), as the JAX
    package's non-TPU path (pygraphblas_tpu/core/mono.py:211-233)."""
    S = plan.S
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
        mulf = MULS[mul][0]
        g = torch.where(valid, mulf(vals.reshape(S, 128).to(src.dtype), g),
                        f)
    if fold is not None:
        foldf = ADDS[fold][0]
        g = g.reshape(S // 8, 8, 128)
        out = g[:, 0, :]
        for k in range(1, 8):
            out = foldf(out, g[:, k, :])
        return out
    return g


def mono_span(plan, src, fill, vals=None, mul=None, fold=None):
    """The span gather: plain version for CPU tensors, the CUDA kernel
    (``csrc/mono.cu``) for CUDA tensors."""
    if src.device.type == "cpu":
        return mono_gather_plain(plan, src, fill, vals, mul, fold)
    name = "mono_span"
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    if plan.wva == 0 or plan.stream or plan.dm.dtype != torch.int16:
        raise ValueError(f"{name}: needs a resident span-encoded plan")
    code = _kernels.dtype_code(src, name)
    S = plan.S
    src = src.contiguous()
    if mul is not None:
        vals = vals.reshape(-1).to(src.dtype).contiguous()
        if vals.numel() < S * 128:
            raise ValueError(f"{name}: vals shorter than the plan")
    _kernels.cuda_args(name, src, vals, plan.dm, plan.qg)
    out = torch.empty((S // 8 if fold is not None else S, 128),
                      dtype=src.dtype, device=src.device)
    rc = _kernels.lib().pgb_mono_span(
        plan.qg.data_ptr(), plan.dm.data_ptr(), src.data_ptr(), src.numel(),
        vals.data_ptr() if mul is not None else None, out.data_ptr(),
        S // 8, code, MULS[mul][1] if mul is not None else -1,
        ADDS[fold][1] if fold is not None else -1,
        _kernels.fill_bits(fill, src.dtype), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return out
