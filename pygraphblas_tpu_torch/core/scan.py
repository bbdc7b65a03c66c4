"""Segmented inclusive fold-scan.

Counterpart of ``pygraphblas_tpu/core/scan.py``: for a flat value
stream cut into segments by start flags, the running monoid fold within
each segment,

    out[i] = flags[i] ? values[i] : fold(out[i-1], values[i]).

The ESC engine (core/esc.py) runs it four times a product: the gather
positions and the output rows and A values of the expansion, and the
segment totals of the sorted products.

Kernel (``csrc/scan.cu``), beside its plain PyTorch version:
  - ``segfold`` replaces scan.py:53 ``_segfold_pallas``: a single-pass
    scan with decoupled look-back, one launch a scan.  The TPU kernel
    carries across grid blocks in SMEM, which needs the TPU's in-order
    grid; the card's blocks take 4096-value tiles by ticket and look
    back instead.
A user add monoid (or any other without a fold code) that lowers
(``_opgen.lower``) folds in the same kernel instantiated at its
generated functor (``pgb_segfold_gen``), as the JAX kernel folds with
any traced ``combine``; one that does not lower raises TypeError here
(its callers decide before: ``esc.esc_supported``).
The plain version is a Hillis-Steele log-step scan over the segmented
combine ``(va,fa)·(vb,fb) = (fb ? vb : fold(va,vb), fa|fb)``, the
counterpart of the JAX package's ``lax.associative_scan`` path.  Integer
and MIN/MAX folds agree exactly; a float PLUS differs by fold order.
"""

import torch

from .. import _kernels, _opgen


def _segfold_plain(values, flags, add):
    """Plain version of kernel 12: log2(M) steps, each combining every
    element with the one `d` before it."""
    typ = _kernels.value_type(values, add)
    fold = _kernels.fold_fn(_kernels.monoid_of(add, typ), typ)
    v, f = values, flags.to(torch.bool)
    d = 1
    while d < v.numel():
        lv, lf, rv, rf = v[:-d], f[:-d], v[d:], f[d:]
        v = torch.cat([v[:d], torch.where(rf, rv, fold(lv, rv))])
        f = torch.cat([f[:d], lf | rf])
        d *= 2
    return v


# device -> [int64 tile statuses, int32 ticket counter, epoch of the last
# call]: tiles publish their call's epoch with each status, so the buffer
# is never cleared (calls are ordered on the current stream); the kernel
# leaves the counter at 0
_STATE = {}


def _scan_state(device, tiles):
    """The status buffer (at least `tiles` words), the ticket counter and
    a new epoch for one segfold launch on `device`."""
    ent = _STATE.get(device)
    if ent is None or ent[0].numel() < tiles or ent[2] >= (1 << 29) - 1:
        ticket = ent[1] if ent is not None else torch.zeros(
            1, dtype=torch.int32, device=device)
        ent = _STATE[device] = [torch.zeros(max(tiles, 1 << 12),
                                            dtype=torch.int64,
                                            device=device), ticket, 0]
    ent[2] += 1
    return ent[0], ent[1], ent[2]


def segfold(values, flags, add):
    """Kernel 12: the inclusive segmented scan of `values` (M,) with
    segment-start `flags` (M,) bool under the add monoid `add` (a Monoid,
    or its name at the type values' dtype is read as); M % 1024 == 0.
    Values of any type of 4 bytes or less on the card (ANY folds as
    MAX there and in the plain version: any value of the segment); a
    user monoid through its generated kernel where it lowers."""
    m = values.numel()
    if m % 1024:
        raise ValueError(f"segfold needs a 1024-multiple length, not {m}")
    if values.device.type == "cpu":
        return _segfold_plain(values, flags, add)
    name = "segfold"
    if values.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {values.device}")
    typ = _kernels.value_type(values, add)
    code = _kernels.dtype_code(typ, name)
    add = _kernels.monoid_of(add, typ)
    try:
        fop, gen = _kernels.fold_code(add, typ, name), None
    except TypeError:
        if not _opgen.lowers(add, typ):
            raise
        fop, gen = None, _opgen.fold_unit(add, typ)
    values = _kernels.to_words(values, typ)
    _kernels.cuda_args(name, values, flags)
    if flags.dtype != torch.bool or flags.numel() != m or values.dim() != 1:
        raise TypeError(f"{name}: values (M,) and bool flags (M,)")
    if values.data_ptr() % 16 or flags.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel's 16-byte loads need "
                         "16-byte aligned values and flags")
    out = torch.empty_like(values)
    lib = _kernels.lib()
    status, ticket, epoch = _scan_state(values.device,
                                        lib.pgb_segfold_tiles(m))
    if gen is None:
        rc = lib.pgb_segfold(values.data_ptr(), flags.data_ptr(),
                             out.data_ptr(), m, code, fop, status.data_ptr(),
                             epoch, ticket.data_ptr(), _kernels.stream())
    else:
        rc = gen.pgb_segfold_gen(values.data_ptr(), flags.data_ptr(),
                                 out.data_ptr(), m, code, status.data_ptr(),
                                 epoch, ticket.data_ptr(), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name, None if gen is None else add.name)
    return _kernels.from_words(out, typ)

