"""Block-partitioned distributed semiring SpMV over a device mesh.

The scaling tier: an adjacency matrix is 2-D block-partitioned over a
``torch.distributed`` ``DeviceMesh`` with dimensions ("i", "j"); each
rank owns one (row-block, col-block) tile as padded COO index tensors on
its device.  A semiring SpMV is then

    y_i = (+)_j  A_ij (*) x_j

computed as a local gather + segment-reduce per tile, followed by an
``all_reduce`` over the "j" group.  Vector resharding between iterations
(row-block results -> column-block operands) is an ``all_gather`` of the
row blocks over the "i" group, then this rank's column block: the
frontier/halo exchange of the design brief.

The execution model is SPMD, PyTorch's idiom for several cards: one
process a device.  Every rank calls the same functions with the same
host inputs, keeps only its own tile on its device, and returns the same
host result (``DistMatrix.mxv`` returns the same ``Vector`` on every
rank).  Functions that hand back device-resident state return this
rank's block of it, as the JAX package's sharded arrays hold one block a
device: ``DistSpMV`` returns this rank's row block (``gather`` joins
the blocks), ``frontier_all_to_all`` this rank's received packets.

NCCL has no bitwise reductions and no bool, so the bitwise adds combine
by a per-bit decomposition and the logical ones through int8 MAX/MIN:
the same code runs over NCCL on cards and over gloo on the CPU.  Tiles
are padded to the largest tile's entry count, as in the JAX package, and
held sorted by row, so that their floating-point PLUS and TIMES folds
run in a fixed order (``segment_reduce``) and a run repeats bit for bit;
the other folds are ``index_add_`` / ``scatter_reduce_``, exact in any
order.
"""

import atexit
import math
import shutil
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..base import DimensionMismatch, burble

# ring-plan cache: the block_csr host builds (argsort + bincount +
# unique over nnz) and their device placements are keyed on operand
# CONTENT, so repeated DistMatrix.mxm calls on the same operands skip
# the host rebucketing and re-transfer.  _STATS counts actual builds for
# tests.
_STATS = {"block_csr_builds": 0}
_RING_CACHE = {}
_RING_CACHE_MAX = 8

# host and device seconds by phase ("balance", "tiling", "device",
# "ring_host"), and the bytes placed on this rank's device ("tiles":
# DistSpMV tiles; "ring": the rings' row blocks and descriptors); read
# and cleared by callers that report them
seconds = defaultdict(float)
held_bytes = defaultdict(int)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _ring_cache_get(key):
    return _RING_CACHE.get(key)


def _ring_cache_put(key, value):
    if len(_RING_CACHE) >= _RING_CACHE_MAX:
        _RING_CACHE.pop(next(iter(_RING_CACHE)))
    _RING_CACHE[key] = value


def _content_key(*arrays):
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# value dtypes: the dtype a numpy dtype's values are computed in
# ---------------------------------------------------------------------------

# torch has few uint16/32/64 kernels: UINT16 and UINT32 values are
# computed in a wider signed dtype (exact for every op of the table; the
# cast back keeps the low bits, as the unsigned arithmetic wraps), UINT64
# as its int64 bit view (the ops whose result depends on order raise).
# bool is computed in int32, so that a PLUS fold cannot wrap.
_WORK = {np.dtype(np.bool_): torch.int32,
         np.dtype(np.uint16): torch.int32,
         np.dtype(np.uint32): torch.int64,
         np.dtype(np.uint64): torch.int64}
_ORDERED = {"MIN", "MAX", "DIV", "RDIV", "GT", "LT", "GE", "LE", "ISGT",
            "ISLT", "ISGE", "ISLE"}


def _work(dtype):
    dtype = np.dtype(dtype)
    if dtype in _WORK:
        return _WORK[dtype]
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _check_ops(dtype, *names):
    if np.dtype(dtype) == np.uint64 and _ORDERED.intersection(names):
        raise NotImplementedError(
            f"the distributed tier computes UINT64 as its int64 bit view: "
            f"{sorted(_ORDERED.intersection(names))} compare values")


def _to_work(a, dtype, device):
    """host values of numpy `dtype` -> a tensor of the work dtype."""
    a = np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype in _WORK:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device=device, dtype=_work(dtype))


def _to_host(t, dtype):
    """a work-dtype tensor -> numpy values of `dtype` (bool results of
    the logical adds stay bool)."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.bool_:
        return a
    dtype = np.dtype(dtype)
    if dtype == np.uint64:
        return a.view(np.uint64)
    return a.astype(dtype)


# ---------------------------------------------------------------------------
# the op tables
# ---------------------------------------------------------------------------

_MULS = {
    "TIMES": lambda a, x: a * x,
    "PLUS": lambda a, x: a + x,
    "MINUS": lambda a, x: a - x,
    "RMINUS": lambda a, x: x - a,
    "DIV": lambda a, x: a / x,
    "RDIV": lambda a, x: x / a,
    "MIN": torch.minimum,
    "MAX": torch.maximum,
    "SECOND": lambda a, x: x,
    "FIRST": lambda a, x: a,
    "ANY": lambda a, x: x,
    "PAIR": lambda a, x: torch.ones_like(x),
    "LAND": lambda a, x: torch.logical_and(a != 0, x != 0),
    "LOR": lambda a, x: torch.logical_or(a != 0, x != 0),
    "LXOR": lambda a, x: torch.logical_xor(a != 0, x != 0),
    "EQ": lambda a, x: a == x,
    "NE": lambda a, x: a != x,
    "GT": lambda a, x: a > x,
    "LT": lambda a, x: a < x,
    "GE": lambda a, x: a >= x,
    "LE": lambda a, x: a <= x,
    # IS* return values of the operand type (reference semantics)
    "ISEQ": lambda a, x: (a == x).to(a.dtype),
    "ISNE": lambda a, x: (a != x).to(a.dtype),
    "ISGT": lambda a, x: (a > x).to(a.dtype),
    "ISLT": lambda a, x: (a < x).to(a.dtype),
    "ISGE": lambda a, x: (a >= x).to(a.dtype),
    "ISLE": lambda a, x: (a <= x).to(a.dtype),
    "BOR": lambda a, x: a | x,
    "BAND": lambda a, x: a & x,
    "BXOR": lambda a, x: a ^ x,
}

# positional muls: value = an index of the product term (reference
# FIRSTI/SECONDJ family); resolved in the tile SpMV with GLOBAL
# coordinates (local index + the rank's block offset)
_POS_MULS = ("FIRSTI", "FIRSTI1", "FIRSTJ", "FIRSTJ1",
             "SECONDI", "SECONDI1", "SECONDJ", "SECONDJ1")


def _extreme(dtype, high):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def _segment(reduce):
    """A segment fold over `num_segments` slots: "sum" through
    ``index_add_``, the others through ``scatter_reduce_`` from the
    fold's extreme, so that an empty segment holds the dtype's minimum
    (max) or maximum (min), as ``jax.ops.segment_max``/``segment_min``
    fill it (the bit folds' clip relies on it)."""
    def fold(d, s, num_segments):
        if reduce == "sum":
            return torch.zeros(num_segments, dtype=d.dtype,
                               device=d.device).index_add_(0, s, d)
        fill = {"amax": _extreme(d.dtype, False),
                "amin": _extreme(d.dtype, True), "prod": 1}[reduce]
        out = torch.full((num_segments,), fill, dtype=d.dtype,
                         device=d.device)
        return out.scatter_reduce_(0, s, d, reduce, include_self=True)
    return fold


_segment_sum = _segment("sum")
_segment_max = _segment("amax")
_segment_min = _segment("amin")
_segment_prod = _segment("prod")


def _bits(dtype):
    return torch.iinfo(dtype).bits


def _segment_bitfold(kind):
    """Bitwise segment folds (BOR/BAND/BXOR) by per-bit decomposition:
    bit b of the fold is a segment max / min / parity of bit b."""
    def fold(d, s, num_segments):
        out = torch.zeros(num_segments, dtype=d.dtype, device=d.device)
        for b in range(_bits(d.dtype)):
            db = (d >> b) & 1
            if kind == "BOR":
                yb = _segment_max(db, s, num_segments)
            elif kind == "BAND":
                yb = _segment_min(db, s, num_segments)
            else:  # BXOR: parity
                yb = _segment_sum(db, s, num_segments) & 1
            # clamp maps EMPTY-segment fill values (dtype min for max,
            # dtype max for min) onto the bit identities (0 / 1)
            out |= yb.clamp(0, 1) << b
        return out
    return fold


_ADDS = {
    "PLUS": _segment_sum,
    "MIN": _segment_min,
    "MAX": _segment_max,
    "ANY": _segment_max,   # ANY may return any contribution
    "TIMES": _segment_prod,
    "LOR": lambda d, s, num_segments: _segment_max(
        (d != 0).to(torch.int8), s, num_segments) > 0,
    "LAND": lambda d, s, num_segments: _segment_min(
        (d != 0).to(torch.int8), s, num_segments) > 0,
    "LXOR": lambda d, s, num_segments: (_segment_sum(
        (d != 0).to(torch.int32), s, num_segments) & 1) > 0,
    "BOR": _segment_bitfold("BOR"),
    "BAND": _segment_bitfold("BAND"),
    "BXOR": _segment_bitfold("BXOR"),
}

# dtypes NCCL cannot reduce or gather: widened to int32 for the
# collective (exact for MIN/MAX; the low bits of a SUM are the wrapped
# sum) and cast back
_NCCL_WIDEN = (torch.bool, torch.int16)


def _all_reduce(y, op, group):
    if y.dtype in _NCCL_WIDEN:
        z = y.to(torch.int32)
        dist.all_reduce(z, op=op, group=group)
        return z.to(y.dtype)
    y = y.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(y, group):
    """The group's blocks of `y`, stacked in group-rank order."""
    t = y.to(torch.int32) if y.dtype in _NCCL_WIDEN else y.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).to(y.dtype)


def _bitwise_coll(kind):
    """Bitwise cross-rank combines by a per-bit decomposition: one
    all_reduce (MAX, MIN or SUM) of every bit plane at once."""
    def coll(y, group):
        nb = _bits(y.dtype)
        shifts = torch.arange(nb, device=y.device).to(y.dtype)
        planes = ((y.unsqueeze(0) >> shifts.unsqueeze(1)) & 1).to(
            torch.int32)
        if kind == "BOR":
            planes = _all_reduce(planes, dist.ReduceOp.MAX, group)
        elif kind == "BAND":
            planes = _all_reduce(planes, dist.ReduceOp.MIN, group)
        else:  # BXOR
            planes = _all_reduce(planes, dist.ReduceOp.SUM, group) & 1
        out = torch.zeros_like(y)
        for b in range(nb):
            out |= planes[b].to(y.dtype) << b
        return out
    return coll


# cross-rank combines per add monoid: all_reduce where NCCL has the
# reduction, an all-gather + local fold for TIMES (exact integer
# products), per-bit planes for the bitwise adds
_COLLECTIVES = {
    "PLUS": lambda y, g: _all_reduce(y, dist.ReduceOp.SUM, g),
    "MIN": lambda y, g: _all_reduce(y, dist.ReduceOp.MIN, g),
    "MAX": lambda y, g: _all_reduce(y, dist.ReduceOp.MAX, g),
    "ANY": lambda y, g: _all_reduce(y, dist.ReduceOp.MAX, g),
    "LOR": lambda y, g: _all_reduce(y.to(torch.int8),
                                    dist.ReduceOp.MAX, g) > 0,
    "LAND": lambda y, g: _all_reduce(y.to(torch.int8),
                                     dist.ReduceOp.MIN, g) > 0,
    "LXOR": lambda y, g: (_all_reduce(y.to(torch.int32),
                                      dist.ReduceOp.SUM, g) & 1) > 0,
    "TIMES": lambda y, g: torch.prod(_all_gather(y, g), dim=0,
                                     dtype=y.dtype),
    "BOR": _bitwise_coll("BOR"),
    "BAND": _bitwise_coll("BAND"),
    "BXOR": _bitwise_coll("BXOR"),
}

# ANY as a mul means "either operand"; ANY as an add means "any one
# contribution".  For the masked-dot ring tier the mul table above is
# shared; adds are restricted to what _REDUCES supports there.


def resolve_ops(semiring):
    """(add_name, mul_name) of a Semiring restricted to the builtin
    distributed table; raises for unsupported algebras."""
    add = semiring.add_monoid.binaryop
    mul = semiring.mul_op
    if not (add.builtin and mul.builtin):
        raise NotImplementedError(
            f"distributed tier supports builtin semirings; "
            f"got {semiring.name}")
    if mul.positional:
        key, off = mul.positional
        name = {"i0": "FIRSTI", "j0": "FIRSTJ", "i1": "SECONDI",
                "j1": "SECONDJ"}[key] + ("1" if off else "")
        if add.op not in _ADDS:
            raise NotImplementedError(
                f"distributed op table has no add {add.op}")
        return add.op, name
    if add.op not in _ADDS or mul.op not in _MULS:
        raise NotImplementedError(
            f"distributed op table has no {add.op}_{mul.op}")
    return add.op, mul.op


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

_MESHES = {}


def _init_world_of_one(backend):
    """A process group of one rank over a FileStore in a temporary
    directory (no TCP port), for a plain script on one device; at exit
    the group (if still up) goes before its store's directory."""
    d = tempfile.mkdtemp(prefix="pygb_dist_")
    store = dist.FileStore(f"{d}/store", 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)

    def close():
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)

    atexit.register(close)


def make_mesh(n_devices=None, axis_names=("i", "j"), device=None):
    """Create a 2-D device mesh (as square as possible).

    Returns a ``torch.distributed.device_mesh.DeviceMesh`` of shape
    (pi, pj) over every rank of the default process group, with the
    dimension names `axis_names`; its flat rank order is the mesh's
    row-major order.  ``device=None`` means the CUDA card and NCCL (and
    raises where no card is present); ``device="cpu"`` means gloo.
    Without an initialised process group a world of one is initialised,
    so a plain script on one card runs on a (1, 1) mesh; several cards
    take ``torchrun --nproc-per-node N``, each process on its card.

    Unlike the JAX package, which takes the first `n_devices` devices,
    `n_devices` must equal the world size (ValueError otherwise): a rank
    is a process, and a mesh must hold every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = resolve_device(device).type
    if not dist.is_initialized():
        _init_world_of_one("nccl" if kind == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}) in a world of {world} ranks: a mesh "
            f"holds every rank (start {n_devices} processes instead)")
    pi = 1
    for f in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % f == 0:
            pi = f
            break
    pj = n_devices // pi
    key = (dist.group.WORLD, kind, pi, pj, tuple(axis_names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(kind, (pi, pj),
                                        mesh_dim_names=tuple(axis_names))
    return _MESHES[key]


def mesh_shape(mesh):
    """{dimension name: size}, as the JAX package's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _ring(mesh):
    """(P, p): the ring's length and this rank's place on it (the mesh's
    flat, row-major order, which must be the world's rank order)."""
    flat = mesh.mesh.reshape(-1).tolist()
    if flat != list(range(dist.get_world_size())):
        raise ValueError("the ring needs a mesh over every rank in rank "
                         "order (make_mesh builds one)")
    return len(flat), dist.get_rank()


def _ring_shift(tensors, p, Pn):
    """One ring step: send each tensor to rank (p + 1) mod P, receive
    its twin from (p - 1) mod P, in one batch.  At P == 1 there is no
    exchange (no send to self)."""
    if Pn == 1:
        return tensors
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), (p + 1) % Pn)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, (p - 1) % Pn) for r in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def frontier_all_to_all(mesh, idx, val, dest, cap):
    """Explicit hypersparse frontier packet exchange.

    Each rank owns up to `cap` frontier packets — (global index, value)
    pairs — each labeled with a destination rank (`dest`; -1 marks an
    empty slot).  ONE ``all_to_all_single`` over the mesh's flat ring
    routes every packet to its owner: packets are locally bucketed by
    destination (sort + rank-within-group, no host round trip), placed
    into per-destination slots of K = cap // P capacity, and exchanged.

    `idx`, `val`, `dest` are this rank's (cap,) packets, or the (P, cap)
    packets of every rank (this rank takes its row).  Returns this
    rank's (P, K) received (idx, val) — its block of the JAX package's
    (P, P, K) result — with idx == -1 in empty slots.

    Packets beyond a destination's K slots are dropped (callers size
    `cap` to the frontier bound); idx/val dtypes are preserved.
    """
    Pn, p = _ring(mesh)
    if cap % Pn:
        raise ValueError("cap must be a multiple of the device count")
    K = cap // Pn
    dev = _device(mesh)

    def mine(a):
        a = torch.as_tensor(a).to(dev)
        return a[p] if a.dim() == 2 else a

    idx, val, dest = mine(idx), mine(val), mine(dest)
    d = torch.where(dest < 0, Pn, dest).to(torch.int32)
    order = torch.argsort(d, stable=True)
    ds = d[order]
    ix = idx[order]
    vs = val[order]
    # rank within each destination group
    starts = torch.searchsorted(
        ds, torch.arange(Pn + 1, dtype=torch.int32, device=dev))
    within = (torch.arange(cap, device=dev)
              - starts[torch.clamp(ds, max=Pn).long()])
    slot = ds.long() * K + within
    valid = (ds < Pn) & (within < K)
    slot = torch.where(valid, slot, Pn * K)  # OOB -> dropped
    send_i = torch.full((Pn * K + 1,), -1, dtype=idx.dtype, device=dev)
    send_v = torch.zeros(Pn * K + 1, dtype=val.dtype, device=dev)
    send_i[slot] = ix
    send_v[slot] = vs
    recv_i = torch.empty(Pn * K, dtype=idx.dtype, device=dev)
    recv_v = torch.empty(Pn * K, dtype=val.dtype, device=dev)
    dist.all_to_all_single(recv_i, send_i[:Pn * K].contiguous())
    dist.all_to_all_single(recv_v, send_v[:Pn * K].contiguous())
    return recv_i.reshape(Pn, K), recv_v.reshape(Pn, K)


def _cdiv(a, b):
    return -(-a // b)


class DistSpMV:
    """2-D block-partitioned semiring SpMV executor.

    Parameters
    ----------
    mesh : DeviceMesh with dimensions ("i", "j")
    nrows, ncols : global logical dimensions
    rows, cols, vals : host COO triples (numpy; every rank passes the
        same)
    add, mul : builtin monoid / binary op names (static)

    ``spmv(x)`` takes the whole padded operand (ncols_p,) or a row
    block (rb,) of a vector in this executor's row space (a previous
    result, when nrows_p == ncols_p), and returns this rank's row block
    (rb,) of y, the same on every rank of its "j" group; ``gather``
    joins the blocks into the whole (nrows_p,) vector.
    """

    def __init__(self, mesh, nrows, ncols, rows, cols, vals,
                 add="PLUS", mul="TIMES", dtype=np.float32,
                 semiring=None):
        t0 = time.perf_counter()
        self.mesh = mesh
        if semiring is not None:
            add, mul = resolve_ops(semiring)
        self.add = add
        self.mul = mul
        _check_ops(dtype, add, mul)
        shape = mesh_shape(mesh)
        pi, pj = shape["i"], shape["j"]
        self.pi, self.pj = pi, pj
        self.ri = mesh.get_local_rank("i")
        self.rj = mesh.get_local_rank("j")
        self.rb = _cdiv(nrows, pi)
        self.cb = _cdiv(ncols, pj)
        self.nrows_p = self.rb * pi
        self.ncols_p = self.cb * pj
        self.dtype = np.dtype(dtype)
        self.device = _device(mesh)
        self.group_i = mesh.get_group("i")
        self.group_j = mesh.get_group("j")

        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        bi = rows // self.rb
        bj = cols // self.cb
        tile = bi * pj + bj
        counts = np.bincount(tile, minlength=pi * pj)
        E = max(int(counts.max()), 1)
        self.tile_nnz = E

        # this rank's tile: its edges sorted by row (in input order
        # within a row; the stable sort runs on the device), padded to
        # the largest tile's count with the sentinel row rb
        mine = np.flatnonzero(tile == self.ri * pj + self.rj)
        m = len(mine)
        dev = self.device
        rows_m = torch.from_numpy(rows[mine] - self.ri * self.rb).to(dev)
        order = torch.argsort(rows_m, stable=True)
        self.rows_l = torch.full((E,), self.rb, dtype=torch.int64,
                                 device=dev)
        self.cols_l = torch.zeros(E, dtype=torch.int64, device=dev)
        self.vals_l = torch.zeros(E, dtype=_work(self.dtype), device=dev)
        self.rows_l[:m] = rows_m[order]
        self.cols_l[:m] = torch.from_numpy(
            cols[mine] - self.rj * self.cb).to(dev)[order]
        self.vals_l[:m] = _to_work(np.asarray(vals)[mine], self.dtype,
                                   dev)[order]

        # rows with at least one contribution: the output pattern of a
        # GraphBLAS mxv only contains such rows
        self.row_present_host = np.zeros(self.nrows_p, bool)
        self.row_present_host[rows] = True

        self.tile_bytes = _nbytes(self.rows_l, self.cols_l, self.vals_l)
        held_bytes["tiles"] += self.tile_bytes
        self._fold = _ADDS[add]
        self._comb = _COLLECTIVES[add]
        # floating-point PLUS and TIMES fold each row in order, so that
        # they do not depend on the order of atomic adds on a card
        self._seg = ({"PLUS": "sum", "TIMES": "prod"}.get(add)
                     if self.vals_l.dtype.is_floating_point else None)
        if self._seg:
            self._offsets = torch.searchsorted(
                self.rows_l[:m], torch.arange(self.rb + 1, device=dev))
        self._mul = None if mul in _POS_MULS else _MULS[mul]
        seconds["tiling"] += time.perf_counter() - t0

    def _operand(self, x):
        """This rank's column block of the operand, in the work dtype."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.device)
        else:
            x = _to_work(x, self.dtype, self.device)
        if x.numel() == self.ncols_p:
            full = x
        elif x.numel() == self.rb and self.nrows_p == self.ncols_p:
            full = self.gather(x)
        else:
            raise DimensionMismatch(
                f"operand of {x.numel()} values: want {self.ncols_p} or a "
                f"row block of {self.rb}")
        lo = self.rj * self.cb
        return full[lo:lo + self.cb].to(self.vals_l.dtype)

    def gather(self, y):
        """The whole (nrows_p,) vector of the row blocks `y` (a
        collective over the "i" group: every rank calls it)."""
        return _all_gather(y, self.group_i).reshape(-1)

    def to_numpy(self, y):
        """A result tensor -> host numpy values of this executor's
        dtype."""
        return _to_host(y, self.dtype)

    def __call__(self, x):
        xb = self._operand(x)
        xg = xb[self.cols_l]
        v = self.vals_l
        if self._mul is None:
            # positional semirings: the product is an index of the
            # term; GLOBAL coordinates = local + the rank's block offset,
            # so results are partitioning-invariant
            gi = self.rows_l.to(v.dtype) + self.ri * self.rb
            gj = self.cols_l.to(v.dtype) + self.rj * self.cb
            name = self.mul.rstrip("1")
            base = torch.zeros_like(gj) if name == "SECONDJ" else \
                {"FIRSTI": gi, "FIRSTJ": gj, "SECONDI": gj}[name]
            prod = base + (1 if self.mul.endswith("1") else 0)
        else:
            prod = self._mul(v, xg)
        if prod.dtype != v.dtype:  # boolean muls (EQ/GT/...)
            prod = prod.to(v.dtype)
        if self._seg:
            y = torch.segment_reduce(prod, self._seg,
                                     offsets=self._offsets, unsafe=True)
        else:
            y = self._fold(prod, self.rows_l, self.rb + 1)[:self.rb]
        return self._comb(y, self.group_j)


def dist_pagerank_step(spmv, r, d_inv_damped, teleport):
    """One distributed PageRank iteration.

    r, d_inv_damped are this rank's row blocks of dense vectors of size
    nrows_p; `spmv` must be built on the TRANSPOSED adjacency with
    mul="SECOND".  Returns (new ranks, L1 residual), the residual the
    same 0-d tensor on every rank."""
    w = r * d_inv_damped
    contrib = spmv(w)
    r_new = teleport + contrib
    rdiff = _all_reduce(torch.sum(torch.abs(r_new - r)).reshape(1),
                        dist.ReduceOp.SUM, spmv.group_i)[0]
    return r_new, rdiff


def dist_pagerank(mesh, nrows, rows, cols, damping=0.85, itermax=100,
                  tol=1e-4, dtype=np.float32, checkpoint_path=None,
                  checkpoint_every=10, balance=True):
    """End-to-end distributed PageRank over the mesh (GAP formulation,
    matching ``algorithms.pagerank``).

    ``balance`` relabels vertices by a fixed random permutation before
    partitioning: power-law hubs otherwise concentrate in one tile and
    the padded-tile executor degrades to the max-tile load.

    With ``checkpoint_path`` the rank vector snapshots atomically every
    ``checkpoint_every`` iterations and a restart resumes
    deterministically from the last snapshot (failure-recovery tier,
    parallel/checkpoint.py; the JAX package's snapshots resume here and
    this one's there)."""
    t0 = time.perf_counter()
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rank = None
    if balance:
        rank = np.random.RandomState(0x5EED).permutation(nrows)
        rows, cols = rank[rows], rank[cols]
    deg = np.bincount(rows, minlength=nrows).astype(dtype)
    seconds["balance"] += time.perf_counter() - t0
    # pad the square dimension so both mesh dimensions divide it evenly
    # (the rank vector is alternately row- and column-blocked)
    shape = mesh_shape(mesh)
    N = _cdiv(nrows, shape["i"] * shape["j"]) * shape["i"] * shape["j"]
    spmv = DistSpMV(mesh, N, N, cols, rows,  # transposed
                    np.ones(len(rows), dtype), add="PLUS", mul="SECOND",
                    dtype=dtype)
    t0 = time.perf_counter()
    n_p = spmv.nrows_p
    lo, hi = spmv.ri * spmv.rb, (spmv.ri + 1) * spmv.rb
    deg_p = np.zeros(n_p, dtype)
    deg_p[:nrows] = deg
    with np.errstate(divide="ignore"):
        d_inv = np.where(deg_p > 0, damping / np.maximum(deg_p, 1), 0.0)
    d_inv = torch.from_numpy(d_inv.astype(dtype)[lo:hi]).to(spmv.device)
    r = torch.full((spmv.rb,), 1.0 / nrows, dtype=d_inv.dtype,
                   device=spmv.device)
    teleport = float(np.asarray((1.0 - damping) / nrows, dtype))

    start = 0
    if checkpoint_path:
        from .checkpoint import load_state, save_state

        sig = f"pagerank:{nrows}:{len(rows)}:{damping}:{tol}:{int(balance)}"
        resumed = load_state(checkpoint_path, sig)
        if resumed is not None:
            start, st = resumed
            r = torch.from_numpy(
                np.ascontiguousarray(st["r"].astype(dtype)[lo:hi])).to(
                    spmv.device)
    for it in range(start, itermax):
        r, rdiff = dist_pagerank_step(spmv, r, d_inv, teleport)
        if checkpoint_path and ((it + 1) % checkpoint_every == 0):
            save_state(checkpoint_path, sig, it + 1,
                       r=spmv.to_numpy(spmv.gather(r)))
        if float(rdiff) <= tol:
            break
    out = spmv.to_numpy(spmv.gather(r))
    seconds["device"] += time.perf_counter() - t0
    return out[rank] if rank is not None else out[:nrows]


# ---------------------------------------------------------------------------
# distributed masked SpGEMM: triangle counting
# ---------------------------------------------------------------------------


_TC_WIDTH_CAP = 8192

# keys sorted in one torch.sort call of the ring's intersections: a
# bucket's rows are cut into chunks of at most this many keys.  About
# 40 bytes a key are live during a chunk (the int64 gathers of both
# sides, the int32 keys, the sorted keys and their int64 order), so a
# chunk of 2^24 keys holds under 1 GiB, about 1% of an H100's 80 GB,
# while a chunk of the widest bucket (8192) still has 2048 rows.
_SORT_CHUNK_KEYS = 1 << 24


def _bucket_rows(desc_cnt, w):
    """Row ranges [lo, hi) of one (round, bucket) under the chunk cap."""
    step = max(1, _SORT_CHUNK_KEYS // w)
    return [(lo, min(lo + step, desc_cnt)) for lo in range(0, desc_cnt, step)]


def _ring_keys(colsL, buf, a0, wav, b0, wbv, w):
    """The (rows, w) sort keys of rows of a bucket: A's slice (even
    keys), B's slice from the in-flight buffer (odd keys), distinct
    sentinels in the rest."""
    lane = torch.arange(w, dtype=torch.int64, device=colsL.device)[None, :]
    wav, wbv = wav[:, None], wbv[:, None]
    in_a = lane < wav
    in_b = (lane >= wav) & (lane < wav + wbv)
    sa = torch.clamp(a0[:, None] + lane, 0, colsL.shape[0] - 1)
    sb = torch.clamp(b0[:, None] + lane - wav, 0, buf.shape[0] - 1)
    sent = 1 << 30
    keys = torch.where(in_a, colsL[sa] * 2,
                       torch.where(in_b, buf[sb] * 2 + 1,
                                   (sent + 2 * lane).to(torch.int32)))
    return keys, in_a, in_b, sa, sb


def _descriptors(Pn, p, light, widths_p2, pdev, rnd, fields, dev,
                 with_map=False):
    """Per width bucket: this rank's (P, E_w) descriptor tensors (a
    start, a width, b start, b width), the real rows of each round, and
    (with_map) every rank's (P, P, E_w) edge ids, -1 in padding."""
    menu = sorted(set(widths_p2[light].tolist()))
    a_st, wa, b_st, wb = fields
    out = []
    for w in menu:
        sel = light & (widths_p2 == w)
        cnt_pr = np.zeros((Pn, Pn), np.int64)
        np.add.at(cnt_pr, (pdev[sel], rnd[sel]), 1)
        # pad the per-round edge count to a power of two, as the JAX
        # package's static-shape descriptors
        E_w = 1 << max(int(cnt_pr.max()) - 1, 0).bit_length()
        ids = np.nonzero(sel)[0]
        key = pdev[ids] * Pn + rnd[ids]
        o = np.argsort(key, kind="stable")
        ids, key = ids[o], key[o]
        kstart = np.concatenate(
            [[0], np.cumsum(np.bincount(key, minlength=Pn * Pn))[:-1]])
        within = np.arange(len(ids)) - kstart[key]
        pp, rr = key // Pn, key % Pn
        emap = None
        if with_map:
            emap = np.full((Pn, Pn, E_w), -1, np.int64)
            emap[pp, rr, within] = ids
        m = pp == p
        d = []
        for f in (a_st, wa, b_st, wb):
            arr = np.zeros((Pn, E_w), np.int64)
            arr[rr[m], within[m]] = f[ids[m]]
            d.append(torch.from_numpy(arr).to(dev))
        out.append((int(w), d, cnt_pr[p], emap))
    return out


def dist_triangle_count(mesh, nrows, rows, cols):
    """Distributed SPARSE triangle count: total = Σ_{(i,j)∈L} |L_i ∩ L_j|
    with L the degree-ordered strict lower triangle, block-ROW
    partitioned over a 1-D ring of the mesh's ranks.

    Memory is O(nnz/P) per device — no dense blocks, no n² anywhere, so
    graph size is bounded by aggregate device memory, not by a cell
    budget.

    Per round r of the P-round ring (one ``batch_isend_irecv`` of the
    in-flight block to the next rank):

      * rank p holds its own block's CSR plus block q = (p − r) mod P
        in flight;
      * the mask edges (i, j) with owner(j) == q run the sorted-concat
        intersection (the single-chip masked-SpGEMM bucket formulation,
        core/spgemm.py): sort the concatenated adjacency slices of each
        edge, count adjacent duplicates;
      * edge descriptors (starts/widths into the local and in-flight
        buffers) are precomputed host-side per (rank, round, width
        bucket).

    Edges whose combined width exceeds the cap are counted host-side
    (rare under degree ordering), exactly like the single-chip path.
    """
    if nrows >= 1 << 29:
        raise NotImplementedError(
            "dist_triangle_count packs vertex ids into int32 sort keys; "
            "nrows must be < 2^29")
    t0 = time.perf_counter()
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    # degree-order relabel (GAP optimization — bounds per-edge work)
    deg = np.bincount(rows, minlength=nrows)
    perm = np.argsort(deg, kind="stable")
    rank = np.empty_like(perm)
    rank[perm] = np.arange(nrows)
    rows, cols = rank[rows], rank[cols]
    lower = rows > cols
    rows, cols = rows[lower], cols[lower]
    order = np.argsort(rows * nrows + cols, kind="stable")
    rows, cols = rows[order], cols[order]

    Pn, p = _ring(mesh)
    dev = _device(mesh)
    rb = _cdiv(nrows, Pn)

    # per-block CSR: cols packed per block, (st, dg) per local row
    bi = (rows // rb).astype(np.int64)
    bcounts = np.bincount(bi, minlength=Pn)
    Bmax = max(int(bcounts.max()), 1)
    bstart = np.concatenate([[0], np.cumsum(bcounts)[:-1]])
    st = np.zeros(nrows, np.int64)
    dg = np.zeros(nrows, np.int64)
    u, s_idx, d_cnt = np.unique(rows, return_index=True,
                                return_counts=True)
    st[u] = s_idx - bstart[bi[s_idx]]     # block-local start
    dg[u] = d_cnt

    # mask edges: every (i, j) of L; intersect row i (local) row j (ring)
    wa = dg[rows]
    wb = dg[cols]
    a_st = st[rows]
    b_st = st[cols]
    pdev = bi                               # owning rank = owner(i)
    qblk = cols // rb                       # provider block = owner(j)
    rnd = (pdev - qblk) % Pn                # ring round when q is in flight
    width = wa + wb

    heavy = width > _TC_WIDTH_CAP
    host_cnt = 0
    if heavy.any():
        burble("dist_tc: %d heavy edges via host intersect",
               int(heavy.sum()))
        for e in np.nonzero(heavy)[0]:
            ga = bstart[pdev[e]] + a_st[e]
            gb = bstart[qblk[e]] + b_st[e]
            host_cnt += len(np.intersect1d(
                cols[ga:ga + wa[e]], cols[gb:gb + wb[e]],
                assume_unique=True))

    light = ~heavy
    widths_p2 = np.maximum(8, 2 ** np.ceil(
        np.log2(np.maximum(width, 1))).astype(np.int64))
    desc = _descriptors(Pn, p, light, widths_p2, pdev, rnd,
                        (a_st, wa, b_st, wb), dev)
    mine = bi == p
    cols_b = np.zeros(Bmax, np.int32)
    cols_b[:int(mine.sum())] = cols[mine]
    seconds["ring_host"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    colsL = torch.from_numpy(cols_b).to(dev)
    held_bytes["ring"] += _nbytes(colsL, *(t for _, d, _, _ in desc
                                           for t in d))
    buf = colsL
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(Pn):
        for w, (ast, awa, bst2, bwb), n_real, _ in desc:
            for lo, hi in _bucket_rows(int(n_real[r]), w):
                keys = _ring_keys(colsL, buf, ast[r, lo:hi], awa[r, lo:hi],
                                  bst2[r, lo:hi], bwb[r, lo:hi], w)[0]
                ks = torch.sort(keys, dim=1).values
                cnt += ((ks[:, :-1] >> 1) == (ks[:, 1:] >> 1)).sum()
        if r + 1 < Pn:
            buf, = _ring_shift([buf], p, Pn)
    dev_cnt = int(_all_reduce(cnt.reshape(1), dist.ReduceOp.SUM, None)[0])
    seconds["device"] += time.perf_counter() - t0
    return dev_cnt + host_cnt


def dist_masked_spgemm(mesh, nrows_a, ncols_a, ncols_b,
                       ra, ca, va, rb, cb, vb, mr, mc,
                       add="PLUS", mul="TIMES", dtype=np.float32):
    """Distributed masked semiring SpGEMM: values of ``C<M> = A (+.x) B``
    at the mask's positions, block-ROW partitioned over a 1-D ring of
    the mesh's ranks (the general-values form of
    :func:`dist_triangle_count`'s ring).

    Per mask entry (i, j), the dot product ``add_k mul(A[i,k], B[k,j])``
    runs as a sorted-concat intersection of A's row i (rank-local) with
    B^T's row j (circulated around the ring, one ``batch_isend_irecv`` a
    round).  Memory is O(nnz/P) per device; edge descriptors are
    width-bucket tensors exactly as in the triangle ring.

    Returns ``(vals, present)`` aligned with the (mr, mc) mask order,
    the same on every rank: ``present[e]`` is False when the dot product
    had no terms (the GraphBLAS output pattern rule), in which case
    ``vals[e]`` is the add identity and must be dropped by the caller.
    """
    iparts = max(nrows_a, ncols_a, ncols_b)
    if iparts >= 1 << 29:
        raise NotImplementedError(
            "dist_masked_spgemm packs ids into int32 sort keys; "
            "dimensions must be < 2^29")
    if add not in _REDUCES or mul not in _MULS:
        raise NotImplementedError(f"no distributed {add}_{mul}")
    _check_ops(dtype, add, mul)
    t0 = time.perf_counter()
    reduce_fn, ident = _REDUCES[add]
    mul_fn = _MULS[mul]
    dtype = np.dtype(dtype)
    ident = dtype.type(ident(dtype))

    ra = np.asarray(ra, np.int64)
    ca = np.asarray(ca, np.int64)
    va = np.asarray(va, dtype)
    # B^T: rows indexed by B's column id, payload = (B row id, value)
    rbt = np.asarray(cb, np.int64)
    cbt = np.asarray(rb, np.int64)
    vbt = np.asarray(vb, dtype)
    mr = np.asarray(mr, np.int64)
    mc = np.asarray(mc, np.int64)

    Pn, p = _ring(mesh)
    dev = _device(mesh)
    rb_a = _cdiv(max(nrows_a, 1), Pn)
    rb_b = _cdiv(max(ncols_b, 1), Pn)
    ranks = tuple(mesh.mesh.reshape(-1).tolist())

    def block_csr(rows_, cols_, vals_, n_ids, blk):
        """(cols_buf, vals_buf, st, dg, cols_dev, vals_dev): per-rank
        packed row slices, host + this rank's block on its device,
        content-cached so a second call over the same operand skips the
        argsort/bincount/unique host pass AND the device transfer."""
        key = ("bcsr", _content_key(rows_, cols_, vals_),
               n_ids, blk, Pn, ranks, p, str(dev), dtype.str, repr(ident))
        hit = _ring_cache_get(key)
        if hit is not None:
            return hit
        _STATS["block_csr_builds"] += 1
        order = np.argsort(rows_, kind="stable")
        rows_, cols_, vals_ = rows_[order], cols_[order], vals_[order]
        bi = rows_ // blk
        bcounts = np.bincount(bi, minlength=Pn)
        Bmax = max(int(bcounts.max()), 1)
        bstart = np.concatenate([[0], np.cumsum(bcounts)[:-1]])
        pos = np.arange(len(rows_)) - bstart[bi]
        cols_buf = np.zeros((Pn, Bmax), np.int32)
        vals_buf = np.full((Pn, Bmax), ident, dtype)
        cols_buf[bi, pos] = cols_.astype(np.int32)
        vals_buf[bi, pos] = vals_
        st = np.zeros(n_ids, np.int64)
        dg = np.zeros(n_ids, np.int64)
        u, s_idx, d_cnt = np.unique(rows_, return_index=True,
                                    return_counts=True)
        st[u] = s_idx - bstart[bi[s_idx]]
        dg[u] = d_cnt
        out = (cols_buf, vals_buf, st, dg,
               torch.from_numpy(cols_buf[p]).to(dev),
               _to_work(vals_buf[p], dtype, dev))
        held_bytes["ring"] += _nbytes(*out[4:])
        _ring_cache_put(key, out)
        return out

    colsA, valsA, st_a, dg_a, colsA_d, valsA_d = block_csr(
        ra, ca, va, nrows_a, rb_a)
    colsB, valsB, st_b, dg_b, colsB_d, valsB_d = block_csr(
        rbt, cbt, vbt, ncols_b, rb_b)

    n_edges = len(mr)
    out_vals = np.full(n_edges, ident, dtype)
    out_cnt = np.zeros(n_edges, np.int64)
    wa = dg_a[mr]
    wb = dg_b[mc]
    live = (wa > 0) & (wb > 0)
    a_st = st_a[mr]
    b_st = st_b[mc]
    pdev = mr // rb_a
    qblk = mc // rb_b
    rnd = (pdev - qblk) % Pn
    width = wa + wb

    heavy = live & (width > _TC_WIDTH_CAP)
    if heavy.any():
        burble("dist_spgemm: %d heavy edges via host intersect",
               int(heavy.sum()))
        # host CSR views (cols within a row are NOT sorted here; use
        # searchsorted on the sorted a-slice)
        for e in np.nonzero(heavy)[0]:
            ka = colsA[pdev[e]][a_st[e]:a_st[e] + wa[e]]
            va_e = valsA[pdev[e]][a_st[e]:a_st[e] + wa[e]]
            kb = colsB[qblk[e]][b_st[e]:b_st[e] + wb[e]]
            vb_e = valsB[qblk[e]][b_st[e]:b_st[e] + wb[e]]
            o = np.argsort(ka, kind="stable")
            ka, va_e = ka[o], va_e[o]
            pos = np.searchsorted(ka, kb)
            posc = np.minimum(pos, len(ka) - 1)
            hit = ka[posc] == kb
            if hit.any():
                prods = _to_host(mul_fn(
                    _to_work(va_e[posc[hit]], dtype, "cpu"),
                    _to_work(vb_e[hit], dtype, "cpu")), dtype)
                out_vals[e] = _host_reduce(add, prods, dtype)
                out_cnt[e] = int(hit.sum())

    light = live & ~heavy
    widths_p2 = np.maximum(8, 2 ** np.ceil(
        np.log2(np.maximum(width, 1))).astype(np.int64))
    desc = _descriptors(Pn, p, light, widths_p2, pdev, rnd,
                        (a_st, wa, b_st, wb), dev, with_map=True)
    held_bytes["ring"] += _nbytes(*(t for _, d, _, _ in desc for t in d))
    seconds["ring_host"] += time.perf_counter() - t0

    if desc:
        t0 = time.perf_counter()
        work = valsA_d.dtype
        identj = _to_work(np.asarray([ident], dtype), dtype, dev)[0]
        outs = [torch.full((Pn, d[0].shape[1]), identj.item(), dtype=work,
                           device=dev) for _, d, _, _ in desc]
        cnts = [torch.zeros((Pn, d[0].shape[1]), dtype=torch.int32,
                            device=dev) for _, d, _, _ in desc]
        cbuf, vbuf = colsB_d, valsB_d
        for r in range(Pn):
            for k, (w, (ast, awa, bst2, bwb), n_real, _) in enumerate(desc):
                for lo, hi in _bucket_rows(int(n_real[r]), w):
                    keys, in_a, in_b, sa, sb = _ring_keys(
                        colsA_d, cbuf, ast[r, lo:hi], awa[r, lo:hi],
                        bst2[r, lo:hi], bwb[r, lo:hi], w)
                    lvals = torch.where(
                        in_a, valsA_d[sa],
                        torch.where(in_b, vbuf[sb], identj))
                    ks, order = torch.sort(keys, dim=1)
                    vs = torch.gather(lvals, 1, order)
                    match = (ks[:, :-1] >> 1) == (ks[:, 1:] >> 1)
                    prods = torch.where(
                        match, mul_fn(vs[:, :-1], vs[:, 1:]).to(work), identj)
                    outs[k][r, lo:hi] = reduce_fn(prods).to(work)
                    cnts[k][r, lo:hi] = match.sum(dim=1, dtype=torch.int32)
            if r + 1 < Pn:
                cbuf, vbuf = _ring_shift([cbuf, vbuf], p, Pn)
        # every rank's outputs, so that every rank returns the whole
        # result
        all_v = _all_gather(torch.cat([o.reshape(-1) for o in outs]), None)
        all_c = _all_gather(torch.cat([c.reshape(-1) for c in cnts]), None)
        all_v = _to_host(all_v, dtype)
        all_c = all_c.cpu().numpy()
        seconds["device"] += time.perf_counter() - t0
        off = 0
        for (w, d, _, emap), o in zip(desc, outs):
            size = o.numel()
            ov = all_v[:, off:off + size].reshape(Pn, Pn, -1)
            oc = all_c[:, off:off + size].reshape(Pn, Pn, -1)
            off += size
            valid = emap >= 0
            out_vals[emap[valid]] = ov[valid]
            out_cnt[emap[valid]] = oc[valid]

    return out_vals, out_cnt > 0


def _host_reduce(add, arr, dtype):
    if add == "PLUS":
        return dtype.type(arr.sum())
    if add == "MIN":
        return dtype.type(arr.min())
    if add == "MAX":
        return dtype.type(arr.max())
    if add == "TIMES":
        return dtype.type(arr.prod())
    if add == "LOR":
        return dtype.type((arr != 0).any())
    if add == "LAND":
        return dtype.type((arr != 0).all())
    raise NotImplementedError(add)


# per-add-monoid lanewise reducers + identities for the masked-SpGEMM
# dot products (identity is a function of dtype: MIN/MAX need the
# dtype's own extremes so integer semirings stay exact)
_REDUCES = {
    "PLUS": (lambda a: torch.sum(a, dim=1), lambda dt: 0),
    "MIN": (lambda a: torch.amin(a, dim=1), lambda dt: np.inf
            if dt.kind == "f" else np.iinfo(dt).max),
    "MAX": (lambda a: torch.amax(a, dim=1), lambda dt: -np.inf
            if dt.kind == "f" else np.iinfo(dt).min),
    "TIMES": (lambda a: torch.prod(a, dim=1), lambda dt: 1),
    "LOR": (lambda a: torch.amax(a, dim=1), lambda dt: 0),
    "LAND": (lambda a: torch.amin(a, dim=1), lambda dt: 1),
}


# ---------------------------------------------------------------------------
# Matrix API integration: Matrix.shard(mesh) -> DistMatrix / DistVector
# ---------------------------------------------------------------------------


def _block(mesh, spec, n_p):
    """(lo, hi) of this rank's block of a padded (n_p,) vector laid out
    by `spec`: "i" (row blocks over the "i" dimension, the same on each
    rank of a "j" group), "j" (column blocks), or None (every rank holds
    the whole vector)."""
    if spec is None:
        return 0, n_p
    size = mesh_shape(mesh)[spec]
    if n_p % size:
        raise ValueError(f"{n_p} slots do not split over {size} ranks")
    k = n_p // size
    c = mesh.get_local_rank(spec)
    return c * k, (c + 1) * k


class DistVector:
    """A dense vector sharded over the mesh — the device-resident
    iteration state for distributed loops.  ``DistMatrix.mxv`` both
    accepts and returns DistVectors, so multi-step algorithms chain on
    device with only the collectives the executors make.

    `data` is this rank's block of a padded (n_p,) vector (the work
    dtype of `typ`) laid out by `spec` ("i": row blocks, "j": column
    blocks, None: the whole vector on every rank); `n` is the logical
    length.  Elementwise helpers (`ewise`, `apply`) run on the blocks."""

    def __init__(self, mesh, n, data, spec, typ, rank=None):
        self.mesh = mesh
        self.n = n
        self.data = data
        self.spec = spec
        self.type = typ
        # rank: logical id -> balanced (permuted) slot, when the owning
        # DistMatrix load-balances hub rows across tiles
        self.rank = rank

    @staticmethod
    def dense(mesh, n, n_p, fill, typ, spec, rank=None):
        lo, hi = _block(mesh, spec, n_p)
        dt = np.dtype(typ._numpy_t)
        arr = _to_work(np.full(hi - lo, fill, dt), dt, _device(mesh))
        return DistVector(mesh, n, arr, spec, typ, rank)

    def _whole(self):
        """The whole padded vector (a collective for a blocked spec)."""
        if self.spec is None:
            return self.data
        return _all_gather(self.data,
                           self.mesh.get_group(self.spec)).reshape(-1)

    def to_numpy(self):
        d = _to_host(self._whole(), self.type._numpy_t)
        return d[self.rank] if self.rank is not None else d[:self.n]

    def to_vector(self, pattern=None):
        """Materialize as a host Vector; `pattern` (bool mask over the
        logical range) restricts the output pattern."""
        from ..vector import Vector

        y = self.to_numpy()
        out = Vector.sparse(self.type, self.n, device=_device(self.mesh))
        if pattern is None:
            ids = np.arange(self.n, dtype=np.int64)
            out._build(ids, y)
        else:
            ids = np.nonzero(pattern[:self.n])[0].astype(np.int64)
            out._build(ids, y[pattern[:self.n]])
        return out

    def ewise(self, other, op=lambda a, b: a + b):
        """Elementwise combine with another DistVector of the same layout
        (runs on the device blocks)."""
        if isinstance(op, str):
            op = _MULS[op]
        return DistVector(self.mesh, self.n, op(self.data, other.data),
                          self.spec, self.type, self.rank)

    # distributed eadd: dense-resident vectors make add and mult the
    # same elementwise combine
    eadd = ewise
    emult = ewise

    def apply(self, op):
        """Elementwise unary apply on the sharded data (op: callable or
        a builtin unary name like "AINV"/"ABS"/"MINV"/"LNOT").

        GAP-style pipelines stay mesh-resident: no host round trip."""
        table = {
            "IDENTITY": lambda a: a,
            "AINV": lambda a: -a,
            "ABS": torch.abs,
            "MINV": lambda a: 1 / a,
            "LNOT": lambda a: (a == 0).to(a.dtype),
            "ONE": torch.ones_like,
        }
        fn = table[op] if isinstance(op, str) else op
        return DistVector(self.mesh, self.n, fn(self.data), self.spec,
                          self.type, self.rank)

    def reduce(self, add="PLUS"):
        """Full reduction under a builtin add monoid; returns a Python
        scalar.  Padded slots hold the fill value, so MIN/MAX/PLUS on
        padded tails are only safe when fill is the monoid identity —
        reduce over the logical prefix instead."""
        y = self.to_numpy()
        fns = {"PLUS": np.sum, "MIN": np.min, "MAX": np.max,
               "TIMES": np.prod,
               "LOR": lambda a: bool((a != 0).any()),
               "LAND": lambda a: bool((a != 0).all()),
               "BOR": np.bitwise_or.reduce,
               "BAND": np.bitwise_and.reduce,
               "BXOR": np.bitwise_xor.reduce}
        return self.type._to_value(fns[add](y))

    def reduce_float(self):
        """The sum of every slot, padded ones included, as a float."""
        s = torch.sum(self.data).reshape(1)
        if self.spec is not None:
            s = _all_reduce(s, dist.ReduceOp.SUM,
                            self.mesh.get_group(self.spec))
        return float(s[0])


class DistMatrix:
    """A Matrix sharded over a device mesh (``Matrix.shard(mesh)``).

    The distributed tier as part of the library: semiring ``mxv`` over
    2-D block tiles, distributed PageRank, BFS, SSSP, triangle counting,
    k-truss and masked ``mxm``, all returning ordinary host-side
    containers (the same on every rank).  SpMV executors are built once
    per (semiring, dtype) and cached.
    """

    def __init__(self, matrix, mesh, balance=True):
        t0 = time.perf_counter()
        self.mesh = mesh
        self.device = _device(mesh)
        self.nrows = matrix.nrows
        self.ncols = matrix.ncols
        self.type = matrix.type
        r, c, v = matrix._coo()
        self._rank = None
        if balance and self.nrows == self.ncols and self.nrows > 1:
            # hub load-balancing: fixed random relabel; outputs map back
            self._rank = np.random.RandomState(0x5EED).permutation(
                self.nrows)
            r, c = self._rank[r], self._rank[c]
        self._rows, self._cols, self._vals = r, c, v
        self._spmv_cache = {}
        seconds["balance"] += time.perf_counter() - t0

    def _executor(self, semiring, dtype, transpose):
        add, mul = resolve_ops(semiring)
        return self._ops_executor(add, mul, dtype, transpose)

    def _ops_executor(self, add, mul, dtype, transpose):
        key = (add, mul, np.dtype(dtype).str, transpose)
        if key not in self._spmv_cache:
            r, c = ((self._cols, self._rows) if transpose
                    else (self._rows, self._cols))
            nr, nc = ((self.ncols, self.nrows) if transpose
                      else (self.nrows, self.ncols))
            if nr == nc:
                # square: pad both dims to a common lcm multiple so the
                # row-block output of one mxv is shape-compatible as the
                # operand of the next (DistVector chaining)
                shape = mesh_shape(self.mesh)
                ll = math.lcm(shape["i"], shape["j"])
                nr = nc = _cdiv(nr, ll) * ll
            self._spmv_cache[key] = DistSpMV(
                self.mesh, nr, nc, r, c, self._vals.astype(dtype),
                dtype=dtype, add=add, mul=mul)
        return self._spmv_cache[key]

    def _to_padded(self, arr, npad, dt):
        """host array in logical ids -> padded balanced layout"""
        a = np.asarray(arr, dt)
        p = np.zeros(npad, dt)
        if self._rank is not None and len(a) == self.nrows:
            p[self._rank] = a
        else:
            p[:len(a)] = a
        return p

    def _row_block(self, ex, arr, dt):
        """this rank's row block of a host array over the output range"""
        lo = ex.ri * ex.rb
        return _to_work(self._to_padded(arr, ex.nrows_p, dt)[lo:lo + ex.rb],
                        dt, self.device)

    def mxv(self, x, semiring=None, transpose=False, mask=None,
            accum=None, out=None, out_dist=False):
        """Distributed semiring matrix-vector product.

        `x` may be a Vector, a numpy array, or a :class:`DistVector`
        (device-resident: no host transfer on input).  With
        ``out_dist=True`` (implied when `x` is a DistVector) the result
        stays sharded on device as a DistVector, so iteration loops
        chain without host round-trips.

        `mask` (DistVector / bool numpy over the output range) keeps
        masked-out lanes from `out` (or the add identity); `accum`
        (builtin BinaryOp or name) combines into `out` where both are
        present — the dense-segment analog of ``C<M> += A@x``.
        """
        from ..vector import Vector

        if semiring is None:
            semiring = self.type._default_semiring()
        dtype = np.dtype(semiring.ztype._numpy_t)
        ex = self._executor(semiring, dtype, transpose)
        t0 = time.perf_counter()
        if isinstance(x, DistVector):
            xd = x.data
            out_dist = True
        else:
            xv = x.to_numpy() if isinstance(x, Vector) else x
            xd = _to_work(self._to_padded(xv, ex.ncols_p, dtype), dtype,
                          self.device)
        yd = ex(xd)

        if accum is not None and out is not None:
            op = accum if isinstance(accum, str) else accum.op
            fn = _MULS[op]
            od = (out.data if isinstance(out, DistVector)
                  else self._row_block(ex, out, dtype))
            yd = fn(od.to(ex.vals_l.dtype), yd)
        if mask is not None:
            md = (mask.data if isinstance(mask, DistVector)
                  else self._row_block(ex, mask, np.bool_))
            keep = (out.data if isinstance(out, DistVector)
                    else torch.zeros_like(yd))
            yd = torch.where(md != 0, yd, keep.to(yd.dtype))

        n_out = self.ncols if transpose else self.nrows
        if out_dist:
            seconds["device"] += time.perf_counter() - t0
            return DistVector(self.mesh, n_out, yd, "i", semiring.ztype,
                              self._rank)
        outv = Vector.sparse(semiring.ztype, n_out, device=self.device)
        y = ex.to_numpy(ex.gather(yd))
        seconds["device"] += time.perf_counter() - t0
        present = ex.row_present_host
        if self._rank is not None:
            y = y[self._rank]
            present = present[self._rank]
        else:
            y = y[:n_out]
            present = present[:n_out]
        ids = np.nonzero(present)[0].astype(np.int64)
        outv._build(ids, y[present])
        return outv

    def vector(self, fill=0.0, typ=None, transpose=False):
        """A DistVector in this matrix's row space (row blocks), ready
        to chain through :meth:`mxv`."""
        from .. import types as t

        typ = typ or t.FP32
        ex = self._executor(typ._default_semiring(),
                            np.dtype(typ._numpy_t), transpose)
        return DistVector.dense(self.mesh, self.nrows, ex.nrows_p, fill,
                                typ, "i", self._rank)

    def pagerank(self, damping=0.85, itermax=100, tol=1e-4):
        """Distributed PageRank; returns an FP32 Vector of ranks."""
        from ..vector import Vector
        from .. import types as t

        r = dist_pagerank(self.mesh, self.nrows, self._rows, self._cols,
                          damping=damping, itermax=itermax, tol=tol,
                          balance=False)  # triples already balanced
        if self._rank is not None:
            full = np.zeros(max(self.nrows, len(r)), np.float32)
            full[:len(r)] = r
            r = full[self._rank]
        out = Vector.sparse(t.FP32, self.nrows, device=self.device)
        out._build(np.arange(self.nrows, dtype=np.int64),
                   r.astype(np.float32))
        return out

    def triangle_count(self):
        """Distributed triangle count (undirected pattern)."""
        return int(dist_triangle_count(self.mesh, self.nrows,
                                       self._rows, self._cols))

    def _logical_coo(self):
        """Triples in the ORIGINAL id space (undoing the balance
        relabel), for ops that partition on their own."""
        if self._rank is None:
            return self._rows, self._cols, self._vals
        inv = np.empty_like(self._rank)
        inv[self._rank] = np.arange(len(self._rank))
        return inv[self._rows], inv[self._cols], self._vals

    def mxm(self, other, semiring=None, mask=None):
        """Distributed masked semiring matrix-matrix product: the values
        of ``C<M> = A (+.x) B`` at the mask's positions, computed by the
        block-row SpGEMM ring (:func:`dist_masked_spgemm` — remote-row
        fetch around the ring each round).

        The mask is REQUIRED: a distributed unmasked product has
        data-dependent output structure per device, which the
        static-shape executor model deliberately excludes — use the
        single-device engine (``Matrix.mxm``) for unmasked products.
        Returns a host Matrix with the GraphBLAS output pattern (mask
        positions whose dot product has at least one term)."""
        from ..matrix import Matrix

        if mask is None:
            raise NotImplementedError(
                "distributed mxm requires a mask (static-shape output); "
                "use the single-device Matrix.mxm for unmasked products")
        if semiring is None:
            semiring = self.type._default_semiring()
        add, mul = resolve_ops(semiring)
        ztype = semiring.ztype
        dtype = np.dtype(ztype._numpy_t)
        work_dt = np.int8 if dtype == np.bool_ else dtype
        ra, ca, va = self._logical_coo()
        if isinstance(other, DistMatrix):
            rb, cb, vb = other._logical_coo()
            b_ncols = other.ncols
        else:
            rb, cb, vb = other._coo()
            b_ncols = other.ncols
        if self.ncols != (other.nrows):
            raise DimensionMismatch("mxm inner dimensions differ")
        if isinstance(mask, DistMatrix):
            mr, mc, _ = mask._logical_coo()
        else:
            mr, mc, _ = mask._coo()
        vals, present = dist_masked_spgemm(
            self.mesh, self.nrows, self.ncols, b_ncols,
            ra, ca, va.astype(work_dt), rb, cb,
            np.asarray(vb).astype(work_dt), mr, mc,
            add=add, mul=mul, dtype=work_dt)
        out = Matrix.sparse(ztype, self.nrows, b_ncols, device=self.device)
        out._build(np.asarray(mr)[present], np.asarray(mc)[present],
                   vals[present].astype(dtype))
        return out

    def k_truss(self, k):
        """Distributed k-truss: iterated per-edge support counting via
        the masked-SpGEMM ring (PLUS_PAIR dot of the current edge set
        against itself, masked by itself) with pruning to support
        >= k-2 until fixpoint — the distributed form of
        ``algorithms.k_truss``.  Returns a host INT64 Matrix of the
        surviving edges with their support values."""
        from .. import types as t
        from ..matrix import Matrix

        r, c, _ = self._logical_coo()
        r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
        support = np.zeros(len(r), np.int32)
        nvals_last = -1
        while True:
            ones = np.ones(len(r), np.int32)
            vals, present = dist_masked_spgemm(
                self.mesh, self.nrows, self.nrows, self.nrows,
                r, c, ones, r, c, ones, r, c,
                add="PLUS", mul="PAIR", dtype=np.int32)
            keep = present & (vals >= k - 2)
            r, c, support = r[keep], c[keep], vals[keep]
            if len(r) == nvals_last:
                break
            nvals_last = len(r)
        out = Matrix.sparse(t.INT64, self.nrows, self.ncols,
                            device=self.device)
        out._build(r, c, support.astype(np.int64))
        return out

    def bfs_level(self, source, max_levels=None):
        """Distributed level-synchronous BFS from ``source``.

        Each level is ONE step on the mesh: a LOR_SECOND SpMV over the
        out-edges (the frontier halo exchange is the executor's
        all-gather), with the level / frontier update behind it — level
        and frontier stay device-resident across the loop and only the
        scalar "vertices newly reached" count syncs to the host per
        level (the loop-exit test, as the reference's BFS host loop).

        Returns an INT32 host Vector of 1-based levels whose pattern is
        the reached set, ``v[source] == 1`` — the same contract as
        ``algorithms.bfs_level``."""
        from .. import types as t
        from ..vector import Vector

        if self.nrows != self.ncols:
            raise DimensionMismatch("bfs_level needs a square matrix")
        ex = self._ops_executor("LOR", "SECOND", np.int8, transpose=True)
        t0 = time.perf_counter()
        src = (int(self._rank[source]) if self._rank is not None
               else int(source))
        level0 = np.zeros(ex.nrows_p, np.int32)
        level0[src] = 1
        f0 = np.zeros(ex.nrows_p, np.int8)
        f0[src] = 1
        lo = ex.ri * ex.rb
        level = torch.from_numpy(level0[lo:lo + ex.rb]).to(self.device)
        frontier = torch.from_numpy(f0[lo:lo + ex.rb]).to(self.device)

        limit = self.nrows if max_levels is None else max_levels
        it = 2
        while it <= limit + 1:
            nxt = ex(frontier)                      # bool row block
            new = nxt & (level == 0)
            level = torch.where(new, it, level)
            frontier = new.to(torch.int8)
            nnew = _all_reduce(new.sum(dtype=torch.int32).reshape(1),
                               dist.ReduceOp.SUM, ex.group_i)
            if int(nnew[0]) == 0:
                break
            it += 1
        lv = ex.gather(level).cpu().numpy()
        seconds["device"] += time.perf_counter() - t0
        lv = (lv[self._rank] if self._rank is not None
              else lv[:self.nrows])
        out = Vector.sparse(t.INT32, self.nrows, device=self.device)
        ids = np.nonzero(lv > 0)[0].astype(np.int64)
        out._build(ids, lv[lv > 0])
        return out

    def sssp(self, source, itermax=None):
        """Distributed single-source shortest paths (Bellman-Ford over
        the MIN_PLUS semiring).

        Each round relaxes EVERY edge in one mesh step
        (``d' = min(d, A^T min.+ d)``); the distance vector never
        leaves the devices — only the scalar changed-count syncs per
        round for the fixpoint test.  Matches ``algorithms.sssp``:
        returns a host Vector whose pattern is the reachable set, with
        ``v[source] == 0``."""
        from .. import types as t
        from ..vector import Vector

        if self.nrows != self.ncols:
            raise DimensionMismatch("sssp needs a square matrix")
        dtype = (np.float64 if np.dtype(self.type._numpy_t) == np.float64
                 else np.float32)
        typ = t.FP64 if dtype == np.float64 else t.FP32
        ex = self._ops_executor("MIN", "PLUS", dtype, transpose=True)
        t0 = time.perf_counter()
        src = (int(self._rank[source]) if self._rank is not None
               else int(source))
        d0 = np.full(ex.nrows_p, np.inf, dtype)
        d0[src] = 0
        lo = ex.ri * ex.rb
        d = torch.from_numpy(d0[lo:lo + ex.rb]).to(self.device)

        limit = self.nrows - 1 if itermax is None else itermax
        for _ in range(max(limit, 1)):
            d_new = torch.minimum(d, ex(d))
            changed = _all_reduce(
                (d_new != d).sum(dtype=torch.int32).reshape(1),
                dist.ReduceOp.SUM, ex.group_i)
            d = d_new
            if int(changed[0]) == 0:
                break
        dh = ex.gather(d).cpu().numpy()
        seconds["device"] += time.perf_counter() - t0
        dh = (dh[self._rank] if self._rank is not None
              else dh[:self.nrows])
        out = Vector.sparse(typ, self.nrows, device=self.device)
        ids = np.nonzero(np.isfinite(dh))[0].astype(np.int64)
        out._build(ids, dh[np.isfinite(dh)])
        return out
