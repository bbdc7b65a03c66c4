"""Static permutation primitive: an arbitrary N-element permutation
run as a short fixed sequence of lane-gather passes and tile transposes
(a Clos/Benes network decomposition).

Counterpart of ``pygraphblas_tpu/core/perm.py``:

  level 0..D-1:  A_i  = per-row lane gather   (route to the "color" lane)
  middle:        S-way sublane select within (S, 128) tiles
  level D-1..0:  C_i  = per-row lane gather   (route to the final lane)

with a transpose between levels.  Routing (``PermPlan.build``) is the
same host code: an exact 128-edge-coloring per level, in native code
(``csrc/benes.cpp`` through ``_native``) when a C++ compiler is present,
else the numpy greedy colorer with the pure-Python exact colorer.

Kernels (``csrc/perm.cu``), each beside its plain PyTorch version:
  - ``_lane_gather`` replaces perm.py:_lane_gather (a per-row lane
    gather, for levels shorter than 128 rows; no plan of either package
    reaches it, since every level has r_l >= S * 128);
  - ``_lane_gather_tdesc`` replaces perm.py:_lane_gather_tdesc
    (lane gather + 128x128 tile transpose, a descend pass);
  - ``_lane_gather_tasc`` replaces perm.py:_lane_gather_tasc
    (inverse tile transpose + lane gather, optional 8-row fold);
  - ``_inner3`` replaces perm.py:_inner3 (innermost descend, the (S,128)
    mid stage and the innermost ascend of one group), for D >= 3,
    K == 128, S <= 24;
  - ``_mid_pass`` replaces perm.py:_mid_pass (the bottom level on its
    own: A gather, sublane select and C gather in (S,128) tiles, any S
    from 1 to 128), for every other plan.
All five are bound by bytes: each moves its input, its int8 index
tables and its output once.  On the card they take float32 and int32;
values wider than 4 bytes take the plain versions, as the JAX package
sends them to XLA.
"""

import numpy as np
import torch

from .. import _kernels, _native
from .._device import as_tensor

# Arbitrary-gather threshold: below this size a plain indexed gather
# costs less than the fixed pass structure.
TRIVIAL_N = 1 << 14

_MAX_GREEDY_ROUNDS = 200


# ---------------------------------------------------------------------------
# host-side routing (the same code as the JAX package)


def _greedy_color(src_row, dst_row, n_rows, rng):
    """Color N elements with colors 0..127, distinct within each src row
    and each dst row.  Rows are at most `fill` full (slack), so random
    greedy with per-round conflict repair converges geometrically.
    Vectorized numpy; returns uint8 colors."""
    n = len(src_row)
    # initial: distinct colors within each src row via per-row random ranks
    order = np.argsort(src_row * np.int64(256) +
                       rng.randint(0, 256, n).astype(np.int64), kind="stable")
    rank_in_src = np.empty(n, np.int64)
    first = np.zeros(n, bool)
    first[0] = True
    ssorted = src_row[order]
    first[1:] = ssorted[1:] != ssorted[:-1]
    run_id = np.cumsum(first) - 1
    run_start = np.flatnonzero(first)
    rank_in_src[order] = np.arange(n) - run_start[run_id]
    color = rank_in_src.astype(np.int64)  # distinct in src rows (fill <= 128)

    # src-row occupancy is an invariant: colors stay distinct per src row
    # throughout (losers only move to colors free in their src row, and
    # same-row pick collisions are rolled back).
    src_used = np.zeros((n_rows, 128), bool)
    src_used[src_row, color] = True
    dst_frozen = np.zeros((n_rows, 128), bool)
    live = np.arange(n)
    tbl = np.empty(n_rows * 128, np.int64)
    stall = 0
    prev = n + 1
    for _round in range(_MAX_GREEDY_ROUNDS):
        key = dst_row[live] * np.int64(128) + color[live]
        tbl[key] = live  # last writer among live claimants wins
        ok = np.logical_and(tbl[key] == live,
                            ~dst_frozen[dst_row[live], color[live]])
        dst_frozen[dst_row[live[ok]], color[live[ok]]] = True
        losers = live[~ok]
        if len(losers) == 0:
            live = losers
            break
        # plateau: hand the stubborn tail (high-multiplicity (src,dst)
        # pairs whose random picks keep colliding) to the exact
        # Kempe-chain augmenter instead of churning rounds
        stall = stall + 1 if len(losers) > 0.7 * prev else 0
        prev = len(losers)
        if stall >= 4 or len(losers) <= max(256, n // 2000):
            live = losers
            break
        # recolor: a random color free in the src row AND not frozen in the
        # dst row (the intersection palette — required for convergence)
        cand = ~np.logical_or(src_used[src_row[losers]],
                              dst_frozen[dst_row[losers]])
        # uniform-ish random candidate pick with one random per loser:
        # argmax of the rotated lane index over candidates
        rot = rng.randint(0, 128, len(losers)).astype(np.int32)
        lanes = np.arange(128, dtype=np.int32)
        score = cand * (((lanes[None, :] + rot[:, None]) & 127) + 1)
        newc = np.argmax(score, axis=1)
        movable = score[np.arange(len(losers)), newc] > 0
        # empty-palette losers just retry next round
        # roll back same-src-row pick collisions (keep one per (row,color))
        k2 = src_row[losers] * np.int64(128) + newc
        tbl[k2] = losers
        keep = np.logical_and(tbl[k2] == losers, movable)
        moved = losers[keep]
        src_used[src_row[moved], color[moved]] = False
        color[moved] = newc[keep]
        src_used[src_row[moved], color[moved]] = True
        live = losers
    if len(live):
        _augment_resolve(src_row, dst_row, color, live, src_used, dst_frozen,
                         n_rows)
    return color.astype(np.uint8)


def _augment_resolve(src_row, dst_row, color, leftovers, src_used,
                     dst_frozen, n_rows):
    """Exact Kempe-chain fallback for the greedy tail (usually empty).

    For a stuck element (free src colors and free dst colors disjoint):
    pick a free at src, b free at dst; swap colors a<->b along the
    ab-alternating chain through the already-frozen elements, which frees
    a at the dst row (standard bipartite edge-coloring augmentation)."""
    # element lookup tables per (row, color) on both sides; occupancy is
    # rebuilt from the placed (non-leftover) elements only — leftovers'
    # stale colors must not block or be released twice
    n = len(src_row)
    src_at = np.full((n_rows, 128), -1, np.int64)
    dst_at = np.full((n_rows, 128), -1, np.int64)
    frozen = np.ones(n, bool)
    frozen[leftovers] = False
    idx = np.flatnonzero(frozen)
    src_at[src_row[idx], color[idx]] = idx
    dst_at[dst_row[idx], color[idx]] = idx
    src_used[:] = False
    src_used[src_row[idx], color[idx]] = True
    dst_frozen[:] = False
    dst_frozen[dst_row[idx], color[idx]] = True

    def place(e, c):
        src_at[src_row[e], c] = e
        dst_at[dst_row[e], c] = e
        src_used[src_row[e], c] = True
        dst_frozen[dst_row[e], c] = True
        color[e] = c

    for e in leftovers:
        s, t = int(src_row[e]), int(dst_row[e])
        free_s = np.flatnonzero(~src_used[s])
        free_t = np.flatnonzero(~dst_frozen[t])
        both = np.intersect1d(free_s, free_t)
        if len(both):
            place(e, int(both[0]))
            continue
        a, b = int(free_s[0]), int(free_t[0])
        # flip colors a<->b along the ab-alternating chain from dst row t;
        # bipartiteness guarantees the chain never reaches src row s, so
        # after the flip `a` is free at both s and t.
        chain = [int(dst_at[t, a])]
        lookup_src = True  # alternate: src-side with b, dst-side with a
        while True:
            cur = chain[-1]
            nxt = int(src_at[src_row[cur], b]) if lookup_src \
                else int(dst_at[dst_row[cur], a])
            if nxt < 0:
                break
            chain.append(nxt)
            lookup_src = not lookup_src
        for el in chain:  # clear old entries first, then re-place
            c_old = int(color[el])
            src_at[src_row[el], c_old] = -1
            dst_at[dst_row[el], c_old] = -1
            src_used[src_row[el], c_old] = False
            dst_frozen[dst_row[el], c_old] = False
        for el in chain:
            place(el, a + b - int(color[el]))
        place(e, a)


def _exact_color(u, v, n_nodes):
    """Exact 128-coloring of a 128-regular bipartite multigraph via the
    native Euler-split routine; pure-python fallback without a compiler."""
    if _native.available():
        return _native.benes_color(u, v, n_nodes, n_nodes, 7)
    return _exact_color_py(u, v, n_nodes)


def _exact_color_py(u, v, n_nodes):
    """Reference implementation of recursive Euler-split coloring."""
    m = len(u)
    color = np.zeros(m, np.uint8)

    def rec(ids, bits, base):
        if bits == 0:
            color[ids] = base
            return
        # orient: pair incident edges per node, walk trails
        adj = {}
        for e in ids:
            adj.setdefault(("l", u[e]), []).append(e)
            adj.setdefault(("r", v[e]), []).append(e)
        slot = {}
        for k, es in adj.items():
            for i, e in enumerate(es):
                slot[(k, e) if (k, e) not in slot else (k, e, 1)] = i
        bit = {}
        seen = set()
        for e0 in ids:
            if e0 in seen:
                continue
            e, side = e0, 0
            while e not in seen:
                seen.add(e)
                bit[e] = side
                key = ("r", v[e]) if side == 0 else ("l", u[e])
                es = adj[key]
                s = es.index(e)
                ps = s ^ 1
                e = es[ps]
                side = 0 if key[0] == "l" else 1
        i0 = np.array([e for e in ids if bit[e] == 0], np.int64)
        i1 = np.array([e for e in ids if bit[e] == 1], np.int64)
        rec(i0, bits - 1, base)
        rec(i1, bits - 1, base + (1 << (bits - 1)))

    rec(np.arange(m, dtype=np.int64), 7, 0)
    return color


def _complete_level0(pp, qq, c0, R):
    """Extend the colored real elements to a full bijection on R*128
    cells: pair each (src row, free color) with a (dst row, free color)
    of the same color.  Returns full (p', q', color) arrays of length
    R*128."""
    n = len(pp)
    src_used = np.zeros(R * 128, bool)
    dst_used = np.zeros(R * 128, bool)
    src_cell_used = np.zeros(R * 128, bool)
    dst_cell_used = np.zeros(R * 128, bool)
    c64 = c0.astype(np.int64)
    src_used[(pp >> 7) * 128 + c64] = True
    dst_used[(qq >> 7) * 128 + c64] = True
    src_cell_used[pp] = True
    dst_cell_used[qq] = True

    # free (row, color) pairs, sorted by (color, row) so same-color pairs zip
    fs = np.flatnonzero(~src_used)     # row*128 + color
    fd = np.flatnonzero(~dst_used)
    fs = fs[np.argsort(fs & 127, kind="stable")]
    fd = fd[np.argsort(fd & 127, kind="stable")]
    # junk src/dst CELLS per row, in row order; assign row-by-row:
    # the i-th junk cell of row r pairs with the i-th free color of row r
    js = np.flatnonzero(~src_cell_used)   # cell index = row*128 + lane
    jd = np.flatnonzero(~dst_cell_used)
    # fs is (row*128+color) sorted by color; reorder junk cells to match:
    # sort fs by row to align with js (both per-row sequential), then the
    # color-sorted order defines the pairing with fd.
    fs_byrow = np.sort(fs)
    fd_byrow = np.sort(fd)
    # map: junk src cell js[i] gets color fs_byrow[i] & 127 (same row)
    assert len(js) == len(fs_byrow) and len(jd) == len(fd_byrow)
    # pair src and dst junk by color: order both sides by (color, row)
    so = np.argsort(fs_byrow & 127, kind="stable")
    do = np.argsort(fd_byrow & 127, kind="stable")
    jp = js[so]
    jq = jd[do]
    jc = (fs_byrow[so] & 127).astype(np.uint8)
    assert np.array_equal(jc, (fd_byrow[do] & 127).astype(np.uint8))

    p_full = np.concatenate([pp, jp])
    q_full = np.concatenate([qq, jq])
    c_full = np.concatenate([c0, jc])
    assert len(p_full) == R * 128
    return p_full, q_full, c_full, n


def _choose_shape(n, fill):
    """Pick (D, S, R0): N' = S * 128^D, R0 = N'/128, R0*fill >= n.

    S may run up to 128 (the bottom subproblems are (S,128) tiles; the
    sublane select handles any S): keeping D one level lower both avoids
    two whole permutation passes and keeps R0 close to n/128, so the
    K == 128 padding (core/xspmv.py) stays cheap — at S <= 16 a size
    just past a 16*128^(d-1) boundary would jump to 8x junk cells."""
    r_min = -(-n // fill)
    d = 1
    while 128 ** d < r_min:
        d += 1
    s = -(-r_min // (128 ** (d - 1)))
    assert 1 <= s <= 128
    r0 = s * 128 ** (d - 1)
    return d, s, r0


class PermPlan:
    """Compiled routing for one static permutation: out[q] = in[src[q]].

    Arrays are numpy after ``build`` and torch tensors after ``to``:
    ``src_idx`` (trivial plans), else the int8 stage tables ``a_stages``
    / ``c_stages`` (D of (R0, 128) each) and ``ssel`` ((128^(D-1), S,
    128), None when S == 1)."""

    STATIC = ("n", "trivial", "D", "S", "R0", "K")
    __slots__ = STATIC + ("src_idx", "a_stages", "c_stages", "ssel")

    @staticmethod
    def build(src, fill=None, seed=0):
        """src: int array (N,), a permutation of 0..N-1.  out[q] = in[src[q]].

        fill: embedding occupancy per 128-lane row.  With the native
        exact colorer, 128 (K == 128 enables the fold8-fused ascend);
        the greedy colorer needs slack (112)."""
        native = _native.available()
        if fill is None:
            fill = 128 if native else 112
        src = np.asarray(src, np.int64)
        n = len(src)
        plan = PermPlan()
        plan.n = n
        plan.a_stages, plan.c_stages, plan.ssel = [], [], None
        if n <= TRIVIAL_N:
            plan.trivial = True
            plan.src_idx = src.astype(np.int32)
            plan.D = plan.S = plan.R0 = plan.K = 0
            return plan
        plan.trivial = False
        plan.src_idx = None

        rng = np.random.RandomState(seed)
        D, S, R0 = _choose_shape(n, fill)
        K = min(128, -(-n // R0))  # lanes actually used per row
        plan.D, plan.S, plan.R0, plan.K = D, S, R0, K

        if native and K == 128:
            # whole-plan native assembly: the K == 128 embedding is the
            # identity; every per-level coloring + stage table fill runs
            # in one C call
            a, c, ssel = _native.benes_stages(src, D, S, R0)
            plan.a_stages = [a[lvl] for lvl in range(D)]
            plan.c_stages = [c[lvl] for lvl in range(D)]
            plan.ssel = ssel
            return plan

        # embedding: element i of the in-array at cell (i//K)*128 + i%K
        q = np.arange(n, dtype=np.int64)
        pp = (src // K) * 128 + src % K
        qq = (q // K) * 128 + q % K

        # level-0 coloring: complete the embedding to a full bijection,
        # then one exact coloring; greedy + repair without native code
        if native:
            src_cell_used = np.zeros(R0 * 128, bool)
            dst_cell_used = np.zeros(R0 * 128, bool)
            src_cell_used[pp] = True
            dst_cell_used[qq] = True
            js = np.flatnonzero(~src_cell_used)
            jd = np.flatnonzero(~dst_cell_used)
            p_full = np.concatenate([pp, js])
            q_full = np.concatenate([qq, jd])
            c_full = _exact_color(p_full >> 7, q_full >> 7, R0)
        else:
            c0 = _greedy_color(pp >> 7, qq >> 7, R0, rng)
            p_full, q_full, c_full, _ = _complete_level0(pp, qq, c0, R0)

        a_stages, c_stages = [], []
        u = p_full       # current src cell index at this level
        v = q_full
        g = np.zeros(R0 * 128, np.int64)   # subproblem id
        for lvl in range(D):
            rows = R0 // 128 ** lvl
            if lvl > 0:
                nodes = g * rows + (u >> 7)
                nodes_v = g * rows + (v >> 7)
                c_full = _exact_color(nodes, nodes_v, R0)
            c64 = c_full.astype(np.int64)
            a = np.tile(np.arange(128, dtype=np.uint8), (R0, 1))
            c = a.copy()
            a[g * rows + (u >> 7), c64] = (u & 127).astype(np.uint8)
            c[g * rows + (v >> 7), (v & 127)] = c_full
            a_stages.append(a)
            c_stages.append(c)
            g = g * 128 + c64
            u = u >> 7
            v = v >> 7
        # bottom: u, v now in [0, S) per subproblem; sublane select
        nsub = 128 ** (D - 1)
        if S > 1:
            ssel = np.zeros((nsub, S, 128), np.uint8)
            ssel[g >> 7, v, (g & 127)] = u.astype(np.uint8)
            plan.ssel = ssel.astype(np.int8)
        plan.a_stages = [x.astype(np.int8) for x in a_stages]
        plan.c_stages = [x.astype(np.int8) for x in c_stages]
        return plan

    # -- state / device ------------------------------------------------------

    def state(self):
        """Static fields and numpy arrays (the plan cache's format)."""
        d = {k: getattr(self, k) for k in self.STATIC}
        if self.trivial:
            d["src_idx"] = np.asarray(self.src_idx)
            return d
        d["a_stages"] = np.stack([np.asarray(a) for a in self.a_stages])
        d["c_stages"] = np.stack([np.asarray(c) for c in self.c_stages])
        if self.ssel is not None:
            d["ssel"] = np.asarray(self.ssel)
        return d

    @staticmethod
    def from_state(d, device=None):
        p = PermPlan()
        for k in PermPlan.STATIC:
            setattr(p, k, d[k])
        p.src_idx, p.a_stages, p.c_stages, p.ssel = None, [], [], None
        if p.trivial:
            p.src_idx = np.asarray(d["src_idx"])
        else:
            p.a_stages = list(np.asarray(d["a_stages"]))
            p.c_stages = list(np.asarray(d["c_stages"]))
            p.ssel = np.asarray(d["ssel"]) if d.get("ssel") is not None \
                else None
        return p.to(device) if device is not None else p

    def to(self, device):
        p = PermPlan()
        for k in self.STATIC:
            setattr(p, k, getattr(self, k))
        p.src_idx = as_tensor(self.src_idx, device)
        p.a_stages = [as_tensor(a, device) for a in self.a_stages]
        p.c_stages = [as_tensor(c, device) for c in self.c_stages]
        p.ssel = as_tensor(self.ssel, device)
        return p

    # -- execution -----------------------------------------------------------

    def apply(self, x, pad_value=0):
        """Apply the permutation to a 1-D tensor of length <= n (missing
        tail elements read as `pad_value`)."""
        if self.trivial:
            if x.shape[0] < self.n:
                x = torch.cat([x, torch.full((self.n - x.shape[0],),
                                             pad_value, dtype=x.dtype,
                                             device=x.device)])
            return x[self.src_idx.long()]
        return _apply_staged(x, self.n, self.D, self.S, self.R0, self.K,
                             self.a_stages, self.c_stages, self.ssel,
                             pad_value)

    def apply_fold8(self, x, pad_value, fold):
        """Apply the permutation, then fold (add monoid `fold`, an object
        or a name) each
        consecutive 8-row block of the (n//128, 128) output lanewise.

        When the plan's layout allows (K == 128 staged plan, n % 1024
        == 0), the fold is fused into the final ascend pass.  Returns
        (tensor of length n // 8, True) either way."""
        if (not self.trivial and self.K == 128 and self.D >= 2
                and self.n % 1024 == 0):
            return _apply_staged(x, self.n, self.D, self.S, self.R0,
                                 self.K, self.a_stages, self.c_stages,
                                 self.ssel, pad_value, fold8=fold), True
        full = self.apply(x, pad_value=pad_value)
        nfull = full.shape[0]
        pad = -nfull % 1024
        if pad:
            full = torch.cat([full, torch.full((pad,), pad_value,
                                               dtype=full.dtype,
                                               device=full.device)])
        typ = _kernels.value_type(full, fold)
        foldf = _kernels.fold_fn(_kernels.monoid_of(fold, typ), typ)
        f3 = full.reshape(-1, 8, 128)
        out = f3[:, 0, :]
        for s in range(1, 8):
            out = foldf(out, f3[:, s, :])
        return out.reshape(-1)[:(nfull + pad) // 8], True


# ---------------------------------------------------------------------------
# plain PyTorch versions of the passes (perm.py:524-525, 595-598,
# 657-667, 752-757, 822-826)


def _lane_gather_plain(x2d, idx8):
    return torch.gather(x2d, 1, idx8.long())


def _tdesc_plain(x2d, idx8, g, r_l):
    y = _lane_gather_plain(x2d, idx8)
    return y.reshape(g, r_l, 128).transpose(1, 2).reshape(g * r_l, 128)


def _tasc_plain(x2d, idx8, g, r_l, fold8=None):
    t = x2d.reshape(g, 128, r_l).transpose(1, 2).reshape(g * r_l, 128)
    y = _lane_gather_plain(t, idx8)
    if fold8 is None:
        return y
    typ = _kernels.value_type(y, fold8)
    foldf = _kernels.fold_fn(_kernels.monoid_of(fold8, typ), typ)
    y3 = y.reshape(g * r_l // 8, 8, 128)
    out = y3[:, 0, :]
    for s in range(1, 8):
        out = foldf(out, y3[:, s, :])
    return out


def _mid_pass_plain(x3d, a8, ssel8, c8):
    a = a8.long().reshape(x3d.shape)
    c = c8.long().reshape(x3d.shape)
    y = torch.gather(x3d, 2, a)
    if ssel8 is not None:
        # a select outside [0, S) gives 0, as the TPU kernel's
        # zero-initialised select (perm.py:845-848) and the CUDA kernel
        t = ssel8.long().reshape(x3d.shape)
        ok = (t >= 0) & (t < x3d.shape[1])
        y = torch.where(ok, torch.gather(y, 1, t.clamp(0, x3d.shape[1] - 1)),
                        torch.zeros((), dtype=y.dtype, device=y.device))
    return torch.gather(y, 2, c)


def _inner3_plain(x2d, a_in, a_mid, ssel, c_mid, c_in, g, S):
    r_l = S * 128
    cur = _tdesc_plain(x2d, a_in, g, r_l)
    nsub = cur.shape[0] // S
    cur = _mid_pass_plain(cur.reshape(nsub, S, 128), a_mid, ssel,
                          c_mid).reshape(nsub * S, 128)
    return _tasc_plain(cur, c_in, g, r_l)


# ---------------------------------------------------------------------------
# wrappers: the kernel where _kernels.on_card (a CUDA tensor of 4 bytes or
# less: 1- and 2-byte values move as int32 words), else the plain version
# (perm.py:524, 584-585, 650-651, 752, 822 send 8-byte values to XLA)


def _lane_gather(x2d, idx8):
    """out[r, l] = x2d[r, idx[r, l]] over (rows, 128)."""
    name = "lane_gather"
    if not _kernels.on_card(x2d, name):
        return _lane_gather_plain(x2d, idx8)
    if x2d.dim() != 2 or x2d.shape[1] != 128 or idx8.shape != x2d.shape:
        raise ValueError(f"{name}: bad shapes {tuple(x2d.shape)} "
                         f"{tuple(idx8.shape)}")
    if idx8.dtype != torch.int8:
        raise ValueError(f"{name}: idx must be int8")
    w, back = _kernels.widen(x2d.contiguous())
    _kernels.cuda_args(name, w, idx8)
    out = torch.empty_like(w)
    # the kernel's 16-byte loads and stores
    if any(t.data_ptr() % 16 for t in (w, idx8, out)):
        raise ValueError(f"{name}: the kernel's 16-byte loads need "
                         "16-byte aligned tensors")
    rc = _kernels.lib().pgb_lane_gather(
        w.data_ptr(), idx8.data_ptr(), out.data_ptr(), w.shape[0],
        _kernels.word_code(w), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return back(out)


def _mid_pass(x3d, a8, ssel8, c8):
    """A gather + sublane select + C gather within (S,128) tiles:
    x3d (nsub, S, 128); a8, c8 hold nsub*S*128 int8 lane indices,
    ssel8 (nsub, S, 128) int8 row indices, None when S == 1."""
    name = "mid_pass"
    if not _kernels.on_card(x3d, name):
        return _mid_pass_plain(x3d, a8, ssel8, c8)
    if x3d.dim() != 3 or x3d.shape[2] != 128:
        raise ValueError(f"{name}: bad shape {tuple(x3d.shape)}")
    nsub, S = x3d.shape[0], x3d.shape[1]
    if not 1 <= S <= 128 or a8.numel() != x3d.numel() or \
            c8.numel() != x3d.numel():
        raise ValueError(f"{name}: bad shapes S={S}")
    if (S > 1) != (ssel8 is not None) or (
            ssel8 is not None and ssel8.numel() != x3d.numel()):
        raise ValueError(f"{name}: ssel does not match S={S}")
    x3d, back = _kernels.widen(x3d.contiguous())
    _kernels.cuda_args(name, x3d, a8, ssel8, c8)
    out = torch.empty_like(x3d)
    if any(t.data_ptr() % 16 for t in (x3d, a8, ssel8, c8, out)
           if t is not None):
        raise ValueError(f"{name}: the kernel's 16-byte copies need "
                         "16-byte aligned tensors")
    rc = _kernels.lib().pgb_mid_pass(
        x3d.data_ptr(), a8.data_ptr(),
        ssel8.data_ptr() if ssel8 is not None else None, c8.data_ptr(),
        out.data_ptr(), nsub, S, _kernels.word_code(x3d), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return back(out)


def _lane_gather_tdesc(x2d, idx8, g, r_l):
    """Descend pass: lane gather + per-tile transpose,
    (g*r_l, 128) -> (g*128*(r_l//128), 128)."""
    name = "lane_gather_tdesc"
    if not _kernels.on_card(x2d, name):
        return _tdesc_plain(x2d, idx8, g, r_l)
    if r_l % 128 or x2d.shape != (g * r_l, 128) or idx8.shape != x2d.shape:
        raise ValueError(f"{name}: bad shapes {tuple(x2d.shape)} g={g} "
                         f"r_l={r_l}")
    x2d, back = _kernels.widen(x2d.contiguous())
    _kernels.cuda_args(name, x2d, idx8)
    out = torch.empty_like(x2d)
    rc = _kernels.lib().pgb_lane_gather_tdesc(
        x2d.data_ptr(), idx8.data_ptr(), out.data_ptr(), g, r_l // 128,
        _kernels.word_code(x2d), _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return back(out)


def _lane_gather_tasc(x2d, idx8, g, r_l, fold8=None):
    """Ascend pass: per-tile inverse transpose + lane gather,
    (g*128*(r_l//128), 128) -> (g*r_l, 128); with fold8 (an add monoid,
    an object or a name) each 8-row block is folded lanewise ->
    (g*r_l//8, 128)."""
    name = "lane_gather_tasc"
    if not _kernels.on_card(x2d, name):
        return _tasc_plain(x2d, idx8, g, r_l, fold8)
    if r_l % 128 or x2d.shape != (g * r_l, 128) or idx8.shape != x2d.shape:
        raise ValueError(f"{name}: bad shapes {tuple(x2d.shape)} g={g} "
                         f"r_l={r_l}")
    if fold8 is not None:
        typ = _kernels.value_type(x2d, fold8)
        code = _kernels.dtype_code(typ, name)
        fop = _kernels.fold_code(_kernels.monoid_of(fold8, typ), typ, name)
        x2d = _kernels.to_words(x2d.contiguous(), typ)
        back = lambda w: _kernels.from_words(w, typ)   # noqa: E731
    else:
        x2d, back = _kernels.widen(x2d.contiguous())
        code, fop = _kernels.word_code(x2d), -1
    _kernels.cuda_args(name, x2d, idx8)
    rows = g * r_l // 8 if fold8 is not None else g * r_l
    out = torch.empty((rows, 128), dtype=x2d.dtype, device=x2d.device)
    if any(t.data_ptr() % 16 for t in (x2d, idx8, out)):
        raise ValueError(f"{name}: the kernel's 16-byte loads need "
                         "16-byte aligned tensors")
    rc = _kernels.lib().pgb_lane_gather_tasc(
        x2d.data_ptr(), idx8.data_ptr(), out.data_ptr(), g, r_l // 128,
        code, fop, _kernels.stream())
    _kernels.check(rc, name)
    _kernels.count(name)
    return back(out)


def _inner3(x2d, a_in, a_mid, ssel, c_mid, c_in, g, S):
    """Fused middle of the Benes network: innermost descend pass +
    (S,128)-tile mid pass + innermost ascend pass, over g groups of
    (S*128, 128) rows."""
    name = "inner3"
    if not _kernels.on_card(x2d, name):
        return _inner3_plain(x2d, a_in, a_mid, ssel, c_mid, c_in, g, S)
    shape = (g * S * 128, 128)
    if x2d.shape != shape or any(t.shape != shape for t in
                                 (a_in, c_in, a_mid, c_mid)):
        raise ValueError(f"{name}: bad shapes")
    if (S > 1) != (ssel is not None) or (
            ssel is not None and ssel.numel() != g * S * 128 * 128):
        raise ValueError(f"{name}: ssel does not match S={S}")
    if S > 24:
        raise ValueError(f"{name}: S={S} > 24 needs _mid_pass")
    x2d, back = _kernels.widen(x2d.contiguous())     # 4-byte words
    _kernels.cuda_args(name, x2d, a_in, a_mid, ssel, c_mid, c_in)
    out = torch.empty_like(x2d)
    if any(t.data_ptr() % 16 for t in (x2d, a_in, a_mid, ssel, c_mid, c_in,
                                       out) if t is not None):
        raise ValueError(f"{name}: the kernel's 16-byte loads need "
                         "16-byte aligned tensors")
    rc = _kernels.lib().pgb_inner3(
        x2d.data_ptr(), a_in.data_ptr(), a_mid.data_ptr(),
        ssel.data_ptr() if ssel is not None else None, c_mid.data_ptr(),
        c_in.data_ptr(), out.data_ptr(), g, S, _kernels.stream())
    if rc == -2:
        raise RuntimeError(f"{name}: the card cannot place a cluster of 8 "
                           f"blocks with the S={S} slab in shared memory")
    _kernels.check(rc, name)
    _kernels.count(name)
    return back(out)


def _apply_staged(x, n, D, S, R0, K, a_stages, c_stages, ssel,
                  pad_value=0, fold8=None):
    dtype = x.dtype
    # embed: element i -> cell (i//K)*128 + (i%K); tail elements beyond
    # the supplied x (and the embedding pad) read as pad_value
    pad_n = R0 * K - x.shape[0]
    xe = torch.cat([x, torch.full((pad_n,), pad_value, dtype=dtype,
                                  device=x.device)]) if pad_n else x
    xe = xe.reshape(R0, K)
    if K < 128:
        xe = torch.nn.functional.pad(xe, (0, 128 - K))
    cur = xe.contiguous()         # (rows_total, 128) at each level
    shapes = []
    # the innermost descend + mid + innermost ascend run as one kernel
    # when the layout allows (K == 128 plans with D >= 3, S <= 24)
    fuse_mid = D >= 3 and K == 128 and S <= 24
    for lvl in range(D - 1):
        r_l = R0 // 128 ** lvl
        g_count = cur.shape[0] // r_l
        shapes.append((g_count, r_l))
        if fuse_mid and lvl == D - 2:
            break
        if r_l >= 128:
            cur = _lane_gather_tdesc(cur, a_stages[lvl], g_count, r_l)
        else:
            cur = _lane_gather(cur, a_stages[lvl])
            t = cur.reshape(g_count, r_l, 128).transpose(1, 2)
            cur = t.reshape(g_count * 128, r_l)
    if fuse_mid:
        g_count, r_l = shapes[-1]          # r_l == 128 * S here
        cur = _inner3(cur, a_stages[D - 2], a_stages[D - 1], ssel,
                      c_stages[D - 1], c_stages[D - 2], g_count, S)
        start_asc = D - 3
    else:
        # bottom level: A + select + C within (S,128) tiles; the kernel's
        # 16-byte copies find cur fresh from a pass above (n > TRIVIAL_N,
        # so D >= 2) and the stage tables whole tensors of R0 * 128 bytes
        nsub = cur.shape[0] // S
        cur = _mid_pass(cur.reshape(nsub, S, 128), a_stages[D - 1], ssel,
                        c_stages[D - 1]).reshape(nsub * S, 128)
        start_asc = D - 2
    # ascend: inverse transposes fused with the C gathers
    for lvl in range(start_asc, -1, -1):
        g_count, r_l = shapes[lvl]
        if r_l >= 128:
            # final pass: optionally fold consecutive 8-row blocks
            # in-kernel (K == 128 layouts only; callers guarantee it)
            f = fold8 if lvl == 0 else None
            cur = _lane_gather_tasc(cur, c_stages[lvl], g_count, r_l,
                                    fold8=f)
            if f is not None:
                return cur.reshape(-1)
        else:
            t = cur.reshape(g_count, 128, r_l).transpose(1, 2)
            cur = _lane_gather(t.reshape(g_count * r_l, 128),
                               c_stages[lvl])
    # extract
    return cur[:, :K].reshape(R0 * K)[:n]
