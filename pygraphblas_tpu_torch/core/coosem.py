"""GraphBLAS semantics on canonical sorted-COO triples, on the host: the
sparse tier's pair membership, merges, masked writeback, the
extract/assign index plumbing and the Kronecker product.

Counterpart of ``pygraphblas_tpu/core/coosem.py``.  The JAX package
answers sorted queries and merges with its native passes (``_fastio``)
when that is built; the port always takes the numpy searches, which
give the same answer (as ``csrc/benes.cpp`` keeps its own copy of the routing, the
port shares no native module with the JAX package).

All functions take and return numpy arrays; rows and cols int64."""

import numpy as np

_PAIR_DTYPE = np.dtype([("r", np.int64), ("c", np.int64)])


def pairs(rows, cols):
    a = np.empty(len(rows), dtype=_PAIR_DTYPE)
    a["r"] = rows
    a["c"] = cols
    return a


def _key_shift(*col_arrays):
    """Bit width that packs (row, col) pairs into one int64 key, or None
    when the coordinates are too large (structured pairs then)."""
    cmax = 0
    for c in col_arrays:
        if len(c):
            cmax = max(cmax, int(c.max()))
    shift = max(1, int(cmax).bit_length())
    return shift if shift <= 31 else None


def _keys(r, c, shift):
    return (np.asarray(r, np.int64) << shift) | np.asarray(c, np.int64)


def pair_keys(ra, ca, rb, cb):
    """Comparable key arrays for two (row, col) pair sets: packed int64
    when the coordinates fit, structured pairs otherwise."""
    shift = _key_shift(ca, cb)
    if shift is not None and max(
            int(ra.max()) if len(ra) else 0,
            int(rb.max()) if len(rb) else 0).bit_length() + shift < 63:
        return _keys(ra, ca, shift), _keys(rb, cb, shift)
    return pairs(ra, ca), pairs(rb, cb)


def in_sorted(r, c, sr, sc, sorted_queries=False):
    """Boolean membership of (r, c) pairs in the canonical pair set
    (sr, sc).  `sorted_queries` (the queries are canonical too) picks the
    JAX package's native merge pass there; the searches here answer
    either way."""
    if len(sr) == 0 or len(r) == 0:
        return np.zeros(len(r), bool)
    k, sk = pair_keys(r, c, sr, sc)
    pos = np.searchsorted(sk, k)
    pos_c = np.minimum(pos, len(sk) - 1)
    return (pos < len(sk)) & (sk[pos_c] == k)


def _merge_union_idx(ka, kb):
    """Index arrays (ia, ib) over the sorted union of two sorted unique
    key arrays: for union slot i, ia[i] is the position in ka (or -1)
    and ib[i] the position in kb (or -1)."""
    na, nb = len(ka), len(kb)
    pos = np.searchsorted(ka, kb)
    if na:
        hit = (pos < na) & (ka[np.minimum(pos, na - 1)] == kb)
    else:
        hit = np.zeros(nb, bool)
    bk = kb[~hit]
    n_out = na + len(bk)
    ia = np.full(n_out, -1, np.int64)
    ib = np.full(n_out, -1, np.int64)
    pa = np.arange(na) + np.searchsorted(bk, ka)
    ia[pa] = np.arange(na)
    pb = np.arange(len(bk)) + np.searchsorted(ka, bk)
    ib[pb] = np.nonzero(~hit)[0]
    ib[pa[pos[hit]]] = np.nonzero(hit)[0]
    return ia, ib


def _merge_take_first(k1, k2):
    """Merge-order flags of two DISJOINT sorted key arrays: True where
    the merged slot takes the next element of k1."""
    t = np.zeros(len(k1) + len(k2), bool)
    t[np.arange(len(k1)) + np.searchsorted(k2, k1)] = True
    return t


def lex_order(rows, cols):
    """argsort by (row, col): packed-key argsort when ids fit, else
    lexsort."""
    shift = _key_shift(cols)
    if shift is not None and (int(rows.max()) if len(rows) else 0)\
            .bit_length() + shift < 63:
        return np.argsort(_keys(rows, cols, shift), kind="stable")
    return np.lexsort((cols, rows))


def truthy(vals):
    if vals.dtype == np.bool_:
        return vals
    return vals != 0


def mask_pairs(m_rows, m_cols, m_vals, structural):
    """The true-entry pair set of a mask container."""
    if structural:
        return m_rows, m_cols
    t = truthy(np.asarray(m_vals))
    return m_rows[t], m_cols[t]


def union_merge(ra, ca, va, rb, cb, vb, both_fn, dtype):
    """Pattern-union merge: both_fn(a, b) on the intersection, a-only and
    b-only entries pass through (cast to dtype).  Inputs and output
    canonical."""
    if len(ra) == 0:
        return (np.asarray(rb, np.int64).copy(),
                np.asarray(cb, np.int64).copy(), vb.astype(dtype))
    if len(rb) == 0:
        return (np.asarray(ra, np.int64).copy(),
                np.asarray(ca, np.int64).copy(), va.astype(dtype))
    ka, kb = pair_keys(ra, ca, rb, cb)
    ia, ib = _merge_union_idx(ka, kb)
    a_hit = ia >= 0
    b_hit = ib >= 0
    both = a_hit & b_hit
    iac = np.where(a_hit, ia, 0)
    ibc = np.where(b_hit, ib, 0)
    rows = np.where(a_hit, ra[iac], rb[ibc])
    cols = np.where(a_hit, ca[iac], cb[ibc])
    vals = np.empty(len(rows), dtype)
    a_only = a_hit & ~both
    b_only = b_hit & ~both
    vals[a_only] = va[ia[a_only]].astype(dtype)
    vals[b_only] = vb[ib[b_only]].astype(dtype)
    if both.any():
        vals[both] = np.asarray(
            both_fn(va[ia[both]], vb[ib[both]])).astype(dtype)
    return rows, cols, vals


def writeback(cr, cc, cv, tr, tc, tv, mpr, mpc, accum_fn, complement,
              replace, dtype):
    """C<M> (accum)= T on canonical COO triples.

    mpr/mpc: the mask's TRUE pair set (already value-filtered or
    structural), or None for no mask.  accum_fn: vectorized numpy binary
    fn or None.  Returns canonical triples of the new C: Z = accum ?
    union-merge(C, T, accum) : T; inside the effective mask region the
    result takes Z, outside it C is kept (or dropped under `replace`)."""
    cv = np.asarray(cv)
    tv = np.asarray(tv)
    if accum_fn is None:
        zr, zc, zv = tr, tc, tv.astype(dtype)
    else:
        zr, zc, zv = union_merge(cr, cc, cv.astype(dtype), tr, tc, tv,
                                 accum_fn, dtype)

    if mpr is None:
        if not complement:
            return zr, zc, zv
        # complement of "no mask" = empty write region
        if replace:
            e = np.empty(0, np.int64)
            return e, e.copy(), np.empty(0, dtype)
        return cr, cc, cv.astype(dtype)

    z_in = in_sorted(zr, zc, mpr, mpc, sorted_queries=True)
    if complement:
        z_in = ~z_in
    keep_z = (zr[z_in], zc[z_in], zv[z_in])
    if replace:
        return keep_z
    c_in = in_sorted(cr, cc, mpr, mpc, sorted_queries=True)
    if complement:
        c_in = ~c_in
    # outside the mask region C survives; inside, Z's pattern rules.  The
    # two survivor sets are canonical and disjoint: a linear merge
    keep_c = (cr[~c_in], cc[~c_in], cv[~c_in].astype(dtype))
    kz, kc = pair_keys(keep_z[0], keep_z[1], keep_c[0], keep_c[1])
    take_z = _merge_take_first(kz, kc)
    n_out = len(kz) + len(kc)
    out_r = np.empty(n_out, np.int64)
    out_c = np.empty(n_out, np.int64)
    out_v = np.empty(n_out, dtype)
    take_c = ~take_z
    out_r[take_z] = keep_z[0]
    out_r[take_c] = keep_c[0]
    out_c[take_z] = keep_z[1]
    out_c[take_c] = keep_c[1]
    out_v[take_z] = keep_z[2]
    out_v[take_c] = keep_c[2]
    return out_r, out_c, out_v


# ---------------------------------------------------------------------------
# extract / assign index plumbing.  A Selector is the sparse-side form of
# a GraphBLAS index descriptor (base._build_range / IndexSet): which
# source indices are in the set, at what output position, and the
# inverse.  ALL/RANGE/STRIDE/BACKWARDS are arithmetic, so 2^60-sized sets
# cost O(nnz); LIST materializes.
# ---------------------------------------------------------------------------


class ArithSelector:
    """start + p*step for p in [0, size); step < 0 walks backwards."""

    __slots__ = ("start", "step", "size")

    def __init__(self, start, step, size):
        self.start = int(start)
        self.step = int(step)
        self.size = int(size)

    @property
    def monotone(self):
        """True when select()/inverse() preserve index order."""
        return self.step > 0

    def select(self, values):
        """(entry_indices, positions): which of `values` are selected and
        where they land."""
        v = np.asarray(values, np.int64)
        d = v - self.start
        if self.step < 0:
            d = -d
        st = abs(self.step)
        keep = (d >= 0) & (d % st == 0) & (d // st < self.size)
        ent = np.nonzero(keep)[0]
        return ent, (d[ent] // st)

    select_sorted = select

    def inverse(self, positions):
        return self.start + np.asarray(positions, np.int64) * self.step


class ListSelector:
    """Explicit index vector (duplicates fan out on select)."""

    __slots__ = ("arr", "size", "_sorted", "_order")

    def __init__(self, arr):
        self.arr = np.asarray(arr, np.int64)
        self.size = len(self.arr)
        self._order = np.argsort(self.arr, kind="stable")
        self._sorted = self.arr[self._order]

    @property
    def monotone(self):
        return bool(np.all(np.diff(self.arr) > 0))

    def select(self, values):
        return _positions(self._sorted, self._order, values)

    def select_sorted(self, values):
        """select() for `values` sorted ascending (a canonical COO's
        rows): each list entry's run of equal values by two searches of
        `values`, O(k log nnz) and not O(nnz log k); the pairs come in
        list order, which is `values`' order when the list ascends."""
        lo = np.searchsorted(values, self.arr, side="left")
        cnt = np.searchsorted(values, self.arr, side="right") - lo
        total = int(cnt.sum())
        pos = np.repeat(np.arange(self.size, dtype=np.int64), cnt)
        run0 = np.repeat(np.cumsum(cnt) - cnt, cnt)
        return np.repeat(lo, cnt) + (np.arange(total) - run0), pos

    def inverse(self, positions):
        return self.arr[np.asarray(positions, np.int64)]


def selector(iset, dim_size):
    """Compile a base.IndexSet into a Selector against a dimension."""
    kind = iset.kind
    if kind == "all":
        return ArithSelector(0, 1, dim_size)
    if kind == "list":
        return ListSelector(iset.list)
    if kind == "range":
        return ArithSelector(iset.start, 1, iset.size)
    if kind == "stride":
        return ArithSelector(iset.start, iset.step, iset.size)
    return ArithSelector(iset.start, -iset.step, iset.size)  # backwards


def _positions(sorted_I, order, values):
    """For each value, the positions a with I[a] == value, as
    (expanded_entry_index, position) arrays."""
    lo = np.searchsorted(sorted_I, values, side="left")
    hi = np.searchsorted(sorted_I, values, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    ent = np.repeat(np.arange(len(values)), cnt)
    if total == 0:
        return ent, np.empty(0, np.int64)
    starts = np.repeat(lo, cnt)
    run0 = np.repeat(np.cumsum(cnt) - cnt, cnt)
    offs = starts + (np.arange(total) - run0)
    return ent, order[offs]


def extract(rows, cols, vals, sel_r, sel_c):
    """out[a, b] = A[I[a], J[b]] on canonical triples, with I/J given as
    Selectors; LIST duplicates fan entries out.  Returns canonical
    triples in output coordinates."""
    ent_r, pos_r = sel_r.select_sorted(rows)
    r2 = pos_r
    c_src = cols[ent_r]
    v_src = vals[ent_r]
    ent_c, pos_c = sel_c.select(c_src)
    out_r = r2[ent_c]
    out_c = pos_c
    out_v = v_src[ent_c]
    if sel_r.monotone and sel_c.monotone:
        return out_r, out_c, out_v
    order = lex_order(out_r, out_c)
    return out_r[order], out_c[order], out_v[order]


def _region_map(sel_r, sel_c, rows, cols):
    """(inside_mask, region_rows, region_cols) for entries against a
    duplicate-free selector pair."""
    ent_r, pos_r = sel_r.select(rows)
    in_r = np.zeros(len(rows), bool)
    in_r[ent_r] = True
    rpos = np.zeros(len(rows), np.int64)
    rpos[ent_r] = pos_r
    ent_c, pos_c = sel_c.select(cols)
    in_c = np.zeros(len(cols), bool)
    in_c[ent_c] = True
    cpos = np.zeros(len(cols), np.int64)
    cpos[ent_c] = pos_c
    return in_r & in_c, rpos, cpos


def assign_region(cr, cc, cv, tr, tc, tv, sel_r, sel_c, mpr, mpc,
                  accum_fn, complement, replace, dtype):
    """C(I, J)<M> (accum)= T: GrB_assign semantics on canonical triples.

    T is in region coordinates (sel_r.size x sel_c.size); the mask pair
    set (mpr/mpc) is in C coordinates (or None).  Only the region of C
    changes (the mask applies restricted to the region).  Selectors must
    be duplicate-free."""
    monotone = sel_r.monotone and sel_c.monotone
    inside, rpos, cpos = _region_map(sel_r, sel_c, cr, cc)
    reg_cr = rpos[inside]
    reg_cc = cpos[inside]
    reg_cv = cv[inside]
    if not monotone:
        order = lex_order(reg_cr, reg_cc)
        reg_cr, reg_cc, reg_cv = reg_cr[order], reg_cc[order], reg_cv[order]

    if mpr is not None:
        m_in, m_rpos, m_cpos = _region_map(sel_r, sel_c, mpr, mpc)
        rm, cm = m_rpos[m_in], m_cpos[m_in]
        if not monotone:
            m_order = lex_order(rm, cm)
            rm, cm = rm[m_order], cm[m_order]
        rmpr, rmpc = rm, cm
    else:
        rmpr = rmpc = None

    nr, nc, nv = writeback(reg_cr, reg_cc, reg_cv, tr, tc, tv,
                           rmpr, rmpc, accum_fn, complement, replace, dtype)

    # the region's result back in C coordinates; C outside it kept
    keep_r, keep_c_ = cr[~inside], cc[~inside]
    inv_r, inv_c = sel_r.inverse(nr), sel_c.inverse(nc)
    if monotone:
        kk, ki = pair_keys(keep_r, keep_c_, inv_r, inv_c)
        take_k = _merge_take_first(kk, ki)
        n_out = len(kk) + len(ki)
        out_r = np.empty(n_out, np.int64)
        out_c = np.empty(n_out, np.int64)
        out_v = np.empty(n_out, dtype)
        take_i = ~take_k
        out_r[take_k] = keep_r
        out_r[take_i] = inv_r
        out_c[take_k] = keep_c_
        out_c[take_i] = inv_c
        out_v[take_k] = cv[~inside].astype(dtype)
        out_v[take_i] = nv
        return out_r, out_c, out_v
    out_r = np.concatenate([keep_r, inv_r])
    out_c = np.concatenate([keep_c_, inv_c])
    out_v = np.concatenate([cv[~inside].astype(dtype), nv])
    order = lex_order(out_r, out_c)
    return out_r[order], out_c[order], out_v[order]


def kron(ra, ca, va, rb, cb, vb, b_nrows, b_ncols, mul_fn, dtype):
    """Kronecker product on canonical triples: out[(ia*bn + ib),
    (ja*bm + jb)] = mul(a, b), canonical."""
    na, nb = len(ra), len(rb)
    if na == 0 or nb == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, dtype)
    A = np.repeat(np.arange(na), nb)
    B = np.tile(np.arange(nb), na)
    out_r = ra[A] * b_nrows + rb[B]
    out_c = ca[A] * b_ncols + cb[B]
    out_v = np.asarray(mul_fn(va[A], vb[B])).astype(dtype)
    order = lex_order(out_r, out_c)
    return out_r[order], out_c[order], out_v[order]
