"""Hand-made kernel inputs, shared by the GPU tests
(tests/test_torch_cuda.py) and chip_smoke.py, which hold the kernels
against their plain versions on them (numpy arrays: the callers move
them to the device they test), the index recipe by which one
``torch.take`` computes a kernel that only moves data (`take_index`),
and the GraphChallenge DNN's test data: RadiX-Net layers, biases and
images from a seed (`radix_net`, `build_biases`, `fullscale_images`; the
same matrices as the JAX package's ``demo/dnn``) with the scipy oracle
of the challenge's recurrence (`scipy_dnn_oracle`); `RankPool`,
spawned gloo ranks on the CPU that run the distributed tier's jobs
(``job_*``) in lockstep for its tests; and `logsum32`, the user-defined
semiring that the generated kernels' tests and chip_smoke use."""

import functools
import math

import numpy as np
import torch

PAIR_COUNT_CASES = ("run_across_blocks", "runs_of_one_128",
                    "runs_of_one_256", "alternating", "longer_32768",
                    "past_the_bitmap", "b_over_8x_a", "empty_lists",
                    "longer_b", "disjoint")


def pair_count_case(kind):
    """Hand-made pair_count inputs, as numpy arrays: (a, b, ast, wa, bst,
    wb, width), the column arrays the concatenations of sorted, unique
    lists.  B lists take part of an A list, so that they meet.  The
    kinds (PAIR_COUNT_CASES) probe the kernel's runs of edges that share
    a longer list: one run across 512-edge blocks, runs of one edge
    (widths 128 and 256: the path of 4 and 8 lanes an edge), lists
    alternating singly then by 20s, a longer list of exactly 32768 ids
    (in a run of 40 and a run of 3), ids spanning six bitmap windows, a
    short A list shared by a run whose B lists hold mostly over 8x its
    ids (A's ids searched in B's list; A's ids over six windows, then
    over windows past the first), empty lists, the longer list on B's
    side, and lists with no common id."""
    rng = np.random.RandomState(len(kind))
    a_lists, b_lists, edges = [], [], []

    def lst(n, hi, base=None, share=0.5):
        if base is not None and n:
            k = min(len(base), int(n * share))
            part = rng.choice(base, k, replace=False) if k else []
            extra = rng.choice(hi, n, replace=False)
            return np.unique(np.concatenate([part, extra]))[:n]
        return np.sort(rng.choice(hi, n, replace=False))

    def add(lists, x):
        lists.append(np.asarray(x, np.int64))
        return len(lists) - 1

    if kind == "run_across_blocks":        # one A list for 1100 edges
        W, la = 1024, add(a_lists, lst(600, 5000))
        for _ in range(1100):
            edges.append((la, add(b_lists, lst(rng.randint(0, 301), 5000,
                                               a_lists[la]))))
    elif kind.startswith("runs_of_one"):   # every edge its own lists
        W = int(kind.split("_")[-1])
        for _ in range(600):
            la = add(a_lists, lst(rng.randint(W // 4, W // 2 + 1), 4 * W))
            edges.append((la, add(b_lists, lst(rng.randint(0, W // 2),
                                               4 * W, a_lists[la]))))
    elif kind == "alternating":            # A B A singly, then by 20s
        W, l0, l1 = 512, add(a_lists, lst(250, 3000)), add(a_lists,
                                                          lst(250, 3000))
        for i in range(200):
            la = (l0, l1)[i % 2]
            edges.append((la, add(b_lists, lst(rng.randint(0, 251), 3000,
                                               a_lists[la]))))
        for i in range(400):
            la = (l0, l1)[(i // 20) % 2]
            edges.append((la, add(b_lists, lst(rng.randint(0, 251), 3000,
                                               a_lists[la]))))
    elif kind == "longer_32768":           # a run of 40, a run of 3
        W = 65536
        for n_edges in (40, 3):
            la = add(a_lists, lst(32768, 200_000))
            for _ in range(n_edges):
                edges.append((la, add(b_lists, lst(rng.randint(1, 501),
                                                   200_000, a_lists[la]))))
    elif kind == "past_the_bitmap":        # ids span 1.5M: six windows
        W = 65536
        la = add(a_lists, lst(40_000, 1_500_000))
        for _ in range(50):
            edges.append((la, add(b_lists, lst(rng.randint(1, 2001),
                                               1_500_000, a_lists[la]))))
    elif kind == "b_over_8x_a":            # 40 A ids; B mostly > 320 ids
        W = 8192
        for lo, n_edges in ((0, 30), (600_000, 9)):
            la = add(a_lists, lo + lst(40, 1_500_000 - lo))
            for i in range(n_edges):
                nb = rng.randint(1, 321) if i % 5 == 4 else \
                    rng.randint(321, 4001)
                part = rng.choice(a_lists[la], rng.randint(0, 41),
                                  replace=False)
                extra = lo + rng.choice(1_500_000 - lo, nb, replace=False)
                edges.append((la, add(b_lists, np.unique(
                    np.concatenate([part, extra]))[:nb])))
    elif kind == "empty_lists":            # wb = 0, wa = 0, both, singly
        W = 512
        la, lb = add(a_lists, lst(100, 1000)), add(b_lists, lst(100, 1000))
        ea, eb = add(a_lists, []), add(b_lists, [])
        edges += [(la, eb)] * 20 + [(ea, lb)] * 20 + [(ea, eb)] * 20
        edges += [(la, eb), (ea, lb), (ea, eb), (la, lb)]
    elif kind == "longer_b":               # B's list shared, then singly
        W = 1024
        lb = add(b_lists, lst(600, 5000))
        for _ in range(100):
            edges.append((add(a_lists, lst(rng.randint(0, 301), 5000,
                                           b_lists[lb])), lb))
        for _ in range(10):
            lb2 = add(b_lists, lst(500, 5000))
            edges.append((add(a_lists, lst(200, 5000, b_lists[lb2])), lb2))
    elif kind == "disjoint":               # even ids against odd ids
        W, la = 512, add(a_lists, 2 * lst(200, 2000))
        for i in range(60):
            src = la if i < 30 else add(a_lists, 2 * lst(200, 2000))
            edges.append((src, add(b_lists, 2 * lst(rng.randint(0, 201),
                                                    2000) + 1)))
    else:
        raise ValueError(kind)

    def pack(lists):
        starts = np.cumsum([0] + [len(x) for x in lists])[:-1]
        cols = np.concatenate(lists + [np.zeros(1, np.int64)])
        return cols.astype(np.int32), starts

    a, a_starts = pack(a_lists)
    b, b_starts = pack(b_lists)
    ia, ib = (np.array(x) for x in zip(*edges))
    wa = np.array([len(a_lists[i]) for i in ia])
    wb = np.array([len(b_lists[i]) for i in ib])
    assert (wa + wb).max() <= W
    return [a, b] + [x.astype(np.int32) for x in
                     (a_starts[ia], wa, b_starts[ib], wb)] + [W]


def pair_fold_case(kind, dtype=np.float32):
    """pair_count_case(kind) with values: (a, av, b, bv, ast, wa, bst, wb,
    width), numpy arrays.  Values are made from a seed: float32 in
    [0.5, 4.5) (no zero divisor), int32 in [-9, 9]."""
    a, b, ast, wa, bst, wb, width = pair_count_case(kind)
    rng = np.random.RandomState(7 + len(kind))

    def vals(n):
        if np.dtype(dtype) == np.float32:
            return (rng.rand(n) * 4 + 0.5).astype(np.float32)
        return rng.randint(-9, 10, n).astype(np.int32)

    return a, vals(len(a)), b, vals(len(b)), ast, wa, bst, wb, width


# mono_rows' hand-made index vectors, by kind: the plan each must build
# (per-row encoding: build with core/mono.py's _SPAN_MAX_WVA at 0)
MONO_ROWS_CASES = {
    "stream_straddle": dict(stream=True, dm="int16"),
    "stream_int32": dict(stream=True, dm="int32"),
    "wide_rows": dict(stream=False, dm="int16"),
    "empty_groups": dict(stream=False, dm="int16"),
    "few_groups": dict(stream=False, dm="int16"),
    "resident_int32": dict(stream=False, dm="int32"),
}


def mono_rows_case(kind):
    """A non-decreasing gather index (-1: invalid) and its source length
    for mono_rows (MONO_ROWS_CASES): a streamed plan whose row blocks'
    windows straddle two source blocks of xb rows; a streamed plan with
    int32 dm (one row spreads its 128 ids over 40,000 cells); rows each
    spanning several 128-cell windows; whole 8-row groups of invalid
    lanes between valid ones; one block of 64 rows (8 groups: fewer than
    a block of the kernel takes); and a resident plan with int32 dm."""
    rng = np.random.RandomState(31 + len(kind))

    def sorted_ids(n, lo, hi):
        return np.sort(rng.randint(lo, hi, n))

    if kind == "stream_straddle":
        src_n = 3_000_000
        idx = sorted_ids(3 * 64 * 128, 0, 1_500_000)
        idx[::13] = -1
    elif kind == "stream_int32":
        src_n = 3_000_000
        idx = sorted_ids(2 * 64 * 128, 0, 1_000_000)
        wide = np.sort(rng.choice(40_000, 128, replace=False))
        idx[64 * 128:65 * 128] = idx[64 * 128 - 1] + wide
        idx[65 * 128:] = np.sort(idx[65 * 128:]) + 40_000
        idx[::17] = -1
    elif kind == "wide_rows":
        src_n = 200_000
        idx = sorted_ids(64 * 128, 0, src_n)        # ~3 windows a row
        idx[::5] = -1
    elif kind == "empty_groups":
        src_n = 40_000
        idx = sorted_ids(4 * 64 * 128, 0, src_n)
        for g in (0, 3, 4, 17, 31):                 # groups of 1024 lanes
            idx[g * 1024:(g + 1) * 1024] = -1
    elif kind == "few_groups":
        src_n = 9000
        idx = sorted_ids(5000, 0, src_n)
        idx[::3] = -1
    elif kind == "resident_int32":
        src_n = 2_500_000
        idx = sorted_ids(64 * 128, 0, src_n)
        idx[::7] = -1
    else:
        raise ValueError(kind)
    return idx.astype(np.int64), src_n


def cascade_runs_case():
    """Rows for the fold cascade's kernel (core/mono.py:fold_plans takes
    them): (nrows, present rows, level-0 run lengths).  Runs of 1, 8, 9
    and 64 cells (a thread's path), 65, 600 and 1024 (a warp's), 1025,
    2100, 4096 and 5000 (the block's: part of a 2048-cell round, two
    whole rounds, past a block's 2048 staged cells and past 8^4 cells,
    so 5 levels) among random runs of 1-11 cells, with absent rows
    between them."""
    rng = np.random.RandomState(9)
    counts = rng.randint(1, 12, 300)
    counts[[0, 5, 17, 40, 41, 60, 61, 99, 150, 200, 299]] = [
        1, 8, 9, 64, 65, 1024, 1025, 600, 2100, 4096, 5000]
    nrows = 700
    present = np.sort(rng.choice(nrows, len(counts), replace=False))
    return nrows, present, counts


def take_index(plain, shape, device=None):
    """The int64 index at which one ``torch.take`` of ``take_source(x,
    fill)`` equals ``plain(x)`` for every x of `shape`, where `plain` only
    moves data (a gather, a transpose, a select: no fold, no mul).  It
    runs `plain` over an int32 input holding 1..n, so that each output
    holds 1 + the position it reads; a 0 there (a fill, or a select out
    of range, which gives 0) reads the pad cell n that `take_source`
    appends."""
    n = int(np.prod(shape))
    ids = torch.arange(1, n + 1, dtype=torch.int32,
                       device=device).reshape(shape)
    pos = plain(ids).reshape(-1).long()
    return torch.where(pos == 0, n, pos - 1)


def take_source(x, fill=0):
    """x flattened, with the pad cell `fill` appended (see take_index)."""
    return torch.cat([x.reshape(-1),
                      torch.full((1,), fill, dtype=x.dtype, device=x.device)])


# The algebra's SpGEMM cases: (semiring, type) and the values each takes
# (tests/test_torch_{esc,spgemm,gustavson}.py and chip_smoke's sr14)
SR_CASES = [("LOR_LAND", "BOOL"), ("MIN_PLUS", "UINT8"),
            ("PLUS_TIMES", "INT16"), ("BOR_BAND", "UINT32"),
            ("ANY_PAIR", "INT8"), ("PLUS_ISLT", "FP32")]


def sr_values(typ, n, seed):
    """n values of GraphBLAS type name `typ` for the SR_CASES, from a
    seed: BOOL mostly true, INT8 -100..99, INT16 1..4 (its sums stay in
    range at kron-14), UINT8 1..100, UINT32 any 32 bits, INT32 0..4 (zero
    divisors for PLUS_DIV), FP32 in [-2, 2)."""
    rng = np.random.RandomState(seed)
    if typ == "BOOL":
        return rng.rand(n) < 0.8
    if typ == "FP32":
        return (rng.rand(n) * 4 - 2).astype(np.float32)
    lo, hi, dt = {"INT8": (-100, 100, np.int8), "INT16": (1, 5, np.int16),
                  "UINT8": (1, 101, np.uint8),
                  "UINT32": (0, 1 << 32, np.uint32),
                  "INT32": (0, 5, np.int32)}[typ]
    return rng.randint(lo, hi, n, dtype=np.int64).astype(dt)


def typed_values(rng, T, *shape):
    """Values of GraphBLAS type T (its held dtype, on the CPU) over the
    type's whole range, so about half have the top bit set."""
    dt = T.numpy_dtype
    if dt == np.bool_:
        return T.to_torch(rng.rand(*shape) < 0.5)
    if dt.kind == "f":
        return T.to_torch(rng.rand(*shape) * 8 - 4)
    info = np.iinfo(dt)
    return T.to_torch(rng.randint(int(info.min), int(info.max) + 1, shape,
                                  dtype=np.int64).astype(dt))


def wrapper_cases(typ, device, seed=0):
    """Every kernel wrapper at GraphBLAS type name `typ` (INT8, UINT16,
    UINT32, BOOL ...) on small inputs on `device`: [(kernel name, case,
    call)], where call(wrapper or its plain version) runs one of them
    (``typed_plains`` maps each wrapper to its plain version).  Folds
    MIN and MAX (LAND and LOR over BOOL) in the type's own order, a mul,
    the permutations, segfold, esc_gather and pair_fold (PLUS_TIMES; LOR
    _LAND over BOOL), and the cascade."""
    from . import types
    from .core import esc, mono, scan, spgemm

    T = getattr(types, typ)
    rng = np.random.RandomState(seed + len(typ))
    lo = T.LAND_MONOID if typ == "BOOL" else T.MIN_MONOID
    hi = T.LOR_MONOID if typ == "BOOL" else T.MAX_MONOID
    ident = T.scalar(lo.identity(T.numpy_dtype))
    mul = T.LAND if typ == "BOOL" else T.PLUS

    def vals(*shape):
        return typed_values(rng, T, *shape).to(device)

    def lanes(*shape):
        return torch.from_numpy(rng.randint(0, 128, shape)
                                .astype(np.int8)).to(device)

    idx = np.sort(rng.randint(0, 9000, 64 * 128))
    idx[::11] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    span = mono.MonoPlan.build(idx, 9000).to(device)
    saved = mono._SPAN_MAX_WVA
    mono._SPAN_MAX_WVA = 0
    try:
        rows = mono.MonoPlan.build(np.sort(rng.randint(0, 9000, 64 * 128)),
                                   9000).to(device)
    finally:
        mono._SPAN_MAX_WVA = saved
    src, sv = vals(9000), vals(64 * 128)
    g, S = 2, 3
    r_l = S * 128
    x = vals(g * r_l, 128)
    ix = [lanes(g * r_l, 128) for _ in range(4)]
    ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                            .astype(np.int8)).to(device)
    x3 = x.reshape(g * 128, S, 128)
    inner = (ix[0], ix[1], ssel, ix[2], ix[3], g, S)
    flags = torch.from_numpy(rng.rand(8192) < 0.05).to(device)
    flags[0] = True
    seg = vals(8192)
    nrows, present, counts = cascade_runs_case()
    levels, place = mono.fold_plans(counts, nrows, present)
    levels = [lp.to(device) for lp in levels]
    place = place.to(device)
    cur = vals(int(np.sum(counts)))
    cols2d = torch.from_numpy(rng.randint(0, 1 << 20, (64, 128))
                              .astype(np.int32)).to(device)
    v2d = vals(64, 128)
    qg = torch.from_numpy(rng.randint(0, 32, 4).astype(np.int32)).to(device)
    dm = torch.from_numpy(rng.randint(0, 4 * 128, (32, 128))
                          .astype(np.int32)).to(device)
    a, _, b, _, ast, wa, bst, wb, W = pair_fold_case("run_across_blocks",
                                                     np.int32)
    a, b, ast, wa, bst, wb = (torch.from_numpy(v).to(device)
                              for v in (a, b, ast, wa, bst, wb))
    av, bv = vals(a.numel()), vals(b.numel())
    fmul = T.LAND if typ == "BOOL" else T.TIMES
    fadd = T.LOR_MONOID if typ == "BOOL" else T.PLUS_MONOID

    def cascade(f):
        if f is mono.mono_cascade:
            return f(levels, place, cur, ident, lo)
        c2 = cur
        for lp in levels:
            c2 = mono.mono_gather_plain(lp, c2.reshape(-1), ident,
                                        fold=lo).reshape(-1)
        return mono.mono_gather_plain(place, c2, ident)

    return [
        ("mono_span", f"{typ} fold {lo.name}",
         lambda f: f(span, src, ident, fold=lo)),
        ("mono_span", f"{typ} mul {mul.name} fold {hi.name}",
         lambda f: f(span, src, ident, vals=sv, mul=mul, fold=hi)),
        ("mono_rows", f"{typ} fold {lo.name}",
         lambda f: f(rows, src, ident, fold=lo)),
        ("mono_rows", f"{typ} mul {mul.name}",
         lambda f: f(rows, src, ident, vals=sv, mul=mul)),
        ("mono_cascade", f"{typ} runs 1..5000 {lo.name}", cascade),
        ("lane_gather", f"{typ} (768, 128)", lambda f: f(x, ix[0])),
        ("lane_gather_tdesc", f"{typ} g=2 r_l=384",
         lambda f: f(x, ix[0], g, r_l)),
        ("lane_gather_tasc", f"{typ} g=2 r_l=384 fold {hi.name}",
         lambda f: f(x, ix[1], g, r_l, hi)),
        ("lane_gather_tasc", f"{typ} g=2 r_l=384",
         lambda f: f(x, ix[1], g, r_l)),
        ("inner3", f"{typ} g=2 S=3", lambda f: f(x, *inner)),
        ("mid_pass", f"{typ} nsub=256 S=3",
         lambda f: f(x3, ix[2], ssel, ix[3])),
        ("segfold", f"{typ} {lo.name} M=8192", lambda f: f(seg, flags, lo)),
        ("esc_gather", f"{typ} S=32", lambda f: f(cols2d, v2d, qg, dm)),
        ("pair_fold", f"{typ} {fadd.op}_{fmul.op} W={W}",
         lambda f: f(a, av, b, bv, ast, wa, bst, wb, W, fmul, fadd)),
    ]


def typed_plains():
    """Each kernel wrapper -> its plain version (wrapper_cases' calls
    take either)."""
    from .core import esc, mono, perm, scan, spgemm

    return {mono.mono_span: mono.mono_gather_plain,
            mono.mono_rows: mono.mono_gather_plain,
            mono.mono_cascade: None,
            perm._lane_gather: perm._lane_gather_plain,
            perm._lane_gather_tdesc: perm._tdesc_plain,
            perm._lane_gather_tasc: perm._tasc_plain,
            perm._inner3: perm._inner3_plain,
            perm._mid_pass: perm._mid_pass_plain,
            scan.segfold: scan._segfold_plain,
            esc.esc_gather: esc._esc_gather_plain,
            spgemm.pair_fold: spgemm._pair_fold_plain}


def typed_wrappers():
    """Kernel name -> its wrapper, for wrapper_cases' calls."""
    from .core import esc, mono, perm, scan, spgemm

    return {"mono_span": mono.mono_span, "mono_rows": mono.mono_rows,
            "mono_cascade": mono.mono_cascade,
            "lane_gather": perm._lane_gather,
            "lane_gather_tdesc": perm._lane_gather_tdesc,
            "lane_gather_tasc": perm._lane_gather_tasc,
            "inner3": perm._inner3, "mid_pass": perm._mid_pass,
            "segfold": scan.segfold, "esc_gather": esc.esc_gather,
            "pair_fold": spgemm.pair_fold}


# segfold's fold codes the algebra adds, at the types of its paths
SEGFOLD_CODES = [("LOR", "BOOL"), ("LAND", "BOOL"), ("LXOR", "BOOL"),
                 ("EQ", "BOOL"), ("ANY", "BOOL"), ("ANY", "INT8"),
                 ("ANY", "FP32"), ("ANY", "UINT32"), ("BOR", "UINT32"),
                 ("BAND", "UINT32"), ("BXOR", "UINT16"), ("BXNOR", "UINT8"),
                 ("MIN", "UINT32"), ("MAX", "UINT32"), ("MIN", "UINT16"),
                 ("MAX", "INT16"), ("MIN", "INT8"), ("TIMES", "INT8"),
                 ("PLUS", "UINT16"), ("PLUS", "INT16"), ("MAX", "UINT8")]

# pair_fold's mul codes the algebra adds (and DIV at narrow types, whose
# x / 0 saturates there) and the ANY fold, as (add, mul, type)
PAIR_FOLD_CODES = [(add, mul, typ)
                   for mul in ("ISEQ", "ISNE", "ISGT", "ISLT", "ISGE",
                               "ISLE", "LOR", "LAND", "LXOR", "DIV", "RDIV")
                   for add, typ in (("PLUS", "INT16"), ("MAX", "INT8"),
                                    ("MIN", "FP32"))] + [
    ("ANY", "TIMES", "INT32"), ("ANY", "PLUS", "FP32"),
    ("ANY", "MINUS", "INT8"), ("MIN", "DIV", "UINT32"),
    ("MAX", "TIMES", "UINT16"), ("PLUS", "TIMES", "UINT8")] + [
    # the muls coded for the valued path's JAX rule, at every type of 4
    # bytes or less each takes (ops/table.py), folded exactly
    ({"FP32": "MIN", "BOOL": "LOR"}.get(typ, "PLUS"), mul, typ)
    for mul, typs in (("POW", ("BOOL", "INT8", "INT16", "INT32", "UINT8",
                               "UINT16", "UINT32", "FP32")),
                      *((m, ("INT8", "INT16", "INT32", "UINT8", "UINT16",
                             "UINT32"))
                        for m in ("BOR", "BAND", "BXOR", "BXNOR", "BGET",
                                  "BSET", "BCLR", "BSHIFT")),
                      *((m, ("FP32",))
                        for m in ("ATAN2", "HYPOT", "FMOD", "REMAINDER",
                                  "LDEXP", "COPYSIGN")))
    for typ in typs]
# the FP32 muls whose device functions (powf, atan2f, hypotf) round
# within a few ulp of torch's: held within rtol 1e-5
PAIR_FOLD_INEXACT = ("POW", "ATAN2", "HYPOT")

# integer POW and BSHIFT operands where the JAX package's rule differs
# from squaring over every bit of the exponent or negating in int64
# (ops/table.py: _ipow, _bshift): bases, and exponents of 64 and more,
# the type's minimum and BSHIFT's -2^31, each wrapped to the type
POW_BASES = (3, 2, -2, -6, 0, 1, -1, 8, 7, 5)
POW_EXPONENTS = (64, 65, 70, 100, 127, -128, -(1 << 31), (1 << 31) - 1, 63,
                 71, -1, -2, 0, 5)
# pair_fold's integer POW and BSHIFT rows, held at those operands
POW_EXTREME_CODES = [c for c in PAIR_FOLD_CODES
                     if c[1] in ("POW", "BSHIFT")
                     and c[2] not in ("BOOL", "FP32")]


def pow_operands(T, nx, ny, seed=16):
    """nx bases and ny exponents of integer Type T drawn from POW_BASES
    and POW_EXPONENTS: numpy arrays of T.numpy_dtype, wrapped."""
    rng = np.random.RandomState(seed)

    def pick(pool, n):
        v = np.array(pool, np.int64)[rng.randint(0, len(pool), n)]
        return v.astype(T.numpy_dtype)

    return pick(POW_BASES, nx), pick(POW_EXPONENTS, ny)


@functools.lru_cache(maxsize=None)
def int_pow32():
    """The user op x ** y at INT32 (jnp.power's six-bit rule on both of
    the port's routes; ``csrc/gen.cuh``'s ``ipow`` in a generated
    kernel).  One object a process, so that its unit is built once."""
    from . import types
    from .binaryop import binary_op

    return binary_op(types.INT32)(lambda x, y: x ** y)


@functools.lru_cache(maxsize=None)
def logsum32():
    """The user semiring "LogSum32" at FP32, over log-space values (log
    p): the multiply x + y, the add monoid the log-add-exp
    where(x == y, x + ln 2, max(x, y) + log1p(exp(-|x - y|))) with
    identity -inf (NaN-free where both operands are -inf, unlike
    x + log1p(exp(y - x))).  One object a process, so that its
    generated kernels are built once."""
    from . import types
    from .binaryop import binary_op

    ln2 = math.log(2.0)

    @binary_op(types.FP32)
    def logsum(x, y):
        return torch.where(x == y, x + ln2, torch.maximum(x, y)
                           + torch.log1p(torch.exp(-torch.abs(x - y))))

    @binary_op(types.FP32)
    def logmul(x, y):
        return x + y

    monoid = types.FP32.new_monoid(logsum, float("-inf"))
    return types.FP32.new_semiring(monoid, logmul)


# ---------------------------------------------------------------------------
# GraphChallenge sparse DNN test data (demo/dnn/radix.py, challenge.py)
# ---------------------------------------------------------------------------

def radix_topology(radices):
    """A list of (rows, cols) edge lists, one per layer, of a RadiX-Net
    with the given mixed radices (n = prod(radices) neurons): each
    layer a permuted butterfly, so that every input reaches every output
    in len(radices) layers with uniform in- and out-degree."""
    n = int(np.prod(radices))
    layers = []
    stride = 1
    for r in radices:
        src = np.arange(n)
        # each neuron connects to r neighbours in its radix group
        offsets = np.arange(r) * stride
        group = (src // (stride * r)) * (stride * r)
        pos = src % stride
        dst = group[:, None] + pos[:, None] + offsets[None, :]
        rows = np.repeat(src, r)
        cols = dst.reshape(-1)
        layers.append((rows, cols % n))
        stride *= r
    return n, layers


def radix_net(radices, nlayers, typ=None, weight=None, seed=42,
              device=None):
    """`nlayers` weight matrices cycling over the butterfly topology:
    (n, [Matrix, ...]), values `weight` or uniform in [0, 1) from
    `seed`."""
    from . import types
    from .matrix import Matrix

    typ = typ or types.FP32
    n, topo = radix_topology(radices)
    rng = np.random.RandomState(seed)
    mats = []
    for layer in range(nlayers):
        rows, cols = topo[layer % len(topo)]
        if weight is None:
            vals = rng.rand(len(rows)).astype(typ._numpy_t)
        else:
            vals = np.full(len(rows), weight, typ._numpy_t)
        W = Matrix.sparse(typ, n, n, device=device)
        W._build(rows, cols, vals)
        mats.append(W)
    return n, mats


def build_biases(nneurons, nlayers, bias, device=None):
    """One bias diagonal a layer (``Matrix.identity`` at `bias`)."""
    from . import types
    from .matrix import Matrix

    return [Matrix.identity(types.FP32, nneurons, value=bias, device=device)
            for _ in range(nlayers)]


def fullscale_radices(nneurons):
    """The radices of ``run_fullscale``'s exact-radix network (largest
    radix of 32, 16, 8, 4, 2 first) and its weight, 4 / the smallest
    radix: an exact binary fraction."""
    radices = []
    n = nneurons
    while n > 1:
        for r in (32, 16, 8, 4, 2):
            if n % r == 0:
                radices.append(r)
                n //= r
                break
    return radices, 4.0 / min(radices)


def fullscale_images(nimages, n, seed=7):
    """``run_fullscale``'s binary images: row fill uniform in [0, 0.3)
    of n, columns uniform, duplicates dropped.  (rows, cols, vals) as
    numpy int64, int64, float32."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max(2, int(0.3 * n)), nimages)
    img_r = np.repeat(np.arange(nimages), counts)
    img_c = rng.randint(0, n, counts.sum())
    keys = img_r.astype(np.int64) * n + img_c
    _, first = np.unique(keys, return_index=True)
    img_r, img_c = img_r[first], img_c[first]
    return (img_r.astype(np.int64), img_c.astype(np.int64),
            np.ones(len(img_r), np.float32))


def scipy_dnn_oracle(img_r, img_c, img_v, layer_triples, nfeat, n, bias):
    """The GraphChallenge recurrence Y = clip32(relu(Y @ W + bias on the
    product's pattern)) in scipy (challenge.py:_scipy_dnn_oracle)."""
    from scipy import sparse as sp

    Y = sp.coo_matrix((img_v, (img_r, img_c)), shape=(nfeat, n)).tocsr()
    for (wr, wc, wv) in layer_triples:
        W = sp.coo_matrix((wv, (wr, wc)), shape=(n, n)).tocsr()
        Y = (Y @ W).tocsr()
        Y.data += np.float32(bias)      # bias on the product pattern
        Y.data = np.minimum(np.maximum(Y.data, 0), 32).astype(np.float32)
        Y.eliminate_zeros()
    return Y


def write_challenge_dataset(ndir, nneurons, nlayers, nimages, bias, seed=7):
    """A small dataset in the GraphChallenge layout under `ndir` (TSV
    lines ``row<TAB>col<TAB>value``, 1-based): ``run_fullscale``'s RadiX
    net at `nneurons` as ``neuron{n}/n{n}-l{i}.tsv``, `nimages` of its
    images as ``sparse-images-{n}.tsv`` (rows of the challenge's 60,000
    features), and the categories ``scipy_dnn_oracle`` gives at `bias`
    as ``DNN/neuron{n}-l{L}-categories.tsv`` (1-based lines).  Returns
    the categories, 0-based.  An image that some neuron's input puts on
    the ReLU threshold in exact arithmetic (within 1e-5 of it, computed
    in float64) is left out: float32 rounding, in whatever order a
    product sums, decides its category."""
    import os

    from scipy import sparse as sp

    radices, weight = fullscale_radices(nneurons)
    n, topo = radix_topology(radices)
    os.makedirs(os.path.join(ndir, f"neuron{n}"), exist_ok=True)
    os.makedirs(os.path.join(ndir, "DNN"), exist_ok=True)
    triples = []
    for i in range(nlayers):
        r, c = topo[i % len(topo)]
        v = np.full(len(r), weight, np.float32)
        triples.append((r, c, v))
        np.savetxt(os.path.join(ndir, f"neuron{n}", f"n{n}-l{i + 1}.tsv"),
                   np.stack([r + 1, c + 1, v], 1), fmt="%d\t%d\t%g")
    ir, ic, iv = fullscale_images(nimages, n, seed=seed)
    Y = sp.csr_matrix((iv.astype(np.float64), (ir, ic)), (nimages, n))
    tie = np.zeros(nimages, bool)
    for r, c, v in triples:
        P = (Y @ sp.csr_matrix((v.astype(np.float64), (r, c)), (n, n))) \
            .tocoo()
        pre = P.data + bias
        tie[P.row[np.abs(pre) < 1e-5]] = True
        Y = sp.csr_matrix((np.clip(pre, 0, 32), (P.row, P.col)),
                          (nimages, n))
        Y.eliminate_zeros()
    keep = ~tie[ir]
    ir, ic, iv = ir[keep], ic[keep], iv[keep]
    np.savetxt(os.path.join(ndir, f"sparse-images-{n}.tsv"),
               np.stack([ir + 1, ic + 1, iv], 1), fmt="%d\t%d\t%g")
    Y = scipy_dnn_oracle(ir, ic, iv, triples, nimages, n, bias)
    cats = np.flatnonzero(np.asarray(Y.sum(axis=1)).ravel() != 0)
    np.savetxt(os.path.join(ndir, "DNN",
                            f"neuron{n}-l{nlayers}-categories.tsv"),
               cats + 1, fmt="%d")
    return set(cats.tolist())


# ---------------------------------------------------------------------------
# spawned ranks for the distributed tier's CPU tests
# ---------------------------------------------------------------------------


class RankPool:
    """`world` spawned processes, the ranks of one gloo process group
    (over a FileStore in a temporary directory: no TCP port), each on a
    (pi, pj) mesh of ``parallel.make_mesh(world, device="cpu")`` and one
    CPU thread.  ``pool.run(name, **kw)`` hands every rank the job
    ``job_<name>(mesh, **kw)`` of this module and returns the ranks'
    results in rank order.  A job that raises on any rank makes `run`
    raise with that rank's traceback, and the pool restarts at its next
    job.  The children import neither jax nor a test module."""

    def __init__(self, world=4, timeout=300.0):
        self.world = world
        self.timeout = timeout
        self._procs = []

    def start(self):
        import multiprocessing
        import tempfile

        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="pygb_ranks_")
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, f"{self._dir}/store", self._jobs[r],
                  self._results)) for r in range(self.world)]
        for proc in self._procs:
            proc.start()

    def run(self, name, **kw):
        import queue
        import time

        if not self._procs:
            self.start()
        for q in self._jobs:
            q.put((name, kw))
        out = {}
        deadline = time.monotonic() + self.timeout
        while len(out) < self.world:
            try:
                rank, ok, val = self._results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                self.close()
                raise TimeoutError(f"job {name}: ranks {sorted(out)} of "
                                   f"{self.world} answered") from None
            if not ok:
                self.close()
                raise RuntimeError(f"job {name} failed on rank {rank}:\n"
                                   f"{val}")
            out[rank] = val
        return [out[r] for r in range(self.world)]

    def close(self):
        import shutil

        if not self._procs:
            return
        for q in self._jobs:
            q.put(None)
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)


def _rank_main(rank, world, store_path, jobs, results):
    """A rank of RankPool: join the group, then run jobs until None."""
    import datetime
    import traceback

    import torch.distributed as dist

    from .parallel import dist as pdist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = pdist.make_mesh(world, device="cpu")
    while True:
        job = jobs.get()
        if job is None:
            break
        name, kw = job
        try:
            results.put((rank, True, globals()["job_" + name](mesh, **kw)))
        except Exception:  # noqa: BLE001 — reported to the test process
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def _semiring(name):
    """"FP32.PLUS_TIMES" -> the port's semiring object."""
    from . import types

    typ, sem = name.split(".")
    return getattr(getattr(types, typ), sem)


def _matrix(A):
    """(type name, nrows, ncols, rows, cols, vals) -> a port Matrix on
    the CPU."""
    from . import Matrix, types

    typ, n, m, r, c, v = A
    M = Matrix.sparse(getattr(types, typ), n, m, device="cpu")
    M._build(np.asarray(r, np.int64), np.asarray(c, np.int64),
             np.asarray(v))
    return M


def job_mesh(mesh):
    """The mesh as a rank sees it."""
    import torch.distributed as dist

    from .parallel import dist as pdist

    try:
        pdist.make_mesh(dist.get_world_size() - 1, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(shape=pdist.mesh_shape(mesh), rank=dist.get_rank(),
                coordinate=(mesh.get_local_rank("i"),
                            mesh.get_local_rank("j")),
                ranks=mesh.mesh.tolist(), device=mesh.device_type,
                same=pdist.make_mesh(device="cpu") is mesh,
                refused=refused)


def job_spmv(mesh, n, m, rows, cols, vals, x, cases):
    """DistSpMV over each (add, mul, dtype name) of `cases` on the same
    triples: the whole y of each, as numpy values of its dtype."""
    from .parallel import dist as pdist

    out = []
    for add, mul, dt in cases:
        s = pdist.DistSpMV(mesh, n, m, rows, cols,
                           np.asarray(vals).astype(dt), add=add, mul=mul,
                           dtype=dt)
        xp = np.zeros(s.ncols_p, dt)
        xp[:len(x)] = x
        out.append(s.to_numpy(s.gather(s(xp))))
    return out


def job_pagerank(mesh, nrows, rows, cols, **kw):
    from .parallel import dist as pdist

    return pdist.dist_pagerank(mesh, nrows, rows, cols, **kw)


def job_pagerank_step(mesh, n, rows, cols, r, d_inv, teleport):
    """One dist_pagerank_step on DistSpMV(A^T, PLUS_SECOND) from the whole
    padded vectors `r` and `d_inv`: the whole new ranks and the
    residual."""
    from .parallel import dist as pdist

    s = pdist.DistSpMV(mesh, n, n, cols, rows, np.ones(len(rows), np.float32),
                       add="PLUS", mul="SECOND")
    lo = s.ri * s.rb
    block = lambda a: torch.from_numpy(a[lo:lo + s.rb].copy())
    r_new, rdiff = pdist.dist_pagerank_step(s, block(r), block(d_inv),
                                            teleport)
    return s.to_numpy(s.gather(r_new)), float(rdiff)


def job_triangles(mesh, nrows, rows, cols, width_cap=None):
    from .parallel import dist as pdist

    old = pdist._TC_WIDTH_CAP
    pdist._TC_WIDTH_CAP = width_cap or old
    try:
        return pdist.dist_triangle_count(mesh, nrows, rows, cols)
    finally:
        pdist._TC_WIDTH_CAP = old


def job_all_to_all(mesh, idx, val, dest, cap):
    from .parallel import dist as pdist

    ri, rv = pdist.frontier_all_to_all(mesh, torch.from_numpy(idx),
                                       torch.from_numpy(val),
                                       torch.from_numpy(dest), cap)
    return ri.numpy(), rv.numpy()


def job_vector_ops(mesh):
    """DistVector's elementwise ops, reductions and layouts."""
    from . import types
    from .parallel.dist import DistVector

    out = {}
    for spec in (None, "i", "j"):
        a = DistVector.dense(mesh, 10, 16, 3, types.INT64, spec)
        b = DistVector.dense(mesh, 10, 16, 4, types.INT64, spec)
        out[spec] = dict(
            eadd=a.eadd(b, "PLUS").to_numpy(),
            emult=a.emult(b, "TIMES").to_numpy(),
            ainv=a.apply("AINV").to_numpy(),
            sum10=a.apply(lambda z: z * 10).reduce("PLUS"),
            bmax=b.reduce("MAX"), bor=a.reduce("BOR"),
            float_sum=a.reduce_float())
    return out


def job_checkpoint(mesh, path, signature):
    """save_state / load_state across the ranks (rank 0 writes), and
    elastic_run restarting from a snapshot after injected failures."""
    import torch.distributed as dist

    from .parallel.checkpoint import elastic_run, load_state, save_state

    save_state(path, signature, 3, x=np.arange(4) * (dist.get_rank() + 1))
    step, arrays = load_state(path, signature)
    refused = load_state(path, signature + ":other")
    fails = {"left": 2}

    def step_fn(i, state):
        if i == 3 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("injected fault")
        return {"x": state["x"] + 1}

    state = elastic_run(step_fn, {"x": np.zeros(4)}, 6,
                        checkpoint_path=path + ".elastic.npz",
                        signature="elastic", checkpoint_every=2)
    return dict(step=step, x=arrays["x"], refused=refused,
                elastic=state["x"], fails_left=fails["left"])


def job_shard(mesh, A, op, balance=True, **kw):
    """``Matrix.shard(mesh, balance)`` of the matrix `A` (see `_matrix`),
    then one operation: its host result as numpy (vectors and matrices
    as their coordinate triples)."""
    from .parallel import dist as pdist

    D = _matrix(A).shard(mesh, balance=balance)
    if op == "mxv":
        y = D.mxv(kw["x"], semiring=_semiring(kw["semiring"]),
                  transpose=kw.get("transpose", False))
        return y._coo()
    if op == "mxv_mask_accum":
        prev = D.vector(fill=2.0, typ=_semiring(kw["semiring"]).ztype)
        y = D.mxv(kw["x"], semiring=_semiring(kw["semiring"]),
                  mask=kw["mask"], accum="PLUS", out=prev, out_dist=True)
        return y.to_numpy(), y.reduce_float()
    if op == "chain":
        from . import types

        y = D.vector(fill=1.0, typ=types.FP32)
        for _ in range(kw["steps"]):
            y = D.mxv(y, semiring=_semiring("FP32.PLUS_TIMES"))
            if not isinstance(y, pdist.DistVector):
                raise TypeError(f"mxv of a DistVector gave {type(y)}")
        return y.to_numpy(), y.to_vector()._coo()
    if op == "pagerank":
        return D.pagerank(**kw).to_numpy()
    if op == "triangle_count":
        return D.triangle_count()
    if op in ("bfs_level", "sssp"):
        return getattr(D, op)(kw["source"])._coo()
    if op == "k_truss":
        return D.k_truss(kw["k"])._coo()
    if op == "mxm":
        C = D.mxm(_matrix(kw["B"]), semiring=_semiring(kw["semiring"]),
                  mask=_matrix(kw["M"]))
        return C._coo()
    if op == "mxm_heavy":
        old = pdist._TC_WIDTH_CAP
        pdist._TC_WIDTH_CAP = kw["width_cap"]
        try:
            B = _matrix(kw["B"])
            return D.mxm(B, semiring=_semiring(kw["semiring"]),
                         mask=_matrix(kw["M"]))._coo()
        finally:
            pdist._TC_WIDTH_CAP = old
    if op == "ring_cache":
        M = _matrix(kw["M"])
        B = _matrix(A)
        sem = _semiring(kw["semiring"])
        pdist._RING_CACHE.clear()
        pdist._STATS["block_csr_builds"] = 0
        C1 = D.mxm(B, semiring=sem, mask=M)
        first = pdist._STATS["block_csr_builds"]
        C2 = D.mxm(B, semiring=sem, mask=M)
        return first, pdist._STATS["block_csr_builds"], C1.iseq(C2)
    raise ValueError(op)
