"""Hand-made kernel inputs, shared by the GPU tests
(tests/test_torch_cuda.py) and chip_smoke.py, which hold the kernels
against their plain versions on them (numpy arrays: the callers move
them to the device they test), and the index recipe by which one
``torch.take`` computes a kernel that only moves data (`take_index`)."""

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
