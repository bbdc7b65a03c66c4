"""PageRank as GAP defines it (pr.cc): r0 = 1/n; each iteration
r' = (1 - d)/n + sum over edges u -> v of d * r[u] / outdeg(u); a vertex
of out-degree 0 passes nothing on; stop once the L1 change of the last
iteration is at most `tol` (never, for tol < 0), or after `itermax`
iterations."""

import torch


def iterates(rows, cols, n, damping, dtype=torch.float64):
    """r1, r2, ... over the edges rows[k] -> cols[k], each with the L1
    change from the one before, computed in `dtype` throughout."""
    dev = rows.device
    deg = torch.bincount(rows, minlength=n).to(dtype)
    scale = torch.where(deg > 0, damping / deg.clamp_min(1),
                        torch.zeros_like(deg))
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    teleport = (1.0 - damping) / n
    while True:
        w = (r * scale)[rows]
        new = torch.full((n,), teleport, dtype=dtype, device=dev)
        new.index_add_(0, cols, w)
        rdiff = float((new.double() - r.double()).abs().sum())
        r = new
        yield r, rdiff


def pagerank(rows, cols, n, damping, itermax, tol, dtype=torch.float64):
    """(ranks, iterations), computed in `dtype` throughout
    (torch.bfloat16 makes the control)."""
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=rows.device)
    it = 0
    if itermax <= 0:
        return r, it
    for r, rdiff in iterates(rows, cols, n, damping, dtype):
        it += 1
        if it >= itermax or (tol >= 0 and rdiff <= tol):
            return r, it


def accepted(rows, cols, n, damping, itermax, tol, tie):
    """(answers, k, previous) in float64: k is the reference's stopping
    iteration and answers holds r_k, and also r_(k+1) where the change
    at k lies within `tie` of `tol` (a float32 run may read it above
    tol and go on), or r_(k-1) where the change at k-1 does (a float32
    run may read it at or below tol and stop).  `previous` is r_(k-1),
    the answer of a run one iteration short."""
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=rows.device)
    seq = [(r0, float("inf"))]
    gen = iterates(rows, cols, n, damping)
    for r, rdiff in gen:
        seq.append((r, rdiff))
        if len(seq) - 1 >= itermax or (tol >= 0 and rdiff <= tol):
            break
    k = len(seq) - 1

    def near(d):
        return tol >= 0 and abs(d - tol) <= tie * tol

    answers = [seq[k][0]]
    if k >= 2 and near(seq[k - 1][1]):
        answers.append(seq[k - 1][0])
    if k < itermax and near(seq[k][1]):
        answers.append(next(gen)[0])
    return answers, k, seq[k - 1][0]


def rel_l1(got, want):
    """sum |got - want| / sum |want|, in float64."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double().to(got.device)
    return float((got - want).abs().sum() / want.abs().sum())
