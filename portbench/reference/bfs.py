"""Breadth-first search levels and connected components over an edge
list, level by level over every edge (no frontier buffer, no direction
switch): levels are 1-based hop counts from the source, 0 where
unreached."""

import torch


def levels(rows, cols, n, source, cap=None):
    """int64 levels from `source` over the edges rows[k] -> cols[k].

    cap: the control.  Each level keeps only the `cap` lowest-numbered
    of the vertices it reaches and drops the rest, unvisited, as a
    frontier buffer of `cap` ids would whose overflow went unchecked;
    a dropped vertex is found again at a later level or never."""
    dev = rows.device
    lv = torch.zeros(n, dtype=torch.int64, device=dev)
    lv[source] = 1
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    level = 1
    while True:
        nxt = torch.zeros(n, dtype=torch.bool, device=dev)
        nxt[cols[frontier[rows]]] = True
        nxt &= lv == 0
        if cap is not None:
            keep = torch.nonzero(nxt).flatten()[:cap]
            nxt = torch.zeros(n, dtype=torch.bool, device=dev)
            nxt[keep] = True
        if not bool(nxt.any()):
            return lv
        level += 1
        lv[nxt] = level
        frontier = nxt


def components(rows, cols, n):
    """Each vertex's component label (its least vertex id), by min-label
    propagation over the edges with pointer jumping; the edges must hold
    both directions."""
    lab = torch.arange(n, dtype=torch.int64, device=rows.device)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, cols, lab[rows], "amin")
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def component_entries(rows, cols, n):
    """(labels, entries): entries[label] counts the stored entries whose
    row lies in that component, i.e. the edges a BFS from any of its
    vertices reads."""
    lab = components(rows, cols, n)
    return lab, torch.bincount(lab[rows], minlength=n)
