"""Road-class BFS on the port: the host direction-optimised loop
(``algorithms.bfs_level``) and the device frontier loop
(``fused.bfs_frontier``) on a side x side grid with 5% random chords
(the twin of ``perf/road_bfs.py``; the default side 2048 gives 4,194,304
vertices).

The graph is a wrap-free 4-neighbour grid plus n / 20 random chords
(``road_graph``, the JAX script's builder): high diameter, low degree,
GAP's road workload shape.  ``bfs_level`` runs from vertex 0, the
frontier loop from 0 (first) and 1 (warm); the route each call took
(``fused.last_frontier``: frontier, retry or dense) is printed beside
its seconds, with its levels and ms a level.

Gates (exit 1 when one fails): the two loops reach the same vertices
(the twin's gate), and the levels from each source equal scipy's
unweighted ``shortest_path`` + 1.

    python perf/torch_road_bfs.py [--side 2048] [--host-only |
        --device-only] [--device cuda|cpu]

Prints one JSON line at the end.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def road_graph(side, seed=0):
    """The grid with chords, both directions (perf/road_bfs.py)."""
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    right = idx[(idx % side) != side - 1]
    down = idx[idx < n - side]
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + side])
    rng = np.random.RandomState(seed)
    nch = n // 20
    cs = rng.randint(0, n, nch)
    cd = np.minimum(cs + rng.randint(1, 2 * side, nch), n - 1)
    src = np.concatenate([src, cs])
    dst = np.concatenate([dst, cd])
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return rows, cols, n


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--host-only", action="store_true")
    ap.add_argument("--device-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def scipy_levels(rows, cols, n, source):
    """1-based BFS levels from `source` (0 where unreached): scipy's
    unweighted shortest paths + 1."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    G = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      (n, n))
    d = csgraph.shortest_path(G, directed=True, unweighted=True,
                              indices=source)
    return np.where(np.isfinite(d), d + 1, 0).astype(np.int64)


def _levels(lv, n):
    vals, mask = lv._dense_pair()
    return np.where(mask.cpu().numpy(), vals.cpu().numpy(), 0)


def run(args):
    """The calls of `args` (``parser()``'s options); returns the result
    dict.  Raises AssertionError when a gate fails."""
    from pygraphblas_tpu_torch import Matrix, algorithms, fused, types
    from pygraphblas_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    rows, cols, n = road_graph(args.side)
    A = Matrix.sparse(types.BOOL, n, n, device=dev)
    A._build(rows, cols, np.ones(len(rows), np.bool_))
    A._flush()
    res = dict(side=args.side, n=n, entries=len(rows), nnz=A.nvals,
               device=str(dev), graph_s=time.perf_counter() - t0)
    print(f"# road-like graph: n={n} entries={len(rows)} nnz={A.nvals} "
          f"({res['graph_s']:.2f}s)", flush=True)

    calls = []
    if not args.device_only:
        calls.append(("host", "bfs_level", 0,
                      lambda: algorithms.bfs_level(A, 0, device=dev)))
    if not args.host_only:
        calls += [("device_first", "bfs_frontier", 0,
                   lambda: fused.bfs_frontier(A, 0, device=dev)),
                  ("device_warm", "bfs_frontier", 1,
                   lambda: fused.bfs_frontier(A, 1, device=dev))]
    got = {}
    for tag, name, src, call in calls:
        fused.last_frontier.clear()
        t0 = time.perf_counter()
        lv = call()
        sync()
        s = time.perf_counter() - t0
        lev = _levels(lv, n)
        depth = int(lev.max())
        # algorithms.bfs_level takes the frontier loop from 32768 entries
        # up, the host direction-optimised loop below
        route = dict(fused.last_frontier) or dict(route="host loop")
        res[tag] = dict(call=name, source=src, seconds=s, reached=int(
            (lev > 0).sum()), levels=depth, ms_per_level=s / depth * 1e3,
            route=route)
        got[tag] = lev
        print(f"# {name} from {src} ({tag}): {s:.4f}s, route "
              f"{route['route']}, {depth} levels, "
              f"{s / depth * 1e3:.4f} ms a level, reached "
              f"{res[tag]['reached']}", flush=True)

    t0 = time.perf_counter()
    want = {s: scipy_levels(rows, cols, n, s)
            for s in sorted({c[2] for c in calls})}
    res["scipy_s"] = time.perf_counter() - t0
    for tag, lev in got.items():
        if not np.array_equal(lev, want[res[tag]["source"]]):
            raise AssertionError(
                f"{tag}: levels differ from scipy's in "
                f"{int((lev != want[res[tag]['source']]).sum())} places")
    if "host" in got and "device_first" in got:
        if res["host"]["reached"] != res["device_first"]["reached"]:
            raise AssertionError("host and device reach differ")
    return res


def main(argv=None):
    try:
        res = run(parser().parse_args(argv))
    except AssertionError as e:
        print(f"# FAILED: {e}", flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
