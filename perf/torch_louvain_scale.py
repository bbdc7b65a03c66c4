"""Louvain at 500k nodes on the port, on a planted 1000-block model (the
twin of ``perf/louvain_scale.py``).

Builds the JAX script's 500,000-node symmetric graph with 1000 planted
communities (``planted_block_graph``; FP64 values, as the twin builds
them: ``louvain_cluster`` folds in FP32), runs
``algorithms.louvain_cluster`` (local moves: a semiring product onto the
membership matrix a chunk; contraction: P^T (W P)), and reports the
wall clock, the communities, the planted-block purity, the host seconds
by phase (``algorithms.seconds``) and the route each unmasked product
took ("dense": the compact-dense tier, "esc": the ESC kernels, "host":
scipy or the generic tier, "diag": the diagonal-B path).  A progress
line (phase seconds and routes so far) is printed every
``--progress`` seconds, so that a run cut by a time limit shows where it
was.

    python perf/torch_louvain_scale.py [nblocks bsize] [--device cuda|cpu]
        (default 1000 500)

Prints one JSON line at the end.
"""

import argparse
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def planted_block_graph(nblocks, bsize, intra_deg=20, inter_deg=2, seed=42):
    """perf/louvain_scale.py's planted partition, both directions."""
    rng = np.random.RandomState(seed)
    n = nblocks * bsize
    intra_src = rng.randint(0, n, n * intra_deg // 2)
    intra_dst = (intra_src // bsize) * bsize + rng.randint(
        0, bsize, intra_src.shape[0])
    inter_src = rng.randint(0, n, n * inter_deg // 2)
    inter_dst = rng.randint(0, n, n * inter_deg // 2)
    src = np.concatenate([intra_src, inter_src, intra_dst, inter_dst])
    dst = np.concatenate([intra_dst, inter_dst, intra_src, inter_src])
    keep = src != dst
    return src[keep], dst[keep], n


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("nblocks", type=int, nargs="?", default=1000)
    ap.add_argument("bsize", type=int, nargs="?", default=500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--progress", type=float, default=60.0)
    return ap


def purity(labels, bsize, nblocks):
    """The share of nodes that carry their planted block's majority
    label."""
    blocks = np.arange(len(labels)) // bsize
    agree = sum(Counter(labels[blocks == b]).most_common(1)[0][1]
                for b in range(nblocks))
    return agree / len(labels)


def _routes(routes):
    """Wrap the unmasked products so that each call's route is appended
    to `routes`; returns the undo function."""
    from pygraphblas_tpu_torch.core import esc as E, gustavson as G

    orig_sp, orig_dense = G.spgemm, G.dense_spgemm
    hits = []

    def dense(*a, **kw):
        out = orig_dense(*a, **kw)
        hits.append(out is not None)
        return out

    def spgemm(ra, ca, va, rb, cb, vb, *a, **kw):
        e0, d0 = E.stats["calls"], len(hits)
        out = orig_sp(ra, ca, va, rb, cb, vb, *a, **kw)
        routes.append("diag" if len(rb) and bool(np.all(rb == cb)) else
                      "dense" if any(hits[d0:]) else
                      "esc" if E.stats["calls"] > e0 else "host")
        return out

    G.spgemm, G.dense_spgemm = spgemm, dense

    def undo():
        G.spgemm, G.dense_spgemm = orig_sp, orig_dense
    return undo


def run(args):
    """Louvain on the planted graph of `args`; returns the result dict."""
    from pygraphblas_tpu_torch import Matrix, algorithms, types
    from pygraphblas_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    src, dst, n = planted_block_graph(args.nblocks, args.bsize)
    A = Matrix.sparse(types.FP64, n, n, device=dev)
    A._build(src.astype(np.int64), dst.astype(np.int64), np.ones(len(src)))
    res = dict(nblocks=args.nblocks, bsize=args.bsize, n=n, nnz=A.nvals,
               device=str(dev), graph_s=time.perf_counter() - t0)
    print(f"# n={n} nnz={A.nvals} ({res['graph_s']:.2f}s)", flush=True)

    routes = []
    undo = _routes(routes)
    algorithms.seconds.clear()
    done = threading.Event()
    t0 = time.perf_counter()

    def progress():
        while not done.wait(args.progress):
            print(f"# progress {time.perf_counter() - t0:.1f}s: seconds "
                  f"{json.dumps(algorithms.seconds)} routes "
                  f"{dict(Counter(routes))}", flush=True)

    threading.Thread(target=progress, daemon=True).start()
    try:
        labels = algorithms.louvain_cluster(A, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        done.set()
        undo()
    res["wall_s"] = time.perf_counter() - t0
    lab = np.zeros(n, np.int64)
    i, v = labels._coo()
    lab[i] = v
    res["communities"] = int(len(np.unique(lab)))
    res["purity"] = purity(lab, args.bsize, args.nblocks)
    res["seconds"] = dict(algorithms.seconds)
    res["routes"] = dict(Counter(routes))
    res["route_order"] = "".join(r[0] for r in routes)
    print(f"# louvain {n // 1000}k: {res['wall_s']:.2f}s, "
          f"{res['communities']} communities, planted-block purity "
          f"{res['purity']:.3f}; routes {res['routes']}", flush=True)
    return res


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
