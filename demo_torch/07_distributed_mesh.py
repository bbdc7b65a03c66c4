"""Distributed execution over a device mesh.

`Matrix.shard(mesh)` block-partitions a graph over a
`torch.distributed` DeviceMesh; SpMV, PageRank and triangle counting
then run on each rank's tile with collectives over the mesh.  The mesh
holds every rank of the world the script is launched in: a plain run is
a world of one (NCCL on the card, gloo with --device cpu), and

    torchrun --nproc-per-node N demo_torch/07_distributed_mesh.py

runs N ranks, one card each (every rank the same calls: SPMD).

Run: python demo_torch/07_distributed_mesh.py [--device cpu]
(the CUDA card unless --device names another device)
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from demo_torch import graphs  # noqa: E402
from pygraphblas_tpu_torch import Matrix, types  # noqa: E402
from pygraphblas_tpu_torch.parallel.dist import make_mesh, mesh_shape  # noqa: E402


def graph():
    """600 vertices, 5000 undirected edges: G(n, m), seed 5."""
    return graphs.gnm(600, 5000, seed=5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:      # launched by torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_mesh(device=dev.type)
        print("mesh:", mesh_shape(mesh), "world size:",
              dist.get_world_size(), "backend:", dist.get_backend())

        rows, cols, n = graph()
        A = Matrix.sparse(types.FP32, n, n, device=dev.type)
        A._build(rows, cols, np.ones(len(rows), np.float32))
        D = A.shard(mesh)

        r = D.pagerank(tol=1e-8)
        print("distributed pagerank: sum(r) =", float(np.sum(r.to_numpy())))

        tc = D.triangle_count()
        want = int(round(graphs.triangles(rows, cols, n).sum() / 3))
        print(f"distributed triangle count: {tc} (scipy: {want})")
        assert tc == want
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print("OK")


if __name__ == "__main__":
    main()
