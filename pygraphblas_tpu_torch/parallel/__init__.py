"""Multi-device distribution: device meshes, block-partitioned sparse
containers, and collective-based semiring kernels over
``torch.distributed`` (the JAX package's ``parallel``): row/block
partitioning over a ``DeviceMesh`` with frontier/halo exchange by
collectives, NCCL between cards and gloo on the CPU.  SPMD: every rank
runs the same calls with the same host inputs."""

from .dist import DistSpMV, dist_pagerank_step, make_mesh

__all__ = ["DistSpMV", "dist_pagerank_step", "make_mesh"]
