"""Uniform random edges, GAP's "urand" family: edge_factor * 2**scale
draws, each endpoint uniform over the 2**scale vertices.  A device
rewrite of ``pygraphblas_tpu_torch.generators.urand_edges``."""

import torch


def draw(cfg, gen, device):
    n, m = 1 << cfg["scale"], cfg["edge_factor"] << cfg["scale"]
    rows = torch.randint(0, n, (m,), generator=gen, device=device)
    cols = torch.randint(0, n, (m,), generator=gen, device=device)
    return rows, cols
