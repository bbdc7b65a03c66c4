"""Graph500 Kronecker (RMAT) edges, GAP's "kron" family: edge_factor *
2**scale draws, each bit of a draw's row and column picked from the
quadrant probabilities a, b, c (d = 1 - a - b - c), then the vertex ids
permuted.  A device rewrite of ``pygraphblas_tpu_torch.generators.
rmat_edges`` (the same probabilities; one uniform draw decides the
column bit in either half, so the streams differ)."""

import torch


def draw(cfg, gen, device):
    scale, m = cfg["scale"], cfg["edge_factor"] << cfg["scale"]
    a, b, c = cfg["a"], cfg["b"], cfg["c"]
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r_bit = torch.rand(m, generator=gen, device=device) > ab
        u = torch.rand(m, generator=gen, device=device)
        c_bit = torch.where(r_bit, u > c_norm, u > a_norm)
        rows |= r_bit.to(torch.int64) << bit
        cols |= c_bit.to(torch.int64) << bit
    if cfg["permute_ids"]:
        perm = torch.randperm(1 << scale, generator=gen, device=device)
        rows, cols = perm[rows], perm[cols]
    return rows, cols
