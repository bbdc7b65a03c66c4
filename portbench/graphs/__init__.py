"""Graph families: ``<family>.py`` draws a configuration's directed edge
list on the device from a ``torch.Generator``; ``make`` cleans it as the
configuration states (both directions stored, self-loops and duplicates
dropped) into canonical (row, col)-sorted int64 COO."""

import importlib

import torch


def undirected(rows, cols, scale):
    """Both directions of every edge, self-loops and duplicates dropped,
    sorted by (row, col): one sort of packed keys on the device."""
    r = torch.cat([rows, cols])
    c = torch.cat([cols, rows])
    keep = r != c
    keys = torch.unique((r[keep] << scale) | c[keep])
    return keys >> scale, keys & ((1 << scale) - 1)


def make(cfg, gen, device):
    """(rows, cols, n) of configuration `cfg` on `device`, drawn from
    `gen` (a ``torch.Generator`` on that device)."""
    family = importlib.import_module(f"portbench.graphs.{cfg['family']}")
    rows, cols = family.draw(cfg, gen, device)
    if not (cfg["undirected"] and cfg["drop_self_loops"]
            and cfg["drop_duplicates"]):
        raise ValueError("only undirected graphs without self-loops or "
                         "duplicates are generated")
    rows, cols = undirected(rows, cols, cfg["scale"])
    return rows, cols, 1 << cfg["scale"]
