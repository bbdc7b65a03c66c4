"""GAP BFS trials through ``algorithms.bfs_level``, the
direction-optimising BFS: from each source the program takes
``fused.bfs_frontier``'s frontier route, its retry, or the dense xspmv
route (``fused.last_frontier`` names the one taken).  Sources are drawn
from the seed among the vertices of nonzero degree, a pool of
``mix["pool"]`` used in turn.

The number compared is the count of vertices whose level differs from
the reference's (exact: LIMIT 0); the control is the reference with its
frontier cut to the 4096 lowest-numbered new vertices a level, the
overflow unchecked (the configuration's guarantee of exact levels
broken, as a frontier buffer without its retry would break it)."""

import numpy as np
import torch

from portbench.reference import bfs as ref

CHECK = "bfs_level_mismatches"
LIMIT = 0                # exact; the control reads 3.3e5-5.1e5 at scale 19
CONTROL_CAP = 4096


class Trials:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        if mix["sources"] != "nonzero_degree":
            raise ValueError("BFS sources are drawn among the vertices of "
                             "nonzero degree")
        deg = torch.bincount(ctx.edges_dev[0], minlength=ctx.n)
        nz = torch.nonzero(deg).flatten()
        warm = mix["warm_trials"]
        draw = torch.randint(0, nz.numel(), (mix["pool"] + warm,),
                             generator=ctx.gen, device=ctx.gen.device)
        picked = nz[draw.to(nz.device)].cpu().numpy()
        self.warm_sources, self.sources = picked[:warm], picked[warm:]
        self._comp = None

    def warm(self):
        from pygraphblas_tpu_torch import fused

        routes = set()
        for s in self.warm_sources:
            self._bfs(int(s))
            routes.add(fused.last_frontier.get("route"))
        if "dense" not in routes:       # the dense route's plan and shapes
            fused.bfs_level(self.ctx.A, int(self.warm_sources[0]),
                            device=self.ctx.device)
        self.ctx.sync()

    def _bfs(self, source):
        from pygraphblas_tpu_torch import algorithms

        return algorithms.bfs_level(self.ctx.A, source,
                                    device=self.ctx.device)

    def call(self, i):
        return self._bfs(self.key(i))

    def note(self, i, answer):
        from pygraphblas_tpu_torch import fused

        lf = fused.last_frontier
        out = dict(route=lf.get("route"), seconds=lf.get("seconds"))
        if self.ctx.instrumented:
            out["depth"] = int(answer.max())
        return out

    def host(self, answer):
        return answer.to_numpy()

    def key(self, i):
        return int(self.sources[i % len(self.sources)])

    def reference(self, edges, key):
        return ref.levels(*edges, key).cpu().numpy()

    def control(self, edges, key):
        return ref.levels(*edges, key, cap=CONTROL_CAP).cpu().numpy()

    def gap(self, answer, reference):
        return int(np.count_nonzero(np.asarray(answer, np.int64)
                                    != reference))

    def work(self, edges, keys):
        """The entries of the rows each source reaches: its connected
        component's entries (the graph is undirected)."""
        if self._comp is None:
            self._comp = ref.component_entries(*edges)
        lab, entries = self._comp
        src = torch.as_tensor(np.asarray(keys, np.int64),
                              device=lab.device)
        return entries[lab[src]].cpu().tolist()
