"""GAP PageRank trials through ``fused.pagerank`` (the whole loop on the
card over the xspmv engine): every trial the same call on the same
graph, as GAP's repeated trials are.

The number compared is the L1 distance of the answer's ranks from the
float64 reference's, over the reference's L1 norm.  The reference's
answer is its iterate at GAP's stop; where the L1 change at the stop
(or one iteration before it) lies within ``TIE`` of the tolerance, the
iterate after it (or before it) is accepted too, since a float32 run
may read that change on the other side of the tolerance.  The control
is the reference computed in bfloat16, the precision below float32;
the fault ``short`` is the reference's iterate one iteration before
its stop, as a run that skips the last iteration would answer."""

import torch

from portbench.reference import pagerank as ref

CHECK = "pr_rel_l1"
# between the readings at scale 19 on an H100 (PERF.md, section 2):
# sound runs at most 1.24e-7 over 12 seeds a graph; one iteration short
# at least 6.05e-5 and the bfloat16 control at least 1.87e-2 over 6;
# above their geometric mean, 2.7e-6
LIMIT = 1e-5
# a float32 run's L1 change is off the float64 one by about 5e-4 of it
TIE = 1e-2
FAULTS = ("short",)


class Trials:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.kw = dict(damping=mix["damping"], itermax=mix["itermax"],
                       tol=mix["tol"])
        self._ref = None

    def warm(self):
        for _ in range(self.ctx.mix["warm_trials"]):
            self.call(-1)
        self.ctx.sync()

    def call(self, i):
        from pygraphblas_tpu_torch import fused

        return fused.pagerank(self.ctx.A, device=self.ctx.device,
                              **self.kw)

    def note(self, i, answer):
        return {}

    def host(self, answer):
        return answer.to_numpy()

    def key(self, i):
        return None

    def _accepted(self, edges):
        if self._ref is None:
            self._ref = ref.accepted(*edges, tie=TIE, **self.kw)
        return self._ref

    def reference(self, edges, key):
        return self._accepted(edges)[0]

    def control(self, edges, key):
        r, _ = ref.pagerank(*edges, dtype=torch.bfloat16, **self.kw)
        return r.float().cpu().numpy()

    def short(self, edges, key):
        return self._accepted(edges)[2].float().cpu().numpy()

    def gap(self, answer, reference):
        got = torch.as_tensor(answer).to(reference[0].device)
        return min(ref.rel_l1(got, r) for r in reference)

    def work(self, edges, keys):
        """Stored entries x the reference's iterations, each trial."""
        iters = self._accepted(edges)[1]
        return [int(edges[0].numel()) * iters for _ in keys]
