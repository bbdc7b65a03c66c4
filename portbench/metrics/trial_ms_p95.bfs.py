"""The BFS trials' 95th percentile time in ms, read in the traced run
(its window carries the harness's counters): as ``trial_ms_p95``."""

import numpy as np


def read(rec):
    ms = [t["ms"] for t in rec.trials]
    return float(np.percentile(ms, 95)) if ms else None
