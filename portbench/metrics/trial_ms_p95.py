"""95th percentile of every trial's time in the window, in ms, from
CUDA events recorded before and after each trial on its stream."""

import numpy as np


def read(rec):
    ms = [t["ms"] for t in rec.trials]
    return float(np.percentile(ms, 95)) if ms else None
