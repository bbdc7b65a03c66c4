"""GraphChallenge-style Sparse DNN harness on pygraphblas_tpu_torch.

Reference: ``demo/dnn/`` — per-layer masked SpGEMM inference with bias
via the PLUS_PLUS semiring and ReLU/clip via select/assign.  The dataset
loader reads the GraphChallenge file layout when present locally and
otherwise generates RadiX-Net-style synthetic networks
(``pygraphblas_tpu_torch.testing``).
"""

import time
from functools import wraps


def timing(f):
    """Wall-clock decorator (reference demo/dnn/__init__.py:5-14)."""

    @wraps(f)
    def wrap(*args, **kwargs):
        ts = time.time()
        result = f(*args, **kwargs)
        te = time.time()
        print(f"func: {f.__name__} took: {te - ts:.4f} sec")
        return result

    return wrap
