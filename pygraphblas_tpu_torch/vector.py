"""Dense vector: values and a presence mask, both tensors on one
device.  The slice of ``pygraphblas_tpu/vector.py`` that the fused
algorithms return: a value is present where the JAX result's mask says
so (BFS levels > 0, finite SSSP distances; PageRank and BC are dense)."""

import numpy as np
import torch


class Vector:
    __slots__ = ("type", "_vals", "_mask")

    def __init__(self, typ, vals, mask=None):
        self.type = typ
        self._vals = vals
        self._mask = mask if mask is not None else torch.ones(
            vals.shape, dtype=torch.bool, device=vals.device)

    @property
    def size(self):
        return self._vals.shape[0]

    def _host_pair(self):
        """Host (values, presence mask) as numpy arrays."""
        return (self._vals.cpu().numpy().astype(self.type.numpy_dtype,
                                                copy=False),
                self._mask.cpu().numpy())

    def to_numpy(self):
        """Host values (absent entries read 0)."""
        v, m = self._host_pair()
        return np.where(m, v, np.zeros((), v.dtype))
