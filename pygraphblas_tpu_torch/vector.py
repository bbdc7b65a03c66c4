"""Dense vector: values and a presence mask, both tensors on one
device.  The slice of ``pygraphblas_tpu/vector.py`` that the fused
algorithms return."""

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

    def to_numpy(self):
        """Host values (absent entries read 0)."""
        v = torch.where(self._mask, self._vals,
                        torch.zeros_like(self._vals))
        return v.cpu().numpy().astype(self.type.numpy_dtype, copy=False)
