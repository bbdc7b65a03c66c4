"""Default-device resolution for the port's entry points.

Entry points run on the first CUDA card unless the caller names another
device (the tests pass ``device="cpu"``).  With no card present and no
device named, they raise rather than quietly running on the CPU."""

import numpy as np
import torch


def requires_cuda(what="this entry point"):
    """Raise unless a CUDA card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raising when absent); anything else is
    passed to ``torch.device``."""
    if device is None:
        requires_cuda()
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        requires_cuda()
    return dev


def as_tensor(a, device):
    """numpy array or tensor -> tensor on `device` (None stays None)."""
    if a is None or isinstance(a, torch.Tensor):
        return a if a is None else a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of another package's buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)
