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
    """``None`` -> the current CUDA card (raising when absent); anything
    else is passed to ``torch.device``.  A CUDA device always carries
    its index (``cuda`` -> ``cuda:0``), as a tensor's device does, so
    that devices compare equal by name."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        requires_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(a, device):
    """numpy array or tensor -> tensor on `device` (None stays None)."""
    if a is None or isinstance(a, torch.Tensor):
        return a if a is None else a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of another package's buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def common_device(*objs):
    """The device an operation on the containers `objs` runs on (None
    entries are skipped): the one device the containers that hold one
    share (ValueError when they differ), else the default (the card,
    raising when there is none).  A container that holds no device yet
    adopts it, so its first device work lands there."""
    devs = {}
    for o in objs:
        d = getattr(o, "_dev", None)
        if d is not None:
            devs[str(d)] = d
    if len(devs) > 1:
        raise ValueError("operands sit on different devices: "
                         + ", ".join(sorted(devs)))
    dev = next(iter(devs.values())) if devs else resolve_device(None)
    for o in objs:
        if o is not None and hasattr(o, "_dev") and o._dev is None:
            o._dev = dev
    return dev
