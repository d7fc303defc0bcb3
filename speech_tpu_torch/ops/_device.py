"""Where the port's entry points run: the GPU unless the caller names
another device, and never the CPU silently."""

import numpy as np
import torch

__all__ = ["as_tensor", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the GPU, and
    is an error where there is none (never a silent CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, device=None, dtype=None):
    """``x`` as a tensor: a tensor stays on its device, anything else
    (numpy arrays, lists, scalars) goes to :func:`resolve_device`
    ``(device)``.  ``dtype`` casts where given."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    return x if dtype is None else x.to(dtype)
