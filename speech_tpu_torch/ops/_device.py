"""Where the port's entry points run: the GPU unless the caller names
another device, and never the CPU silently."""

from functools import lru_cache

import numpy as np
import torch

__all__ = ["as_tensor", "host_constant", "resolve_device"]


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


def host_constant(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A host table (a numpy array or anything ``np.asarray`` takes) as a
    tensor of ``dtype`` on ``device``, copied there once and then shared.

    A copy from host memory to the card waits for the card, so code that
    runs once per streaming tick takes its constants from here and queues
    no such copy.  The table is keyed by its bytes; callers must not write
    to the tensor."""
    arr = np.ascontiguousarray(arr)
    return _constant(arr.tobytes(), arr.dtype.str, arr.shape, dtype, torch.device(device))


@lru_cache(maxsize=256)
def _constant(data: bytes, np_dtype: str, shape, dtype, device):
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    return torch.tensor(arr, dtype=dtype, device=device)
