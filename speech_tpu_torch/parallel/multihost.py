"""Multi-process SPMD setup and data feeding.

The counterpart of :mod:`speech_tpu.parallel.multihost` on
``torch.distributed``, where every device is driven by a process of its
own (on one host or many):

- :func:`initialize` -- process-group setup (``init_process_group``),
  idempotent and a no-op for one process started with no launcher;
- :func:`process_slice` -- this process's share of a corpus manifest;
- :func:`global_batch_from_host_local` -- a global batch (a DTensor)
  whose rows are every process's local rows, so that
  :class:`~speech_tpu_torch.parallel.extract.ShardedExtractor` batches
  span all processes while each reads only its own files.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import global_tensor, local_device

__all__ = ["initialize", "global_batch_from_host_local", "process_slice"]

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    **kwargs,
) -> None:
    """Start the process group (no-op when one is running, and for a lone
    process that no launcher started).

    With no arguments the launcher's environment (``torchrun``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) says where the group
    meets.  Otherwise pass ``coordinator_address`` (``"host:port"``),
    ``num_processes`` and ``process_id``, or a ``store=`` with them.
    ``backend`` is ``"nccl"`` (one card a process) or ``"gloo"`` (CPU);
    other keyword arguments go to ``init_process_group``.  For a CUDA
    backend the process's card is ``cuda:<local rank>`` (``LOCAL_RANK``,
    else the rank modulo the cards on the host).
    """
    if dist.is_initialized():
        return
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
        or "store" in kwargs
    )
    if not explicit and not all(k in os.environ for k in _LAUNCHER_ENV):
        return
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    elif not explicit:
        kwargs.setdefault("init_method", "env://")
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'nccl' needs a GPU; pass backend='gloo' for the CPU"
            )
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs.setdefault("device_id", torch.device("cuda", local))
    dist.init_process_group(backend, **kwargs)


def process_slice(n_items: int) -> slice:
    """This process's contiguous share of ``n_items`` work items.

    Use to split a corpus manifest across processes:
    ``items[process_slice(len(items))]``.
    """
    if dist.is_initialized():
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        p, n = 0, 1
    per = -(-n_items // n)
    return slice(p * per, min(n_items, (p + 1) * per))


def global_batch_from_host_local(
    local_batch, mesh: DeviceMesh, data_axis: str = "data"
):
    """A global batch whose ``data`` axis concatenates every process's
    ``local_batch`` (local shape ``(local_n, ...)``), as a DTensor sharded
    over ``data_axis`` on this process's device.

    Each process feeds only its own rows; no data moves between them.
    """
    if not isinstance(local_batch, torch.Tensor):
        local_batch = torch.as_tensor(np.asarray(local_batch))
    local = local_batch.to(local_device(mesh))
    return global_tensor(local, mesh, data_axis)
