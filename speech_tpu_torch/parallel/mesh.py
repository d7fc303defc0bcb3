"""Device-mesh construction helpers.

The counterpart of :mod:`speech_tpu.parallel.mesh` on
``torch.distributed``: one process per device (torch's SPMD model), and a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the current process
group in place of a :class:`jax.sharding.Mesh`.  A sharding is a list of
DTensor placements, one per mesh dimension.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "axis_size",
    "global_tensor",
    "local_device",
    "local_rows",
    "local_tensor",
    "make_mesh",
    "named_sharding",
]


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> DeviceMesh:
    """Build a :class:`DeviceMesh` over the processes of the current group.

    Parameters
    ----------
    axis_names
        Logical axis names, e.g. ``("data",)`` or ``("data", "filt")``.
    shape
        Processes per axis.  Defaults to all of them on the first axis (and
        1 on the rest).  A ``-1`` entry is inferred from the world size.
    devices
        The device type of the mesh: ``"cuda"`` (default; one card per
        process) or ``"cpu"`` (the gloo backend).

    A process group must be running (:func:`~.multihost.initialize` or
    ``torch.distributed.init_process_group``).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "speech_tpu_torch.parallel.multihost.initialize(...) or "
            "torch.distributed.init_process_group(...) first"
        )
    device_type = torch.device(devices or "cuda").type
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return init_device_mesh(
        device_type, tuple(shape), mesh_dim_names=tuple(axis_names)
    )


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Processes along mesh axis ``axis`` (``mesh.shape[axis]`` in JAX)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def local_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def named_sharding(mesh: DeviceMesh, *spec) -> list:
    """DTensor placements for a ``PartitionSpec``-style ``spec``: tensor
    dimension ``i`` is ``Shard(i)`` on the mesh axis ``spec[i]`` names (an
    axis name or a tuple of them); ``None`` entries and mesh axes that no
    entry names are ``Replicate()``."""
    placements = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, names in enumerate(spec):
        if names is None:
            continue
        for name in (names,) if isinstance(names, str) else names:
            placements[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return placements


def local_rows(x, mesh: DeviceMesh, axis: str):
    """This process's block of a global array's first dimension, as a shard
    map over ``axis`` hands it out: a DTensor's local shard, or of a plain
    array (every process holding the whole of it) the contiguous rows
    ``[r * B / n, (r + 1) * B / n)`` of the process at position ``r`` on
    ``axis``."""
    if isinstance(x, DTensor):
        return x.to_local()
    per = x.shape[0] // axis_size(mesh, axis)
    start = mesh.get_local_rank(axis) * per
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return x[start : start + per]


def global_tensor(local: torch.Tensor, mesh: DeviceMesh, axis: str):
    """The global array whose first dimension holds every process's
    ``local`` in the order of ``axis`` (replicated over the other mesh
    axes), as a DTensor: no data moves."""
    return DTensor.from_local(local, mesh, named_sharding(mesh, axis), run_check=False)


def local_tensor(x, mesh: DeviceMesh, axis: str, dtype=None):
    """:func:`local_rows` of ``x`` as a tensor on this process's device
    (cast to ``dtype`` where given)."""
    rows = local_rows(x, mesh, axis)
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.ascontiguousarray(rows))
    rows = rows.to(local_device(mesh))
    return rows if dtype is None else rows.to(dtype)
