"""Distributed sufficient statistics (CMVN) over a mesh.

The counterpart of :mod:`speech_tpu.parallel.stats`: each process
accumulates the Kaldi ``(2, F+1)`` table over its rows of the utterance
batch and one ``all_reduce`` (SUM) over the data axis's group, the
counterpart of ``psum``, makes the global table on every process.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import local_tensor

__all__ = ["accumulate_stats", "accumulate_stats_sharded"]


def accumulate_stats(feats, counts=None, stats=None):
    """Kaldi-layout sufficient statistics for a (masked) feature batch.

    ``feats``: ``(..., frames, F)``; ``counts``: optional valid-frame counts
    of shape ``(...,)`` masking padded rows.  Returns/updates
    ``stats[(2, F+1)] = [sum x | n ; sum x^2 | 0]`` matching
    ``Standardize.accumulate`` (reference: post.py:193-212).
    """
    feats = torch.as_tensor(feats)
    num_filts = feats.shape[-1]
    flat = feats.reshape(-1, feats.shape[-2], num_filts)
    if counts is None:
        mask = flat.new_ones(flat.shape[:2])
    else:
        counts = torch.as_tensor(counts, device=feats.device).reshape(-1)
        pos = torch.arange(flat.shape[1], device=feats.device)
        mask = (pos[None, :] < counts[:, None]).to(feats.dtype)
    masked = flat * mask[..., None]
    new = torch.cat(
        [
            torch.cat([masked.sum(dim=(0, 1)), mask.sum().reshape(1)])[None],
            torch.cat([(masked * flat).sum(dim=(0, 1)), flat.new_zeros(1)])[None],
        ]
    )
    if stats is not None:
        new = new + torch.as_tensor(stats, device=feats.device)
    return new


def accumulate_stats_sharded(
    feats, counts, mesh: DeviceMesh, data_axis: str = "data", stats=None
):
    """Global CMVN statistics for a batch sharded over ``data_axis``.

    ``feats``/``counts`` are global: DTensors (each process's shard is
    used) or arrays every process holds whole (each takes its own rows).
    Local accumulation, then one ``all_reduce`` over the data axis; the
    returned ``(2, F+1)`` table is the same on every process.
    """
    local = accumulate_stats(
        local_tensor(feats, mesh, data_axis), local_tensor(counts, mesh, data_axis)
    )
    dist.all_reduce(local, op=dist.ReduceOp.SUM, group=mesh.get_group(data_axis))
    if stats is not None:
        local = local + torch.as_tensor(stats, device=local.device)
    return local
