"""Multi-device scaling on ``torch.distributed``: device meshes, sharded
extraction, halo framing.

The counterpart of :mod:`speech_tpu.parallel`, with one process per
device (torch's SPMD model) in place of one program over a
:class:`jax.sharding.Mesh`:

- **Data parallelism** (`extract`): the utterance batch is split over a
  ``"data"`` mesh axis; every process runs the same feature route (the
  computer's fused CUDA kernel where it has one) on its rows.  No
  collectives on the forward path.
- **Sequence parallelism** (`halo`): a single very long signal's time axis
  is split across processes; framing needs ``frame_length - 1`` neighbouring
  samples, exchanged as a halo by point-to-point messages.
- **Distributed statistics** (`stats`): CMVN sufficient statistics
  accumulate with one ``all_reduce`` over the data axis.

Global results are DTensors sharded over the mesh
(:mod:`torch.distributed.tensor`).
"""

from .mesh import make_mesh, named_sharding  # noqa: F401
from .extract import ShardedExtractor, sharded_pitch_feats  # noqa: F401
from .halo import (  # noqa: F401
    halo_frame_signal,
    sharded_si_feats,
    sharded_stft_feats,
)
from .stats import accumulate_stats, accumulate_stats_sharded  # noqa: F401
from . import multihost  # noqa: F401

__all__ = [
    "make_mesh",
    "named_sharding",
    "ShardedExtractor",
    "halo_frame_signal",
    "sharded_pitch_feats",
    "sharded_si_feats",
    "sharded_stft_feats",
    "accumulate_stats",
    "accumulate_stats_sharded",
]
