"""The relay between the front and the followers of a server on a mesh of
several processes (:mod:`speech_tpu_torch.serve`).

Every rank of the mesh constructs the same server.  Rank 0, the front,
alone takes requests and decides each step (a micro-batch, its readback, a
tick); it sends each step to the other ranks, the followers, whose
background thread runs its own row or slot block of the step through the
same collectives in the same order.  This is the usual SPMD answer to
processes that would not agree on batches formed by arrival time: one
process decides and broadcasts.

The control plane -- one int64 header a step, a stream server's command
lists, and one flag a step that says whether every rank's part ran -- goes
over a gloo group of the relay's own, on the host: a follower reading a
header never waits on its card's queued work, and agreeing on a flag never
waits on the front's.  A micro-batch's rows go out from the front, and its
features come back to it, over the process group's own backend (NCCL
between cards: device tensors; gloo on the CPU).  While a server runs,
its thread runs collectives on the default group, so the caller must run
none of its own there until the server is closed.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["BATCH", "COLLECT", "STOP", "Relay"]

BATCH, COLLECT, STOP = 1, 2, 3
# op, sequence number, rows, bucket length, buffer type, requests
_FIELDS = 6
# a follower waits for the front's next step as long as the server lives
_IDLE = datetime.timedelta(days=365)


class Relay:
    """The front's and a follower's ends of one server's relay.

    ``mesh`` must span the process group; ``rows`` is the longest list of
    row lengths that rides in one header (longer lists follow it in a
    second broadcast).  Collective: every rank constructs it, in the same
    order as its other groups.
    """

    def __init__(self, mesh, data_axis: str = "data", rows: int = 0):
        world = dist.get_world_size()
        if mesh.size() != world:
            raise ValueError(
                f"a server's mesh must span the process group: {mesh.size()} "
                f"of {world} processes"
            )
        self.rank = dist.get_rank()
        self.world = world
        self.front = self.rank == 0
        self._ctrl = dist.new_group(backend="gloo", timeout=_IDLE)
        axis = mesh.mesh_dim_names.index(data_axis)
        grid = mesh.mesh.cpu().numpy()
        # the data-axis block each rank holds, and one holder per block
        self.block_of = np.empty(world, np.int64)
        for idx in np.ndindex(grid.shape):
            self.block_of[grid[idx]] = idx[axis]
        self.holders = [int(np.flatnonzero(self.block_of == b)[0])
                        for b in range(grid.shape[axis])]
        self._cap = int(rows)
        self._header = torch.zeros(_FIELDS + self._cap, dtype=torch.int64)

    # -- control plane (gloo, host) ------------------------------------------

    def send(self, op: int, seq: int = 0, max_len: int = 0, dtype: int = 0, n: int = 0,
             lengths=()) -> None:
        """The front's header of one step (with its row lengths)."""
        h = self._header
        h.zero_()
        rows = len(lengths)
        h[:_FIELDS] = torch.tensor([op, seq, rows, max_len, dtype, n])
        if rows <= self._cap:
            h[_FIELDS: _FIELDS + rows] = torch.from_numpy(np.asarray(lengths, np.int64))
        dist.broadcast(h, src=0, group=self._ctrl)
        if rows > self._cap:
            dist.broadcast(torch.from_numpy(np.asarray(lengths, np.int64).copy()), src=0,
                           group=self._ctrl)

    def recv(self):
        """A follower's next header: ``(op, seq, max_len, dtype, n,
        lengths)``, ``lengths`` an int64 array."""
        h = self._header
        dist.broadcast(h, src=0, group=self._ctrl)
        op, seq, rows, max_len, dtype, n = h[:_FIELDS].tolist()
        if rows <= self._cap:
            lengths = h[_FIELDS: _FIELDS + rows].numpy().copy()
        else:
            ext = torch.empty(rows, dtype=torch.int64)
            dist.broadcast(ext, src=0, group=self._ctrl)
            lengths = ext.numpy()
        return op, seq, max_len, dtype, n, lengths

    def send_obj(self, obj) -> None:
        """The front's picklable message (a stream server's commands)."""
        dist.broadcast_object_list([obj], src=0, group=self._ctrl)

    def recv_obj(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._ctrl)
        return box[0]

    def agree(self, ok: bool) -> bool:
        """Whether every rank's part of a step ran (one all-reduce)."""
        flag = torch.tensor([int(bool(ok))], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._ctrl)
        return bool(flag.item())

    # -- data plane (the group's backend) ------------------------------------

    def scatter(self, out: torch.Tensor, blocks=None) -> torch.Tensor:
        """Every rank's row block into ``out``: on the front ``blocks`` lists
        the blocks by data-axis position."""
        scatter_list = None
        if self.front:
            scatter_list = [blocks[b] for b in self.block_of]
        dist.scatter(out, scatter_list, src=0)
        return out

    def gather(self, t: torch.Tensor):
        """Every rank's ``t`` at the front, joined in data-axis order along
        dimension 0 (None on a follower)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)] if self.front else None
        dist.gather(t, parts, dst=0)
        if not self.front:
            return None
        return torch.cat([parts[r] for r in self.holders])
