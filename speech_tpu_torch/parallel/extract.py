"""Data-parallel feature extraction over a device mesh.

The counterpart of :mod:`speech_tpu.parallel.extract` on
``torch.distributed``: signals are padded into ``(batch, max_len)``
buckets, the batch is split over the mesh's data axis into contiguous row
blocks (process ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B /
n)``, as a shard map over the batch does), and each process runs its
computer's own batched route on its rows: the fused CUDA kernel where the
computer selects one (B2 at 'double'/'accurate', B1/B3 at
``fft_mode="pallas"``), else the plain tensor path.  Extraction needs no
collectives; the results that the JAX package returns as global arrays
are DTensors here, and :meth:`ShardedExtractor.extract` gathers their rows
on every process.
"""

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..compute import _compact_transfer, _to_device
from .mesh import axis_size, global_tensor, local_rows, local_tensor

__all__ = ["ShardedExtractor", "sharded_pitch_feats"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def sharded_pitch_feats(
    signals,
    rate: float,
    lengths,
    mesh: DeviceMesh,
    data_axis: str = "data",
    **kwargs,
):
    """Data-parallel :func:`speech_tpu_torch.ops.pitch.pitch_feats` over a
    mesh.

    The batch splits over ``data_axis`` (utterances are independent: no
    collectives); each process runs the NCCF + Viterbi tracker on its rows.
    ``signals`` is ``(batch, max_len)`` with ``batch`` a multiple of the
    axis size; ``lengths`` marks valid extents.  Returns ``(feats,
    valid_counts)`` like ``pitch_feats(..., return_valid=True)``, as
    DTensors sharded over ``data_axis``.
    """
    from ..ops.pitch import pitch_feats

    n = axis_size(mesh, data_axis)
    if signals.shape[0] % n:
        raise ValueError(
            f"batch ({signals.shape[0]}) must divide by the '{data_axis}' "
            f"axis size ({n})"
        )
    feats, valid = pitch_feats(
        local_tensor(signals, mesh, data_axis),
        rate,
        lengths=local_tensor(lengths, mesh, data_axis),
        return_valid=True,
        **kwargs,
    )
    return (
        global_tensor(feats.contiguous(), mesh, data_axis),
        global_tensor(valid.contiguous(), mesh, data_axis),
    )


class ShardedExtractor:
    """Batched, bucketed, mesh-sharded feature extraction.

    Parameters
    ----------
    computer
        A :class:`~speech_tpu_torch.compute.STFTFrameComputer` or
        :class:`~speech_tpu_torch.compute.SIFrameComputer`, on this
        process's device (the mesh's device type).
    mesh
        The device mesh.  ``None`` runs unsharded on the computer's device.
    data_axis
        Mesh axis name carrying the utterance batch.
    bucket
        Length-bucket granularity for :meth:`extract`'s padding:
        ``"pow2"`` (default) pads to the next power of two; ``"fine"``
        pads to the next of ``{2**k, 3 * 2**(k-1)}`` -- worst-case pad
        waste drops from 2x to 4/3x at the cost of up to twice as many
        distinct shapes over a corpus.
    postprocessors
        Optional :mod:`speech_tpu_torch.post` instances (or ``(feats,
        counts) -> (feats, counts)`` callables) run on the device after
        the features as their lengths-aware forms
        (:func:`speech_tpu_torch.ops.postops.device_post_chain`), each
        row's edge handling at its own valid extent.  Frame counts reflect
        any count-changing op (stack).
    aot_dir
        Optional store of kernel libraries (a path or a
        :class:`speech_tpu_torch.aot.AOTCache`, shared as it is): the
        computer takes its kernels from it (``computer.enable_aot``), so a
        store a previous process (or ``--precompile``) warmed serves with
        no compiler.  The store is ``self.aot``.
    """

    def __init__(
        self,
        computer,
        mesh: Optional[DeviceMesh] = None,
        data_axis: str = "data",
        bucket: str = "pow2",
        postprocessors=(),
        aot_dir=None,
    ):
        from ..aot import as_cache
        from ..ops.postops import device_post_chain

        if bucket not in ("pow2", "fine"):
            raise ValueError(f"bucket must be 'pow2' or 'fine', got {bucket!r}")
        if mesh is not None and computer.device.type != mesh.device_type:
            raise ValueError(
                f"computer runs on {computer.device.type!r} but the mesh "
                f"on {mesh.device_type!r}"
            )
        self._computer = computer
        self._mesh = mesh
        self._data_axis = data_axis
        self._bucket = bucket
        self._post = (
            device_post_chain(postprocessors) if postprocessors else None
        )
        self.aot = as_cache(aot_dir)  # path, AOTCache, or None
        if self.aot is not None:
            computer.enable_aot(self.aot)

    def bucket_len(self, n: int) -> int:
        """The padded signal length :meth:`extract` uses for length ``n``."""
        n = max(int(n), self._computer.frame_length)
        p = _next_pow2(n)
        if self._bucket == "fine" and 3 * (p // 4) >= n:
            return 3 * (p // 4)
        return p

    @property
    def batch_multiple(self) -> int:
        """Batch sizes must be a multiple of this (the data-axis size)."""
        if self._mesh is None:
            return 1
        return axis_size(self._mesh, self._data_axis)

    def _row_block(self, batch: int) -> Tuple[int, int]:
        """(first row, rows) of this process's block of a global batch."""
        if self._mesh is None:
            return 0, batch
        per = batch // self.batch_multiple
        return self._mesh.get_local_rank(self._data_axis) * per, per

    def _is_full(self, lengths, max_len: int) -> bool:
        """Whether host-known ``lengths`` are all full: then ``_run`` hands
        the computer host lengths, which take its static-padding path."""
        return (
            not isinstance(lengths, torch.Tensor)
            and max_len >= self._computer.frame_length
            and bool((np.asarray(lengths) == max_len).all())
        )

    def _run(self, signals, lengths, full: bool):
        """Features and counts of this process's rows: the computer's own
        ``compute_batch`` (``signals`` may still be compact integers;
        ``lengths`` a device tensor, so nothing here waits on the card)."""
        if full:
            lengths = np.full(signals.shape[0], signals.shape[1])
        feats, counts = self._computer.compute_batch(signals, lengths)
        if self._post is not None:
            feats, counts = self._post(feats, counts)
        return feats, counts

    def _wrap(self, feats, counts):
        if self._mesh is None:
            return feats, counts
        return (
            global_tensor(feats.contiguous(), self._mesh, self._data_axis),
            global_tensor(counts.contiguous(), self._mesh, self._data_axis),
        )

    def extract_batch(self, signals, lengths):
        """Features for a padded global batch.

        ``signals``: ``(batch, max_len)``; ``lengths``: ``(batch,)``.  Each
        is a DTensor sharded over the data axis (e.g. from
        :func:`~.multihost.global_batch_from_host_local`) or an array (or
        tensor) that every process holds whole.  Host-known ``lengths``
        that are all full take the static-padding path.  Returns
        ``(feats, frame_counts)`` with feats ``(batch, max_frames,
        num_coeffs)``: DTensors sharded over the data axis on a mesh, else
        tensors; rows past a signal's count are garbage to be masked.
        """
        batch, max_len = signals.shape
        if batch % self.batch_multiple:
            raise ValueError(
                f"batch ({batch}) must be a multiple of {self.batch_multiple}"
            )
        full = self._is_full(lengths, max_len)
        if self._mesh is not None:
            signals = local_rows(signals, self._mesh, self._data_axis)
            lengths = local_rows(lengths, self._mesh, self._data_axis)
        dev = self._computer.device
        signals = _to_device(signals, self._computer._dtype, dev)
        if not isinstance(lengths, torch.Tensor):
            lengths = torch.as_tensor(np.asarray(lengths))
        lengths = lengths.to(device=dev, dtype=torch.int64)
        return self._wrap(*self._run(signals, lengths, full))

    def extract_iter(self, batches, min_batch: int = 0, timer=None):
        """Double-buffered extraction over an iterable of signal lists.

        Queues batch ``i+1``'s device work before reading back batch
        ``i``'s results, so host I/O and padding overlap the device.
        Yields one ``[(num_frames_j, num_coeffs)]`` list per input batch.
        ``min_batch`` pads the batch dimension so a trailing partial batch
        keeps the full batches' shape.  ``timer`` (anything with a
        ``stage(name)`` context manager) attributes host padding and the
        queued launches to ``"dispatch"`` and the device wait and readback
        to ``"collect"``.
        """
        stage = (
            timer.stage if timer is not None
            else (lambda name: contextlib.nullcontext())
        )
        pending = None  # (feats, counts, n)
        for signals in batches:
            with stage("dispatch"):
                nxt = self._dispatch(signals, min_batch)
            if pending is not None:
                with stage("collect"):
                    out = self._collect(*pending)
                yield out
            pending = nxt
        if pending is not None:
            with stage("collect"):
                out = self._collect(*pending)
            yield out

    def _dispatch(self, signals: Sequence[np.ndarray], min_batch: int = 0):
        """Queue a batch on the device without waiting for it: this
        process's rows are padded into a pinned host buffer (on a GPU) and
        copied with ``non_blocking=True``, so nothing here synchronises
        with the card.  ``min_batch`` pads the batch dimension up."""
        n = len(signals)
        if n == 0:
            return None, None, 0
        lengths, max_len, buf_dtype = self._host_batch(signals, min_batch)
        start, per = self._row_block(lengths.size)
        rows = self._pad_rows(signals, lengths, max_len, buf_dtype, start, per)
        feats, counts = self._run_block(rows, lengths, max_len, start)
        return (*self._wrap(feats, counts), n)

    def _host_batch(self, signals: Sequence[np.ndarray], min_batch: int = 0):
        """The host side of a global batch of ``signals``: every row's
        length (the padding rows' ``frame_length``), the bucket length, and
        the buffer type (all-compact-integer inputs, int16 PCM, cross to
        the device as they are and are upcast there: half the bytes of
        float32)."""
        c = self._computer
        n = len(signals)
        m = self.batch_multiple
        lengths = np.full(-(-max(n, min_batch) // m) * m, c.frame_length, dtype=np.int64)
        lengths[:n] = [len(s) for s in signals]
        max_len = self.bucket_len(int(lengths[:n].max()))
        if all(_compact_transfer(np.asarray(s).dtype) for s in signals):
            return lengths, max_len, torch.int16
        return lengths, max_len, c._dtype

    def _pad_rows(self, signals, lengths, max_len: int, buf_dtype, start: int, per: int):
        """Rows ``[start, start + per)`` of the padded global batch in a
        host buffer (pinned on a GPU); rows past ``signals`` are zeros."""
        pin = self._computer.device.type == "cuda"
        buf = torch.empty((per, max_len), dtype=buf_dtype, pin_memory=pin)
        rows = buf.numpy()
        n = len(signals)
        for r, i in enumerate(range(start, start + per)):
            k = lengths[i] if i < n else 0
            if k:
                rows[r, :k] = signals[i]
            rows[r, k:] = 0
        return buf

    def _run_block(self, rows, lengths, max_len: int, start: int):
        """Queue the features of one process's row block ``rows`` (host or
        device), the rows ``[start, start + len(rows))`` of a global batch
        whose row lengths are ``lengths``."""
        dev = self._computer.device
        full = self._is_full(lengths, max_len)
        lens = torch.from_numpy(lengths[start: start + rows.shape[0]])
        if dev.type == "cuda":
            lens = lens.pin_memory()
        return self._run(
            rows.to(dev, non_blocking=True), lens.to(dev, non_blocking=True), full
        )

    @staticmethod
    def _collect(feats, counts, n):
        """The one readback: every process gets every row.  From a GPU the
        rows land in pinned memory (a copy to pageable memory runs at a
        fraction of the bus's rate) and each utterance's valid rows are
        copied out, so the pinned block goes back to its pool."""
        if n == 0:
            return []
        if isinstance(feats, DTensor):
            feats, counts = feats.full_tensor(), counts.full_tensor()
        if feats.device.type == "cuda":
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (feats, counts)]
            for dst, src in zip(pinned, (feats, counts)):
                dst.copy_(src, non_blocking=True)
            torch.cuda.current_stream(feats.device).synchronize()
            feats, counts = (t.numpy() for t in pinned)
            return [feats[i, : counts[i]].copy() for i in range(n)]
        counts = counts.numpy()
        feats = feats.numpy()
        return [feats[i, : counts[i]] for i in range(n)]

    def extract(self, signals: Sequence[np.ndarray], min_batch: int = 0):
        """Features for a list of host 1-D signals of any lengths.

        Pads to a length bucket (:meth:`bucket_len`), rounds the batch up
        to the mesh multiple (and at least ``min_batch``), and returns a
        list of ``(num_frames_i, num_coeffs)`` arrays on every process.
        """
        return self._collect(*self._dispatch(signals, min_batch))
