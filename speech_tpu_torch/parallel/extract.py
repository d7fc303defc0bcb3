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
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..aot import active_store, using
from ..compute import _compact_transfer, _to_device
from ..ops.stft_kernels import layout_rows
from .mesh import axis_size, global_tensor, local_rows, local_tensor

__all__ = ["ShardedExtractor", "sharded_pitch_feats"]


_NULL = contextlib.nullcontext()
# bytes each packed row starts on: the layout kernel loads such rows in
# 16-byte vectors
_PACK_ALIGN = 16


def _no_stage(name):
    """The ``stage`` of no timer: records nothing."""
    return _NULL


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

    Attributes
    ----------
    stats
        Monotonic counters of this process's part of the batches that
        :meth:`extract` and :meth:`extract_iter` queued: ``batches``,
        ``rows`` (padded rows), ``samples`` (the real samples of those
        rows) and ``kernel_samples`` (rows times the bucket length: what
        the computer was handed).  ``samples / kernel_samples`` is the
        share of the computer's input that is not padding.
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
        self.stats = {"batches": 0, "rows": 0, "samples": 0, "kernel_samples": 0}
        # batches cross packed and are laid out on the card (a GPU), else
        # padded on the host
        self._packs = computer.device.type == "cuda"
        self._stats_lock = threading.Lock()
        self._local = threading.local()  # the stage of this thread's timed call
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
        to ``"collect"``, and the parts of each to the stages nested in
        them (:meth:`_dispatch`, :meth:`_collect`).
        """
        stage = _no_stage if timer is None else timer.stage
        pending = None  # (feats, counts, n)
        for signals in batches:
            with stage("dispatch"), self._timed(timer):
                nxt = self._dispatch(signals, min_batch)
            if pending is not None:
                with stage("collect"), self._timed(timer):
                    out = self._collect(*pending)
                yield out
            pending = nxt
        if pending is not None:
            with stage("collect"), self._timed(timer):
                out = self._collect(*pending)
            yield out

    @contextlib.contextmanager
    def _timed(self, timer):
        """A block in which this thread's :meth:`_dispatch` and
        :meth:`_collect` report their parts to ``timer`` (nothing when it
        is None).  The timer rides on the thread, not in their arguments,
        because wrappers replace ``_dispatch(signals, min_batch)`` and
        ``_collect(feats, counts, n)`` with those signatures (the tests'
        and the benchmark's planted faults)."""
        prev = getattr(self._local, "stage", None)
        self._local.stage = None if timer is None else timer.stage
        try:
            yield
        finally:
            self._local.stage = prev

    def _stage(self, name: str):
        """This thread's timer's ``stage(name)`` inside :meth:`_timed`."""
        return (getattr(self._local, "stage", None) or _no_stage)(name)

    def _dispatch(self, signals: Sequence[np.ndarray], min_batch: int = 0):
        """Queue a batch on the device without waiting for it.  On a GPU
        this process's rows are packed, only their real samples, into a
        pinned host buffer (:meth:`_pack_rows`), copied with
        ``non_blocking=True`` and laid out as zero-padded rows on the card
        (:meth:`_lay_out`); elsewhere they are padded on the host
        (:meth:`_pad_rows`).  Nothing here synchronises with the card.
        ``min_batch`` pads the batch dimension up.  Inside :meth:`_timed`
        the packing (or padding) is stage ``"pad"`` and the queued copies
        and launches, the layout's among them, ``"launch"``."""
        n = len(signals)
        if n == 0:
            return None, None, 0
        stage = self._stage
        lengths, max_len, buf_dtype = self._host_batch(signals, min_batch)
        start, per = self._row_block(lengths.size)
        with stage("pad"):
            buf, table = self._host_rows(signals, lengths, max_len, buf_dtype, start, per)
        with stage("launch"):
            rows, lens = self._lay_out(buf, table, max_len)
            feats, counts = self._run_block(rows, lengths, max_len, start, lens)
        samples = int(lengths[start: max(start, min(start + per, n))].sum())
        with self._stats_lock:
            st = self.stats
            st["batches"] += 1
            st["rows"] += per
            st["samples"] += samples
            st["kernel_samples"] += per * max_len
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

    def _host_rows(self, signals, lengths, max_len: int, buf_dtype, start: int, per: int):
        """The host's part of rows ``[start, start + per)`` of a global
        batch, ``(buffer, table)``: packed (:meth:`_pack_rows`) where
        batches cross packed, else the padded rows (:meth:`_pad_rows`) and
        no table."""
        if self._packs:
            return self._pack_rows(signals, lengths, buf_dtype, start, per)
        return self._pad_rows(signals, lengths, max_len, buf_dtype, start, per), None

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

    def _pack_rows(self, signals, lengths, buf_dtype, start: int, per: int):
        """Rows ``[start, start + per)`` of a global batch, packed: only
        their real samples, back to back in one 1-D host buffer (pinned on
        a GPU), each row from a multiple of 16 bytes, cast as
        :meth:`_pad_rows` casts them; and an int64 ``(3, per)`` table
        beside it (pinned too): the rows' ``lengths``, their offsets into
        the buffer and their sample counts (0 for rows past ``signals``)."""
        pin = self._computer.device.type == "cuda"
        n = len(signals)
        table = torch.empty((3, per), dtype=torch.int64, pin_memory=pin)
        lens, offsets, counts = table.numpy()
        lens[:] = lengths[start: start + per]
        counts[:] = lens
        counts[max(0, n - start):] = 0
        align = _PACK_ALIGN // buf_dtype.itemsize
        spans = -(-counts // align) * align
        offsets[0] = 0
        np.cumsum(spans[:-1], out=offsets[1:])
        buf = torch.empty(max(int(spans.sum()), align), dtype=buf_dtype, pin_memory=pin)
        flat = buf.numpy()
        for r in range(min(per, max(0, n - start))):
            k = counts[r]
            if k:
                flat[offsets[r]: offsets[r] + k] = signals[start + r]
        return buf, table

    def _lay_out(self, buf, table, max_len: int):
        """``(rows, lengths)`` of :meth:`_host_rows`' ``(buffer, table)``.
        A packed buffer is queued on the device: one copy of it and one of
        its table, then the layout kernel's zero-padded ``(per, max_len)``
        rows, and the rows' lengths on the device.  Padded rows (no table)
        are as they are (:meth:`_run_block` copies them), the lengths
        None."""
        if table is None:
            return buf, None
        dev = self._computer.device
        table = table.to(dev, non_blocking=True)
        with using(self._computer._aot):
            rows = layout_rows(buf.to(dev, non_blocking=True), table[1], table[2], max_len)
        return rows, table[0]

    def load_libraries(self):
        """Load (into the computer's store, where it has one) the kernel
        libraries this extractor's batches need beside the computer's own:
        every one where batches cross packed (a GPU), for the layout
        kernel, whatever route the computer takes.
        :func:`~speech_tpu_torch.aot.precompile_extractor` calls it."""
        if self._packs:
            from ..ops import _build

            with using(self._computer._aot):
                _build.load_kernels(active_store())

    def _run_block(self, rows, lengths, max_len: int, start: int, lens=None):
        """Queue the features of one process's row block ``rows`` (host or
        device), the rows ``[start, start + len(rows))`` of a global batch
        whose row lengths are ``lengths`` (``lens``: that block of them,
        where it is on the device already)."""
        dev = self._computer.device
        full = self._is_full(lengths, max_len)
        if lens is None:
            lens = torch.from_numpy(lengths[start: start + rows.shape[0]])
            if dev.type == "cuda":
                lens = lens.pin_memory()
        return self._run(
            rows.to(dev, non_blocking=True), lens.to(dev, non_blocking=True), full
        )

    def _collect(self, feats, counts, n):
        """The one readback: every process gets every row.  From a GPU the
        rows land in pinned memory (a copy to pageable memory runs at a
        fraction of the bus's rate) and each utterance's valid rows are
        copied out, so the pinned block goes back to its pool.  Inside
        :meth:`_timed` the gather of a mesh's rows is stage ``"gather"``,
        the wait for the card with the readback ``"wait"`` and the copies
        of the valid rows ``"unpack"``."""
        if n == 0:
            return []
        stage = self._stage
        if isinstance(feats, DTensor):
            with stage("gather"):
                feats, counts = feats.full_tensor(), counts.full_tensor()
        if feats.device.type == "cuda":
            with stage("wait"):
                pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in (feats, counts)]
                for dst, src in zip(pinned, (feats, counts)):
                    dst.copy_(src, non_blocking=True)
                torch.cuda.current_stream(feats.device).synchronize()
                feats, counts = (t.numpy() for t in pinned)
            with stage("unpack"):
                return [feats[i, : counts[i]].copy() for i in range(n)]
        with stage("wait"):
            counts = counts.numpy()
            feats = feats.numpy()
        with stage("unpack"):
            return [feats[i, : counts[i]] for i in range(n)]

    def extract(self, signals: Sequence[np.ndarray], min_batch: int = 0):
        """Features for a list of host 1-D signals of any lengths.

        Pads to a length bucket (:meth:`bucket_len`), rounds the batch up
        to the mesh multiple (and at least ``min_batch``), and returns a
        list of ``(num_frames_i, num_coeffs)`` arrays on every process.
        """
        return self._collect(*self._dispatch(signals, min_batch))
