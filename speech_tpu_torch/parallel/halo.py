"""Sequence parallelism: time-axis sharding of one long signal.

The counterpart of :mod:`speech_tpu.parallel.halo` on
``torch.distributed``.  Each process owns one span of a long signal's time
axis and frames it; a frame needs up to ``frame_length`` samples of its
neighbours' spans, fetched by one pair of point-to-point messages each way
(the counterpart of the ``ppermute`` pair), after which framing and the
feature pipeline are process-local.  Symmetric padding applies at the
*global* signal edges only: the index math reflects in global coordinates,
so the edge processes reproduce the single-device output.

Static-shape contract: the span per process ``C = sig_len / n`` must be a
multiple of ``frame_shift`` and at least ``frame_length``; then each
process owns exactly ``C / frame_shift`` frames and the global output
matches ``compute_full``'s ``(len + shift//2) // shift`` frame count.

Results are DTensors sharded over the axis on the frame dimension
(``.full_tensor()`` gathers them).
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import si as _si
from ..ops import stft as _stft
from ..ops.framing import frame_padded, reflect_index
from .mesh import axis_size, global_tensor, local_tensor

__all__ = ["halo_frame_signal", "sharded_stft_feats", "sharded_si_feats"]


def _halo_exchange(chunk, halo: int, mesh: DeviceMesh, axis: str):
    """``[left | chunk | right]``: the last ``halo`` samples of the left
    neighbour's span and the first ``halo`` of the right neighbour's (zeros
    at the mesh edges).  Every send and receive is posted before any is
    waited on, so no process waits on a neighbour that waits on it."""
    group = mesh.get_group(axis)
    n, d = axis_size(mesh, axis), mesh.get_local_rank(axis)
    left = chunk.new_zeros(halo)
    right = chunk.new_zeros(halo)
    ops = []
    if d > 0:
        peer = dist.get_global_rank(group, d - 1)
        ops += [
            dist.P2POp(dist.isend, chunk[:halo].contiguous(), peer, group),
            dist.P2POp(dist.irecv, left, peer, group),
        ]
    if d < n - 1:
        peer = dist.get_global_rank(group, d + 1)
        ops += [
            dist.P2POp(dist.isend, chunk[-halo:].contiguous(), peer, group),
            dist.P2POp(dist.irecv, right, peer, group),
        ]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left, chunk, right])


def _local_frames(
    chunk,
    mesh: DeviceMesh,
    axis: str,
    *,
    sig_len: int,
    frame_length: int,
    frame_shift: int,
    pad_left: int,
):
    span = chunk.shape[0]
    buf = _halo_exchange(chunk, frame_length, mesh, axis)
    base = mesh.get_local_rank(axis) * span
    # global-edge fix-up: halo samples whose global positions fall outside
    # [0, sig_len) take their symmetric reflections (which always land in
    # this process's own span); interior processes gather identity
    # positions
    halo_i = torch.arange(frame_length, device=buf.device)
    lpos = reflect_index(base - frame_length + halo_i, sig_len)
    rpos = reflect_index(base + span + halo_i, sig_len)
    buf = torch.cat(
        [
            buf[lpos - base + frame_length],
            buf[frame_length : frame_length + span],
            buf[rpos - base + frame_length],
        ]
    )
    # local frame j covers buffer [j*shift + frame_length - pad_left, ...)
    return frame_padded(
        buf[frame_length - pad_left :], span // frame_shift, frame_length, frame_shift
    )


def _check_span(sig_len: int, n: int, shift: int, least: int, what: str):
    span = sig_len // n
    if sig_len % n or span % shift or span < least:
        raise ValueError(
            f"sig_len ({sig_len}) must split into per-chip spans that are "
            f"multiples of frame_shift ({shift}) and at least {what}"
        )


def halo_frame_signal(
    signal,
    mesh: DeviceMesh,
    axis: str,
    frame_length: int,
    frame_shift: int,
    pad_left: int,
):
    """Frame a time-sharded signal with neighbour halo exchange.

    ``signal`` is the global ``(sig_len,)`` signal: a DTensor sharded over
    ``axis``, or an array every process holds whole.  Returns the
    ``(sig_len // frame_shift, frame_length)`` frames as a DTensor sharded
    over ``axis`` on the frame dimension; equal, bit for bit, to
    :func:`speech_tpu_torch.ops.framing.frame_padded` of the whole padded
    signal on one device.
    """
    n = axis_size(mesh, axis)
    sig_len = signal.shape[0]
    _check_span(
        sig_len, n, frame_shift, frame_length,
        f"frame_length ({frame_length})",
    )
    chunk = local_tensor(signal, mesh, axis)
    frames = _local_frames(
        chunk,
        mesh,
        axis,
        sig_len=sig_len,
        frame_length=frame_length,
        frame_shift=frame_shift,
        pad_left=pad_left,
    )
    return global_tensor(frames.contiguous(), mesh, axis)


def sharded_stft_feats(computer, signal, mesh: DeviceMesh, axis: str):
    """Full sequence-parallel STFT features for one long signal.

    Halo-exchange framing (above) followed by the process-local plain
    pipeline of the computer's tier.  When ``sig_len`` is a multiple of
    ``n * frame_shift`` the global frame count ``(sig_len + shift//2) //
    shift == sig_len // shift`` and the output matches
    ``computer.compute_full(signal)``.  A DTensor sharded over ``axis``.
    """
    n = axis_size(mesh, axis)
    sig_len = signal.shape[0]
    fl, fs = computer._frame_length, computer._frame_shift
    _check_span(sig_len, n, fs, fl, f"frame_length ({fl})")
    chunk = local_tensor(signal, mesh, axis, computer._dtype)
    frames = _local_frames(
        chunk,
        mesh,
        axis,
        sig_len=sig_len,
        frame_length=fl,
        frame_shift=fs,
        pad_left=computer._pad_left,
    )
    feats = _stft.stft_feats_from_frames(
        frames, computer.params, **computer._static_spec
    )
    return global_tensor(feats.contiguous(), mesh, axis)


def sharded_si_feats(computer, signal, mesh: DeviceMesh, axis: str):
    """Sequence-parallel SI features for one long, time-sharded signal.

    Each process owns ``span = sig_len / n`` samples and the corresponding
    ``span / shift`` frames.  A frame's convolution taps plus its
    integration window reach at most ``max_support - 1 + 2 * frame_shift``
    samples beyond the span: one halo exchange, after which the SI
    pipeline runs locally with its alignment constants rebased into
    halo-extended coordinates.  At the mesh edges the halo is zeros, which
    *is* the global semantics: the SI computer zero-extends the signal
    (reference: compute.py:774-847).

    Returns ``(sig_len // shift, num_coeffs)`` as a DTensor sharded over
    ``axis``; the first ``computer.frame_counts_np(sig_len)`` rows match
    ``computer.compute_full(signal)`` (the remainder, when any, are the
    final-frame undershoot the reference also drops).
    """
    n = axis_size(mesh, axis)
    sig_len = signal.shape[0]
    s = computer._frame_shift
    T = computer._kernel["max_support"]
    halo = T - 1 + 2 * s
    _check_span(
        sig_len, n, s, halo,
        f"the halo ({halo} = max_support - 1 + 2*frame_shift)",
    )
    span = sig_len // n
    buf_len = span + 2 * halo
    spec = computer._spec(_si._next_pow2(buf_len + T))
    # rebase the y[0] anchor: local buffer position 0 is global sample
    # d*span - halo, so the first local frame reads the local convolution
    # starting halo samples later than the global shift_eff
    spec["shift_eff"] = computer._shift_eff + halo
    spec["energy_offset"] = spec["shift_eff"] - computer._kernel["translation"]
    chunk = local_tensor(signal, mesh, axis, computer._dtype)
    buf = _halo_exchange(chunk, halo, mesh, axis)
    feats = _si.si_feats_from_signal(
        buf, buf_len, span // s, computer._params_for(spec), **spec
    )
    return global_tensor(feats.contiguous(), mesh, axis)
