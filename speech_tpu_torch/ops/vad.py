"""Energy-based voice activity detection (Kaldi ``compute-vad``
semantics), in PyTorch.

The counterpart of :mod:`speech_tpu.ops.vad`.  A frame is voiced when at
least ``proportion_threshold`` of its context window's log energies exceed
``energy_threshold + energy_mean_scale * mean(log_energy)``.  Elementwise
work plus one box-window sum (a difference of prefix sums), so it composes
with the computers' ``include_energy`` column on any device.
:func:`energy_vad_np` is the numpy copy of the JAX package's host twin.
"""

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = ["energy_vad", "energy_vad_np"]


def _check(frames_context: int, proportion_threshold: float) -> None:
    if frames_context < 0:
        raise ValueError(f"frames_context must be >= 0, got {frames_context}")
    if not 0.0 < proportion_threshold < 1.0:
        raise ValueError(
            f"proportion_threshold must be in (0, 1), got "
            f"{proportion_threshold}"
        )


def energy_vad(
    log_energy,
    energy_threshold: float = 5.0,
    energy_mean_scale: float = 0.5,
    frames_context: int = 0,
    proportion_threshold: float = 0.6,
    lengths=None,
):
    """Voiced-frame mask for ``(..., T)`` frame log energies.

    ``lengths`` (integers over the leading axes, optional) restricts the
    adaptive mean to each example's valid frames and forces padded frames
    unvoiced.  With ``energy_mean_scale=0`` the threshold is the fixed
    ``energy_threshold``.  Returns a boolean tensor like the input.
    """
    _check(frames_context, proportion_threshold)
    e = log_energy
    T = e.shape[-1]
    valid = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=e.device)
        valid = torch.arange(T, device=e.device) < lengths[..., None]
    if energy_mean_scale:
        if valid is None:
            mean = e.mean(dim=-1, keepdim=True)
        else:
            denom = torch.clamp_min(valid.sum(dim=-1, keepdim=True), 1)
            mean = (e * valid).sum(dim=-1, keepdim=True) / denom
        thresh = energy_threshold + energy_mean_scale * mean
    else:
        thresh = energy_threshold
    above = e > thresh
    if valid is not None:
        above = above & valid
    if frames_context:
        # the vote over the in-bounds (and in-length) context, Kaldi's
        # den_count
        w = frames_context
        ones = torch.ones_like(e, dtype=torch.int64) if valid is None else valid.long()
        num = _window_sum(above.long(), w)
        den = torch.clamp_min(_window_sum(ones, w), 1)
        voiced = num >= proportion_threshold * den
    else:
        voiced = above
    if valid is not None:
        voiced = voiced & valid
    return voiced


def energy_vad_np(
    log_energy,
    energy_threshold: float = 5.0,
    energy_mean_scale: float = 0.5,
    frames_context: int = 0,
    proportion_threshold: float = 0.6,
):
    """Host (numpy) twin of :func:`energy_vad` for 1-D log energies; the
    same mask on unpadded 1-D input."""
    _check(frames_context, proportion_threshold)
    e = np.asarray(log_energy)
    if e.ndim != 1:
        raise ValueError(f"energy_vad_np expects 1-D input, got {e.shape}")
    T = e.shape[-1]
    if T == 0:
        return np.zeros(0, bool)
    if energy_mean_scale:
        thresh = energy_threshold + energy_mean_scale * e.mean()
    else:
        thresh = energy_threshold
    above = e > thresh
    if frames_context and T:
        w = frames_context
        c = np.concatenate([[0], np.cumsum(above.astype(np.int64))])
        hi = c[np.minimum(np.arange(T) + w + 1, T)]
        lo = c[np.maximum(np.arange(T) - w, 0)]
        den = np.minimum(np.arange(T) + w + 1, T) - np.maximum(
            np.arange(T) - w, 0
        )
        voiced = (hi - lo) >= proportion_threshold * den
    else:
        voiced = above
    return voiced


def _window_sum(x, w: int):
    """Sum over the centered, edge-clipped window ``[-w, w]`` along the
    last axis: a difference of the prefix sums, clamped at both ends."""
    T = x.shape[-1]
    c = TF.pad(torch.cumsum(x, dim=-1), (1, 0))  # c[i] = sum x[:i]
    tail = c[..., -1:].expand(*c.shape[:-1], w)  # clamp i + w + 1 to T
    hi = torch.cat([c, tail], dim=-1)[..., w + 1 : w + 1 + T]
    lo = TF.pad(c, (w, 0))[..., :T]  # clamp i - w to 0 (c[0] == 0)
    return hi - lo
