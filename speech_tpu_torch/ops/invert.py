"""Feature inversion in PyTorch: ISTFT, Griffin-Lim and the filter-bank
pseudo-inverse.

The counterpart of :mod:`speech_tpu.ops.invert`, the adjoint of the
forward path :func:`speech_tpu_torch.ops.stft.stft_feats_from_frames`:

- :func:`overlap_add`: each frame is cut into ``ceil(L/S)`` shift-aligned
  segments, and segment ``k`` of every frame lies contiguously in one
  strand at offset ``k*S``, so overlap-add is ``K`` pads and adds;
- :func:`istft`: least-squares inverse STFT of a half spectrum (synthesis
  products, windowed overlap-add, normalized by the window-power
  overlap-add);
- :func:`griffin_lim`: fast Griffin-Lim (momentum; Perraudin et al. 2013),
  the reference's ``lax.scan`` as a loop of ``n_iters`` steps;
- :func:`bank_pseudo_inverse`: the host ridge pseudo-inverse of the folded
  filter weights;
- :func:`feats_to_signal`: log-bank features of an
  :class:`~speech_tpu_torch.compute.STFTFrameComputer` back to a waveform.

Spectra are carried as real/imaginary pairs and every product runs in
IEEE float32 (or float64), as the reference's ``Precision.HIGHEST``.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from . import stft as _stft
from ._device import as_tensor
from .framing import frame_padded
from .stft import ieee_float32

__all__ = [
    "overlap_add",
    "synthesis_matrices",
    "istft",
    "griffin_lim",
    "bank_pseudo_inverse",
    "feats_to_signal",
]


def overlap_add(frames, frame_shift: int, length: Optional[int] = None, device=None):
    """Overlap-add ``(..., T, L)`` frames at hop ``frame_shift``: frame
    ``t`` lands at ``t * frame_shift``.  Returns ``(..., (T-1)*frame_shift
    + L)`` samples, or ``length`` (trimmed or zero-padded)."""
    frames = as_tensor(frames, device)
    *batch, T, L = frames.shape
    S = int(frame_shift)
    if S <= 0:
        raise ValueError(f"frame_shift must be positive, got {frame_shift}")
    K = -(-L // S)
    if K * S != L:
        frames = TF.pad(frames, (0, K * S - L))
    out = None
    for k in range(K):
        seg = frames[..., k * S : (k + 1) * S].reshape(*batch, T * S)
        seg = TF.pad(seg, (k * S, (K - 1 - k) * S))
        out = seg if out is None else out + seg
    out = out[..., : (T - 1) * S + L]
    if length is not None:
        if length <= out.shape[-1]:
            out = out[..., :length]
        else:
            out = TF.pad(out, (0, length - out.shape[-1]))
    return out


def synthesis_matrices(window: np.ndarray, dft_size: int):
    """Host float64 inverse-rDFT matrices with the synthesis window folded
    in: ``(IC, IS)``, each ``(half_len, frame_length)``, such that ``w *
    irfft([re, im], dft_size)[:frame_length] = re @ IC + im @ IS``."""
    window = np.asarray(window, np.float64)
    frame_length = len(window)
    half_len = dft_size // 2 + 1
    b = np.arange(half_len, dtype=np.float64)[:, None]
    t = np.arange(frame_length, dtype=np.float64)[None, :]
    ang = 2 * np.pi * b * t / dft_size
    scale = np.full((half_len, 1), 2.0 / dft_size)
    scale[0] = 1.0 / dft_size
    if dft_size % 2 == 0:
        scale[-1] = 1.0 / dft_size
    IC = scale * np.cos(ang) * window[None, :]
    IS = -scale * np.sin(ang) * window[None, :]
    return IC, IS


def _synthesis_params(window, dft_size: int, like):
    IC, IS = synthesis_matrices(window, dft_size)
    C, S = _stft.windowed_dft_matrices(np.asarray(window, np.float64), dft_size)
    wsq = np.asarray(window, np.float64) ** 2

    def tensor(a):
        return torch.tensor(a, dtype=like.dtype, device=like.device)

    return {
        "idft_cos": tensor(IC),
        "idft_sin": tensor(IS),
        "dft_cos": tensor(C),
        "dft_sin": tensor(S),
        "wsq": tensor(wsq),
    }


def _ls_istft(re, im, params, frame_shift: int, length, eps, frame_mask=None):
    with ieee_float32():
        frames = torch.matmul(re, params["idft_cos"]) + torch.matmul(im, params["idft_sin"])
    T = frames.shape[-2]
    if frame_mask is not None:
        # ragged batches: padded frames add neither signal nor window
        # power, so each example reconstructs as it would alone
        frames = frames * frame_mask[..., None]
        wsq = frame_mask[..., None] * params["wsq"]
    else:
        wsq = params["wsq"].expand(T, params["wsq"].shape[-1])
    num = overlap_add(frames, frame_shift, length)
    den = overlap_add(wsq, frame_shift, length)
    return num / torch.clamp_min(den, eps)


def istft(
    re,
    im,
    window: np.ndarray,
    frame_shift: int,
    *,
    dft_size: Optional[int] = None,
    length: Optional[int] = None,
    eps: float = 1e-12,
    device=None,
):
    """Least-squares inverse STFT of a half spectrum ``re``/``im``
    ``(..., T, dft_size//2 + 1)`` (frame ``t`` starting at ``t *
    frame_shift``, analysed by :func:`.stft.windowed_dft_matrices`).
    Returns ``(..., (T-1)*frame_shift + frame_length)`` samples, the input
    signal exactly wherever the window-power overlap-add exceeds ``eps``.
    """
    re = as_tensor(re, device)
    im = as_tensor(im, re.device).to(re.device)
    if dft_size is None:
        dft_size = 2 * (re.shape[-1] - 1)
    params = _synthesis_params(window, dft_size, re)
    return _ls_istft(re, im, params, int(frame_shift), length, eps)


def griffin_lim(
    mag,
    window: np.ndarray,
    frame_shift: int,
    *,
    dft_size: Optional[int] = None,
    n_iters: int = 64,
    momentum: float = 0.99,
    length: Optional[int] = None,
    lengths=None,
    eps: float = 1e-12,
    device=None,
):
    """Fast Griffin-Lim: a waveform from ``(..., T, dft_size//2 + 1)``
    half-spectrum magnitudes on the analysis grid of :func:`istft`.
    ``n_iters`` accelerated projections (momentum ``momentum``; 0 gives
    classic Griffin-Lim), each a synthesis, overlap-add, re-analysis and
    magnitude projection.  ``lengths`` (valid frame counts over the
    leading axes) masks padded frames out of the magnitudes and the
    window-power normalizer, so each row inverts as it would alone.
    Returns ``(..., (T-1)*frame_shift + frame_length)`` samples (or
    ``length``)."""
    mag = as_tensor(mag, device)
    dtype = mag.dtype
    if dft_size is None:
        dft_size = 2 * (mag.shape[-1] - 1)
    frame_length = len(window)
    frame_shift = int(frame_shift)
    params = _synthesis_params(window, dft_size, mag)
    T = mag.shape[-2]
    frame_mask = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=mag.device)
        frame_mask = (torch.arange(T, device=mag.device) < lengths[..., None]).to(dtype)
        mag = mag * frame_mask[..., None]

    def project(re, im):
        """Consistency (istft, then stft), then the magnitude."""
        y = _ls_istft(re, im, params, frame_shift, None, eps, frame_mask)
        frames = frame_padded(y, T, frame_length, frame_shift)
        with ieee_float32():
            re2 = torch.matmul(frames, params["dft_cos"])
            im2 = torch.matmul(frames, params["dft_sin"])
        norm = torch.sqrt(re2 * re2 + im2 * im2)
        scale = mag / torch.clamp_min(norm, eps)
        return re2 * scale, im2 * scale

    re, im = project(mag, torch.zeros_like(mag))
    pre, pim = mag, torch.zeros_like(mag)
    for _ in range(max(int(n_iters) - 1, 0)):
        nre, nim = project(re + momentum * (re - pre), im + momentum * (im - pim))
        pre, pim, re, im = re, im, nre, nim
    return _ls_istft(re, im, params, frame_shift, length, eps, frame_mask)


def bank_pseudo_inverse(weights: np.ndarray, ridge: float = 1e-8) -> np.ndarray:
    """Host ``(num_filts, half_len)`` ridge pseudo-inverse of the folded
    filter weights ``(half_len, num_filts)`` (``feats = spec @ weights``):
    ``P`` with ``spec ~= feats @ P`` in the least-squares sense, ``ridge``
    relative to the largest squared singular value."""
    W = np.asarray(weights, np.float64)
    G = W.T @ W
    lam = float(ridge) * max(np.linalg.norm(G, 2), 1e-300)
    # P = (W^T W + lam I)^{-1} W^T, transposed into feats @ P form
    return np.linalg.solve(G + lam * np.eye(G.shape[0]), W.T)


def feats_to_signal(
    feats,
    computer,
    *,
    n_iters: int = 64,
    momentum: float = 0.99,
    length: Optional[int] = None,
    lengths=None,
    ridge: float = 1e-8,
):
    """Invert ``(..., T, num_coeffs)`` features of an
    :class:`~speech_tpu_torch.compute.STFTFrameComputer` back to a
    waveform: the energy column dropped, the log inverted, the bank
    pseudo-inverted (:func:`bank_pseudo_inverse`), the power
    square-rooted, then :func:`griffin_lim` with the computer's window,
    hop and DFT size, and the computer's left padding trimmed so that
    sample 0 aligns with the original's.  ``length`` defaults to ``T *
    frame_shift``; ``lengths`` gives each row's valid frame count (samples
    past ``lengths[i] * frame_shift`` are zero).  A tensor stays on its
    device; other input goes to the computer's device.
    """
    if not torch.is_tensor(feats):
        feats = as_tensor(feats, computer.device)
    if computer.includes_energy:
        feats = feats[..., 1:]
    lin = torch.exp(feats) if computer._log else feats
    P = torch.tensor(
        bank_pseudo_inverse(np.asarray(computer._weights), ridge),
        dtype=feats.dtype, device=feats.device,
    )
    with ieee_float32():
        spec = torch.clamp_min(torch.matmul(lin, P), 0.0)
    mag = torch.sqrt(spec) if computer._power else spec
    T = feats.shape[-2]
    if length is None:
        length = T * computer.frame_shift
    pad_left = computer._pad_left
    y = griffin_lim(
        mag,
        np.asarray(computer._window, np.float64),
        computer.frame_shift,
        dft_size=computer._dft_size,
        n_iters=n_iters,
        momentum=momentum,
        length=pad_left + int(length),
        lengths=lengths,
    )
    return y[..., pad_left:]
