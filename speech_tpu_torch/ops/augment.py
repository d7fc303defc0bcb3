"""Data augmentation in PyTorch: SpecAugment and the waveform
augmentations of a Kaldi-style training pipeline (reverberation, noise at
a target SNR, speed perturbation, gain perturbation).

The counterpart of :mod:`speech_tpu.ops.augment`.  Its ``key`` arguments
become :class:`torch.Generator` s (on the data's device), as in
:func:`speech_tpu_torch.pre.dither`; the two packages draw different
numbers from the same seed.  Each random op keeps the step from its
uniform draws to masks, offsets or gains in a private function
(``_spec_augment_from_draws``, ``_mix_noise_at``, ``_gain_from_db``), so
that the same draws give the same result in both packages.  Reverberation
is one banded-Toeplitz product (:func:`.resample.fir_conv_matmul`), speed
perturbation the polyphase resampler; every op is lengths-aware, so a
bucketed batch's rows equal the solo op on their valid extents with the
padding kept zero.
"""

from fractions import Fraction
from typing import Optional, Union

import numpy as np
import torch

from . import resample as _resample
from ._device import as_tensor

__all__ = [
    "spec_augment",
    "reverberate",
    "mix_noise",
    "speed_perturb",
    "random_gain",
]


def _float_signal(signal, device):
    signal = as_tensor(signal, device)
    if not signal.is_floating_point():
        signal = signal.to(torch.float32)
    return signal


def _uniform(generator, shape, device, dtype=torch.float32):
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _axis_mask(dim: int, width, start_u, limits):
    """OR of random intervals along an axis of size ``dim``, from draws:
    ``width`` ``(batch..., num_masks)`` uniform on ``[0, max_width]``,
    ``start_u`` (the same shape) uniform on ``[0, 1)``.  ``limits`` (over
    the batch axes, or None) caps where intervals may land; widths are
    capped to it too.  Returns a boolean ``(batch..., dim)`` tensor."""
    device = width.device
    if limits is None:
        lim = torch.full(width.shape, float(dim), dtype=torch.float32, device=device)
    else:
        lim = torch.as_tensor(limits, device=device).to(torch.float32)
        lim = lim.reshape(tuple(width.shape[:-1]) + (1,)) * torch.ones(
            width.shape, dtype=torch.float32, device=device
        )
    width = torch.minimum(width, lim)
    start = (start_u * (lim - width))[..., None]
    iota = torch.arange(dim, dtype=torch.float32, device=device)
    hit = (iota >= start) & (iota < start + width[..., None])
    return torch.any(hit, dim=-2)


def _spec_augment_from_draws(features, freq, time, lengths, mask_value):
    """:func:`spec_augment` of ``(..., T, F)`` features given its draws:
    ``freq`` and ``time`` are ``(width, start_u)`` pairs for
    :func:`_axis_mask`, or None for no masks on that axis."""
    batch_shape = features.shape[:-2]
    T, F = features.shape[-2], features.shape[-1]
    masked = torch.zeros(features.shape, dtype=torch.bool, device=features.device)
    valid = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=features.device)
        # (batch..., T, 1): the frames inside each example's true length
        valid = torch.arange(T, device=features.device).reshape(
            (1,) * len(batch_shape) + (T, 1)
        ) < lengths.reshape(tuple(batch_shape) + (1, 1))
    if freq is not None:
        masked = masked | _axis_mask(F, *freq, None)[..., None, :]
    if time is not None:
        masked = masked | _axis_mask(T, *time, lengths)[..., :, None]
    if valid is not None:
        # padded frames pass through untouched (frequency masks too)
        masked = masked & valid
    if isinstance(mask_value, str):
        if mask_value != "mean":
            raise ValueError(f"mask_value must be a float or 'mean', got {mask_value!r}")
        if valid is None:
            fill = features.mean(dim=(-2, -1), keepdim=True)
        else:
            denom = torch.clamp_min(valid.sum(dim=(-2, -1), keepdim=True) * F, 1)
            fill = (features * valid).sum(dim=(-2, -1), keepdim=True) / denom
        fill = fill.to(features.dtype)
    else:
        fill = torch.as_tensor(mask_value, dtype=features.dtype, device=features.device)
    return torch.where(masked, fill, features)


def spec_augment(
    generator: Optional[torch.Generator],
    features,
    num_freq_masks: int = 2,
    freq_mask_param: int = 27,
    num_time_masks: int = 2,
    time_mask_param: int = 100,
    lengths=None,
    mask_value: Union[float, str] = 0.0,
    time_axis: int = -2,
    feat_axis: int = -1,
    device=None,
):
    """SpecAugment masking of a ``(..., time, feats)`` tensor.

    Draws ``num_freq_masks`` frequency bands (width uniform on ``[0,
    freq_mask_param]``) and ``num_time_masks`` time spans (width uniform
    on ``[0, time_mask_param]``) per example from ``generator`` (None:
    torch's default generator on the features' device), and replaces the
    masked cells with ``mask_value`` (a float, or ``"mean"`` for the
    per-example mean).  ``lengths`` confines time masks to each example's
    valid frames and leaves padded frames untouched.  Time warping is
    omitted, as in the reference.
    """
    features = as_tensor(features, device)
    ndim = features.ndim
    time_axis = time_axis % ndim
    feat_axis = feat_axis % ndim
    if time_axis == feat_axis:
        raise ValueError(f"time and feature axes are the same ({time_axis})")
    if (time_axis, feat_axis) != (ndim - 2, ndim - 1):
        # to (..., time, feats) once, and back at the end
        perm = [i for i in range(ndim) if i not in (time_axis, feat_axis)]
        perm += [time_axis, feat_axis]
        out = spec_augment(
            generator, features.permute(perm), num_freq_masks, freq_mask_param,
            num_time_masks, time_mask_param, lengths, mask_value,
        )
        return out.permute([perm.index(i) for i in range(ndim)])
    batch_shape = tuple(features.shape[:-2])

    def draws(num, param):
        if not (num and param):
            return None
        shape = batch_shape + (num,)
        width = _uniform(generator, shape, features.device) * float(param)
        return width, _uniform(generator, shape, features.device)

    freq = draws(num_freq_masks, freq_mask_param)
    time = draws(num_time_masks, time_mask_param)
    return _spec_augment_from_draws(features, freq, time, lengths, mask_value)


def _valid_mask(batch_shape, N: int, lengths, device):
    """``(batch..., N)`` mask of each example's valid samples, or None."""
    if lengths is None:
        return None
    iota = torch.arange(N, device=device).reshape((1,) * len(batch_shape) + (N,))
    return iota < torch.as_tensor(lengths, device=device).reshape(tuple(batch_shape) + (1,))


def reverberate(
    signal,
    rir,
    lengths=None,
    align: bool = True,
    power_norm: bool = True,
    precision="highest",
    device=None,
):
    """Convolve ``(..., N)`` signals with a room impulse response (Kaldi
    ``wav-reverberate`` semantics): the output keeps the input's length;
    ``align`` shifts it left by the direct-path delay (the RIR's
    peak-magnitude tap); ``power_norm`` rescales each example to its input
    power over the valid extent.  ``rir`` is a host 1-D array, folded into
    one banded-Toeplitz constant.  With ``lengths``, each row equals the
    solo op on its valid extent and the padding is zero.
    """
    signal = _float_signal(signal, device)
    rir = np.asarray(rir, np.float64)
    if rir.ndim != 1 or rir.size < 1:
        raise ValueError(f"rir must be a 1-D host array, got shape {rir.shape}")
    W = rir.size
    N = signal.shape[-1]
    delay = int(np.argmax(np.abs(rir))) if align else 0
    # full convolution y[i] = sum_s rir[s] x[i - s], shifted by the delay:
    # a correlation with the reversed RIR at pad_left = W - 1 - delay
    out = _resample.fir_conv_matmul(
        signal, rir[::-1].copy(), stride=1, pad_left=W - 1 - delay, n_out=N,
        precision=precision, group=1024,
    )
    valid = _valid_mask(signal.shape[:-1], N, lengths, signal.device)
    if valid is not None:
        out = torch.where(valid, out, 0.0)
    if power_norm:
        sq = torch.square(signal) if valid is None else torch.square(signal) * valid
        e_in = torch.sum(sq, dim=-1, keepdim=True)
        e_out = torch.sum(torch.square(out), dim=-1, keepdim=True)
        tiny = torch.finfo(signal.dtype).tiny
        scale = torch.sqrt(e_in / torch.clamp_min(e_out, tiny))
        out = out * torch.where(e_out > 0, scale, 1.0).to(signal.dtype)
    return out.to(signal.dtype)


def _tiled(noise, N: int):
    """``noise`` repeated along its last axis to at least ``N`` samples."""
    if noise.shape[-1] >= N:
        return noise
    return noise.repeat((1,) * (noise.ndim - 1) + (-(-N // noise.shape[-1]),))


def _mix_noise_at(signal, noise, offsets, snr_db, lengths):
    """:func:`mix_noise` given its draws: ``offsets`` (integers over the
    batch axes; None reads every window from offset 0)."""
    batch_shape = tuple(signal.shape[:-1])
    N = signal.shape[-1]
    noise = _tiled(torch.as_tensor(noise, device=signal.device).to(signal.dtype), N)
    Nn = noise.shape[-1]
    if offsets is not None:
        doubled = torch.cat([noise, noise], dim=-1).expand(batch_shape + (2 * Nn,))
        idx = torch.as_tensor(offsets, device=signal.device).to(torch.int64)[..., None]
        idx = idx + torch.arange(N, device=signal.device)
        noise_win = torch.take_along_dim(doubled, idx, dim=-1)
    else:
        noise_win = noise[..., :N].expand(batch_shape + (N,))
    valid = _valid_mask(batch_shape, N, lengths, signal.device)
    sq_sig, sq_noise = torch.square(signal), torch.square(noise_win)
    if valid is not None:
        sq_sig, sq_noise = sq_sig * valid, sq_noise * valid
    e_sig = torch.sum(sq_sig, dim=-1, keepdim=True)
    e_noise = torch.sum(sq_noise, dim=-1, keepdim=True)
    snr = torch.as_tensor(snr_db, device=signal.device).to(signal.dtype)
    snr = snr.reshape(snr.shape + (1,) * (signal.ndim - snr.ndim))
    # E_out_noise = E_sig * 10^(-snr/10): the amplitude scale below
    tiny = torch.finfo(signal.dtype).tiny
    scale = torch.sqrt(e_sig / torch.clamp_min(e_noise, tiny)) * torch.exp2(
        -snr * (np.log2(10.0) / 20.0)
    )
    scale = torch.where(e_noise > 0, scale, 0.0).to(signal.dtype)
    noisy = signal + scale * noise_win
    if valid is not None:
        noisy = torch.where(valid, noisy, 0.0)
    return noisy


def mix_noise(
    generator: Optional[torch.Generator],
    signal,
    noise,
    snr_db,
    lengths=None,
    device=None,
):
    """Add ``noise`` to ``(..., N)`` signals at a per-example target SNR
    ``snr_db`` (scalar or broadcastable over the batch axes), measured
    over each example's valid extent.  ``noise`` is one 1-D buffer or a
    batched ``(..., Nn)`` one, tiled where shorter than the signal.  With
    a ``generator``, each example reads the buffer at an independent
    uniform circular offset; with None, at offset 0.  Padding stays zero.
    """
    signal = _float_signal(signal, device)
    noise = _tiled(torch.as_tensor(noise, device=signal.device), signal.shape[-1])
    offsets = None
    if generator is not None:
        offsets = torch.randint(
            0, noise.shape[-1], tuple(signal.shape[:-1]), generator=generator,
            device=signal.device,
        )
    return _mix_noise_at(signal, noise, offsets, snr_db, lengths)


def speed_perturb(
    signal,
    factor,
    lengths=None,
    max_denominator: int = 32,
    precision="highest",
    device=None,
):
    """Speed-perturb ``(..., N)`` signals by ``factor`` (sox ``speed``:
    1.1 plays 10% faster, so the waveform is resampled to ``N/factor``
    samples at the unchanged rate).  ``factor`` snaps to
    ``Fraction(factor).limit_denominator(max_denominator)``.  Returns the
    resampled signals; with ``lengths``, ``(out, new_lengths)`` with each
    row masked to ``ceil(lengths*den/num)``.
    """
    frac = Fraction(factor).limit_denominator(int(max_denominator))
    if frac <= 0:
        raise ValueError(f"factor must be positive, got {factor}")
    up, down = frac.denominator, frac.numerator
    out = _resample.resample(signal, up, down, precision=precision, device=device)
    if lengths is None:
        return out
    lengths = torch.as_tensor(lengths, device=out.device)
    new_lengths = torch.div(lengths * up + down - 1, down, rounding_mode="floor")
    valid = _valid_mask(out.shape[:-1], out.shape[-1], new_lengths, out.device)
    return torch.where(valid, out, 0.0), new_lengths


def _gain_from_db(signal, db):
    """:func:`random_gain` given its draws, ``db`` over the batch axes."""
    return signal * torch.exp2(db * (np.log2(10.0) / 20.0))[..., None]


def random_gain(
    generator: Optional[torch.Generator],
    signal,
    min_gain_db: float = -6.0,
    max_gain_db: float = 6.0,
    device=None,
):
    """Scale each example of ``(..., N)`` by an independent uniform gain in
    ``[min_gain_db, max_gain_db]`` dB (volume perturbation)."""
    signal = _float_signal(signal, device)
    u = _uniform(generator, tuple(signal.shape[:-1]), signal.device, signal.dtype)
    lo = float(min_gain_db)
    db = torch.clamp_min(u * (float(max_gain_db) - lo) + lo, lo)
    return _gain_from_db(signal, db)
