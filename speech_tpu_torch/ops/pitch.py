"""Pitch tracking in the style of Kaldi ``compute-kaldi-pitch``, in PyTorch.

The counterpart of :mod:`speech_tpu.ops.pitch` (Ghahremani et al., "A
pitch extraction algorithm tuned for automatic speech recognition", ICASSP
2014): the signal is resampled and lowpassed, the normalized
cross-correlation (NCCF) is computed at integer lags with an energy
ballast, interpolated onto a geometric lag grid, and an offline
whole-utterance Viterbi picks the lag path under a log-lag transition
penalty; the POV-weighted log-pitch normalization and delta make the
three Kaldi-style feature columns.

The host tables are numpy copies of the JAX package's.  On the device:

- one strided view of each frame's lag windows, made contiguous per group
  of at most 16 utterances (``[16, T, n_int, window]``: 554 MB in float32
  at 10 s and 4 kHz, plus one temporary of the same size for the window
  energies), and two batched products give every integer lag's sums;
- the Viterbi is two Python loops over the frames (a ``[B, L, L]`` min a
  step forward, a ``[B, L]`` argmin a step back), as the reference's two
  ``lax.scan`` passes, ended at the longest row's frames where the host
  holds the lengths, with each step's costs shifted by their minimum so
  that float32 keeps the float64 path; ``torch.argmin`` returns the first
  index of a tie, as ``jnp.argmin`` does, so the path is the
  forward-pointer path.  On a CUDA device in float32 the same path comes
  from one hand-written kernel launch instead
  (:func:`.stft_kernels.viterbi_path`, :func:`viterbi_on_kernel`);
- every product runs in IEEE float32 (or float64), as the reference's
  ``Precision.HIGHEST``.

The reference takes its float32 logs through a bit-level ``log32``
(``speech_tpu/ops/xmath.py``) because the TPU's own log is approximate;
``torch.log`` on the card and the CPU is accurate, so the port uses it.
"""

import inspect
from functools import lru_cache
from math import gcd
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import stft_kernels
from ._device import as_tensor, host_constant
from .framing import frame_padded
from .postops import delta_filters, deltas
from .resample import fir_conv_matmul, resample
from .stft import ieee_float32

__all__ = [
    "PitchTrack",
    "kaldi_pitch",
    "nccf_to_pov",
    "pitch_feats",
    "pitch_feats_from_track",
    "pitch_frame_counts",
    "pitch_lag_count",
    "viterbi_on_kernel",
]


class PitchTrack(NamedTuple):
    """Per-frame pitch-track tensors, each ``(..., T)``."""

    f0: torch.Tensor  #: fundamental frequency estimate (Hz)
    nccf: torch.Tensor  #: ballast-free NCCF at the chosen lag, in [-1, 1]
    valid: torch.Tensor  #: bool; False on frames past a signal's length


_INTERP_HW = 8  # half-width of the lag-interpolation sinc, integer lags
_GROUP = 16  # utterances whose lag windows are live at once


@lru_cache(maxsize=16)
def _lag_tables(
    rate: float,
    min_f0: float,
    max_f0: float,
    penalty: float,
    resolution: float,
):
    """Host precompute for the lag search: ``(lo_int, n_int, fine_lags,
    interp, trans)``.  The NCCF is computed at the ``n_int`` integer lags
    from ``lo_int`` (covering ``[rate/max_f0, rate/min_f0]`` plus
    interpolation support), then mapped onto a geometric lag grid with
    relative step ``resolution`` by the windowed-sinc matrix ``interp``;
    ``trans`` is the Viterbi transition cost ``penalty * (log lag_i - log
    lag_j)^2`` over the fine grid."""
    if not 0 < min_f0 < max_f0:
        raise ValueError(f"need 0 < min_f0 < max_f0, got {min_f0}/{max_f0}")
    if not 0 < resolution < 1:
        raise ValueError(f"need lag resolution in (0, 1), got {resolution}")
    if not penalty >= 0:  # a cost on lag changes; _viterbi relies on it
        raise ValueError(f"need penalty_factor >= 0, got {penalty}")
    min_lag = rate / max_f0
    max_lag = rate / min_f0
    if max_lag < min_lag + 2:
        raise ValueError(
            f"degenerate lag range [{min_lag}, {max_lag}] at rate {rate}"
        )
    n_fine = int(np.ceil(np.log(max_lag / min_lag) / np.log1p(resolution)))
    fine = min_lag * (1.0 + resolution) ** np.arange(n_fine + 1)
    fine[-1] = max_lag
    lo_int = max(int(np.floor(min_lag)) - _INTERP_HW, 1)
    hi_int = int(np.ceil(max_lag)) + _INTERP_HW
    ints = np.arange(lo_int, hi_int + 1, dtype=np.float64)
    delta = fine[None, :] - ints[:, None]  # [n_int, n_fine]
    win = np.where(np.abs(delta) <= _INTERP_HW, _kaiser_at(delta, _INTERP_HW), 0.0)
    interp = np.sinc(delta) * win
    # renormalize where edge clamping truncated the sinc support (only
    # possible at the short-lag end when lo_int hit 1)
    colsum = interp.sum(axis=0)
    interp /= np.where(np.abs(colsum) > 1e-3, colsum, 1.0)
    loglags = np.log(fine)
    trans = penalty * (loglags[:, None] - loglags[None, :]) ** 2
    for arr in (fine, interp, trans):
        arr.setflags(write=False)  # lru_cache shares the instances
    return lo_int, len(ints), fine, interp, trans


def _soft_discount(fine, rate: float, soft_min_f0: float) -> np.ndarray:
    """Host per-fine-lag factor ``1 - min(soft_min_f0 * lag_s, 1)``:
    Kaldi's soft-min-f0 subharmonic tiebreak on the local NCCF cost."""
    return 1.0 - np.minimum(soft_min_f0 * np.asarray(fine) / rate, 1.0)


def _kaiser_at(x, half_width: int, beta: float = 6.0):
    """Kaiser window evaluated at (possibly non-integer) offsets ``x``."""
    arg = np.clip(1.0 - (x / half_width) ** 2, 0.0, None)
    return np.i0(beta * np.sqrt(arg)) / np.i0(beta)


@lru_cache(maxsize=16)
def _lowpass_fir(rate: float, cutoff: float, half_width: int = 32):
    """Host windowed-sinc lowpass design (unit DC gain, float64)."""
    n = np.arange(-half_width, half_width + 1, dtype=np.float64)
    c = 2.0 * cutoff / rate
    h = c * np.sinc(c * n) * np.kaiser(2 * half_width + 1, 5.0)
    h /= h.sum()
    return h


def _const(x, like):
    """A host table as a tensor of ``like``'s dtype and device, copied
    there once (:func:`._device.host_constant`)."""
    return host_constant(np.asarray(x), like.dtype, like.device)


def _lowpass(signal, rate: float, cutoff: float):
    """Zero-phase 'same'-length FIR lowpass of ``(..., S)`` signals, as a
    banded-Toeplitz block product (:func:`.resample.fir_conv_matmul`)."""
    h = _lowpass_fir(rate, cutoff)
    K = (len(h) - 1) // 2
    return fir_conv_matmul(signal, h, stride=1, pad_left=K, n_out=signal.shape[-1])


def _nccf_from_frames(frames, window: int, tables, ballast):
    """Fine-grid NCCFs of ``(..., T, span)`` frames given a ballast value.

    ``ballast`` is the energy offset ``nccf_ballast * window *
    mean_square``, a number or a tensor over the leading axes of
    ``frames``: the caller owns the mean-square estimate (whole-signal
    offline, running online).  Returns ``(nccf_pitch, nccf_pov)``, each
    ``(..., T, n_fine)``.
    """
    lo_int, n_int, _, interp, _ = tables
    frames = frames - frames.mean(dim=-1, keepdim=True)
    x1 = frames[..., :window]
    # every integer lag's window of every frame, from one strided view
    wins = frames[..., lo_int : lo_int + n_int - 1 + window].unfold(-1, window, 1)
    wins = wins.contiguous()  # (..., T, n_int, window)
    with ieee_float32():
        inner = torch.matmul(wins, x1.unsqueeze(-1)).squeeze(-1)
        e2 = (wins * wins).sum(dim=-1)
        del wins
        e1 = (x1 * x1).sum(dim=-1)
        ballast = torch.as_tensor(ballast, dtype=frames.dtype, device=frames.device)
        ballast = ballast.reshape(ballast.shape + (1, 1))
        tiny = 1e-30
        denom_p = torch.sqrt((e1[..., None] + ballast) * (e2 + ballast)) + tiny
        denom_v = torch.sqrt(e1[..., None] * e2) + tiny
        # both NCCFs onto the fine (geometric) lag grid: one [n_int,
        # n_fine] product each
        imat = _const(interp, frames)
        nccf_pitch = torch.matmul(inner / denom_p, imat)
        nccf_pov = torch.matmul(inner / denom_v, imat)
    return nccf_pitch, torch.clamp(nccf_pov, -1.0, 1.0)


def _nccf_span(window: int, tables) -> int:
    """Samples each frame's NCCF touches."""
    lo_int, n_int = tables[0], tables[1]
    return window + lo_int + n_int - 1


def _nccf_1d(
    sig,
    length,
    window: int,
    shift: int,
    tables,
    nccf_ballast: float,
    ballast_ms=None,
):
    """Fine-grid NCCFs of ``(..., S)`` signals with valid ``length``s (over
    the leading axes): ``(nccf_pitch, nccf_pov, fvalid)``, shapes ``(...,
    T, L)``, ``(..., T, L)``, ``(..., T)``.  The reference's per-utterance
    function, batched."""
    span = _nccf_span(window, tables)
    S = sig.shape[-1]
    T = (S - span) // shift + 1
    if T < 1:
        raise ValueError(
            f"signal too short for pitch: {S} samples < {span} (window + "
            f"max lag at this rate)"
        )
    frames = frame_padded(sig, T, span, shift)
    # ballast ~ the energy a window of the signal's mean power carries, so
    # silence (e << ballast) reads as nccf ~ 0 at any input gain
    # (Ghahremani et al. 2014, sec. 2)
    if ballast_ms is None:
        ids = torch.arange(S, device=sig.device) < length[..., None]
        ms = torch.sum(sig * sig * ids, dim=-1) / torch.clamp_min(length, 1)
    else:
        ms = torch.as_tensor(ballast_ms, dtype=sig.dtype, device=sig.device)
    ballast = nccf_ballast * window * ms
    nccf_pitch, nccf_pov = _nccf_from_frames(frames, window, tables, ballast)
    # frames past the valid length read zero NCCF (unvoiced)
    nf = torch.where(
        length >= span,
        torch.div(length - span, shift, rounding_mode="floor") + 1,
        torch.zeros_like(length),
    )
    fvalid = torch.arange(T, device=sig.device) < nf[..., None]
    nccf_pitch = torch.where(fvalid[..., None], nccf_pitch, 0.0)
    nccf_pov = torch.where(fvalid[..., None], nccf_pov, 0.0)
    return nccf_pitch, nccf_pov, fvalid


def viterbi_on_kernel(device, dtype, lags: int) -> bool:
    """Whether :func:`_viterbi` runs its scores on the hand-written kernel
    (:func:`.stft_kernels.viterbi_path`): on a CUDA device, in float32 and
    at most :data:`.stft_kernels.VITERBI_MAX_LAGS` lags.  Elsewhere (the
    CPU, float64, more lags) it runs its two loops.  The extractor asks
    the same question to count the kernel's steps."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and 1 <= int(lags) <= stft_kernels.VITERBI_MAX_LAGS)


def _viterbi(nc, tmat, counts=None, steps=None):
    """The lag path minimising ``sum_t -nc[t, lag_t] + tmat[lag_t-1,
    lag_t]`` for ``(T, ..., L)`` local scores: ``(T, ...)`` int64 indices.

    The forward loop keeps only the costs; the backward loop re-derives
    each step's argmin for the chosen column (``tmat`` is symmetric), on
    the same floats and with the same first-index tie rule, so the path is
    the forward-pointer path.  Each step's costs are shifted by their row's
    minimum, which moves no argmin: unshifted, they grow by about one a
    frame, and in float32 their rounding at 10 s (an ulp near 1,000 is
    6e-5) passes the 1e-5 cost of a step between neighbouring lags, so the
    float32 path strays from the float64 one on clean tones (as the
    reference's does); shifted, it keeps to it.

    ``counts`` (``(...)`` frame counts, on the device) ends each row's path
    at its count: past it the row's costs stay as they were, and its path
    stays at its last frame's lag.  Through a batch's padding frames (zero
    scores) the costs would spread until lags near the best one tie to
    float32's rounding, and the path's last frames could come back one lag
    off the row's own.

    ``steps`` (a host number, at least the largest of ``counts``) ends both
    loops there, and frames ``steps`` to ``T - 1`` repeat each row's lag at
    ``steps - 1``: the path of the whole loop, bit for bit.  Past its count
    a row's costs are frozen with a minimum of exactly 0 at their first
    argmin ``j``, and every off-diagonal transition cost is above 0 (at a
    penalty of 0 the first-index rule keeps ``j``), so the backtrack over
    them never leaves ``j``.

    Where :func:`viterbi_on_kernel` takes the scores, one kernel launch
    gives the same path, bit for bit; the loops are its plain version."""
    T = nc.shape[0]
    steps = T if steps is None else max(1, min(int(steps), T))
    if viterbi_on_kernel(nc.device, nc.dtype, nc.shape[-1]):
        flat = nc.reshape((T, -1, nc.shape[-1]))
        path = stft_kernels.viterbi_path(
            flat, tmat, None if counts is None else counts.reshape(-1), steps)
        return path.reshape(nc.shape[:-1])
    cost = -nc[0]
    cost = cost - torch.amin(cost, dim=-1, keepdim=True)
    costs = []
    if counts is not None:
        ahead = torch.arange(steps, device=nc.device).reshape((-1,) + (1,) * counts.dim())
        active = (ahead < counts)[..., None]
    for t in range(1, steps):
        costs.append(cost)
        step = torch.amin(cost[..., :, None] + tmat, dim=-2) - nc[t]
        step = step - torch.amin(step, dim=-1, keepdim=True)
        cost = step if counts is None else torch.where(active[t], step, cost)
    j = torch.argmin(cost, dim=-1)
    path = [j]
    for cost_t in reversed(costs):
        j = torch.argmin(cost_t + tmat[j], dim=-1)
        path.append(j)
    path = torch.stack(path[::-1])
    if steps == T:
        return path
    return torch.cat([path, path[-1:].expand((T - steps,) + path.shape[1:])])


def _choose_lags(
    nccf_pitch,
    nccf_pov,
    rate: float,
    tables,
    resolution: float,
    soft_min_f0: float,
    counts=None,
    steps=None,
):
    """Viterbi lag choice + parabolic refinement, batched over leading
    axes of ``(..., T, L)`` NCCFs: returns ``(f0, nccf_best)``, ``(..., T)``
    each.  One loop serves the whole batch (each step a ``[..., L, L]``
    min); ``counts`` ends each row's path at its valid frames and ``steps``
    the loops at the longest (:func:`_viterbi`)."""
    _, _, fine, _, trans = tables
    # local cost -nccf_eff: long lags discounted by soft_min_f0 * lag
    # seconds (Kaldi's soft-min-f0), which breaks the exact ties a periodic
    # signal puts at every multiple of its true lag
    tmat = _const(trans, nccf_pitch)
    nccf_eff = nccf_pitch * _const(_soft_discount(fine, rate, soft_min_f0), nccf_pitch)
    path = _viterbi(torch.movedim(nccf_eff, -2, 0), tmat, counts, steps)
    return _refine_lags(torch.movedim(path, 0, -1), nccf_pov, rate, fine, resolution)


def _refine_lags(path, nccf_pov, rate: float, fine, resolution: float):
    """Sub-grid lag refinement shared by the offline and streaming
    trackers: a parabola through the ballast-free NCCF at the winning fine
    lag and its neighbours (uniform in log-lag).  The parabola's centre
    clips into the interior, but the returned nccf is always at the chosen
    lag.  ``path``: ``(..., T)`` fine-grid indices; ``nccf_pov``: ``(...,
    T, L)``; returns ``(f0, nccf_best)``."""
    L = len(fine)
    path = path.to(torch.int64)

    def at(idx):
        return torch.take_along_dim(nccf_pov, idx[..., None], dim=-1)[..., 0]

    nccf_best = at(path)
    jc = torch.clamp(path, 1, L - 2)
    y1, y2, y3 = at(jc - 1), at(jc), at(jc + 1)
    curv = y1 + y3 - 2.0 * y2
    delta = torch.where(
        torch.abs(curv) > 1e-12,
        0.5 * (y1 - y3) / torch.where(curv == 0, torch.ones_like(curv), curv),
        torch.zeros_like(curv),
    )
    delta = torch.clamp(delta, -0.5, 0.5)
    delta = torch.where((path > 0) & (path < L - 1), delta, torch.zeros_like(delta))
    log_grid = _const(np.log(np.asarray(fine)), nccf_pov)
    # a Python number enters a tensor op at the tensor's dtype, as the
    # reference's dtype.type(...) constants do
    log_lag = log_grid[path] + delta * float(np.log1p(resolution))
    f0 = float(rate) * torch.exp(-log_lag)
    return f0, nccf_best


def _work_geometry(
    rate: float,
    min_f0: float,
    max_f0: float,
    frame_length_ms: float,
    frame_shift_ms: float,
    resample_rate: Optional[float],
    penalty_factor: float,
    lag_resolution: float,
):
    """Host precompute shared by the offline and streaming trackers:
    ``(work_rate, up, down, window, shift, tables)`` with ``up/down`` the
    reduced resampling ratio (1/1 when no resampling happens)."""
    work_rate = float(rate)
    up = down = 1
    if resample_rate and float(resample_rate) != float(rate):
        r_in, r_out = int(round(rate)), int(round(resample_rate))
        g = gcd(r_in, r_out)
        up, down = r_out // g, r_in // g
        work_rate = float(resample_rate)
    window = int(round(frame_length_ms * work_rate / 1000.0))
    shift = int(round(frame_shift_ms * work_rate / 1000.0))
    if window < 2 or shift < 1:
        raise ValueError(
            f"degenerate frame geometry: window {window}, shift {shift}"
        )
    tables = _lag_tables(
        work_rate,
        float(min_f0),
        float(max_f0),
        float(penalty_factor),
        float(lag_resolution),
    )
    return work_rate, up, down, window, shift, tables


# the keyword arguments of kaldi_pitch that set its frame grid
_GRID_KEYS = (
    "min_f0",
    "max_f0",
    "frame_length_ms",
    "frame_shift_ms",
    "resample_rate",
    "penalty_factor",
    "lag_resolution",
)


def _grid_geometry(rate: float, kwargs):
    """:func:`_work_geometry` of :func:`pitch_feats`' keyword arguments
    ``kwargs``: an unknown name raises, and those that do not set the grid
    are not used."""
    params = inspect.signature(kaldi_pitch).parameters
    unknown = set(kwargs) - set(params) - {"normalization_window", "delta_window"}
    if unknown:
        raise TypeError(f"unknown pitch arguments: {sorted(unknown)}")
    grid = {k: kwargs.get(k, params[k].default) for k in _GRID_KEYS}
    return _work_geometry(rate, **grid)


def pitch_frame_counts(padded_len: int, lengths, rate: float, **kwargs):
    """The frame grid of :func:`kaldi_pitch` on the host, from shapes and
    lengths alone: ``(frames, valid)``, the frames a ``(..., padded_len)``
    batch is tracked over (0 where the rows are too short for one, where
    :func:`kaldi_pitch` raises) and each row's valid count (numpy, like
    ``lengths``).  Keyword arguments are :func:`pitch_feats`': an unknown
    name raises, and those that do not set the grid are not used."""
    _, up, down, window, shift, tables = _grid_geometry(rate, kwargs)
    span = _nccf_span(window, tables)
    return (int(_frame_counts(padded_len, up, down, span, shift)),
            _frame_counts(lengths, up, down, span, shift))


def pitch_lag_count(rate: float, **kwargs) -> int:
    """The lags of :func:`kaldi_pitch`'s Viterbi (its fine lag grid) for
    :func:`pitch_feats`' keyword arguments, as :func:`pitch_frame_counts`
    reads them."""
    return len(_grid_geometry(rate, kwargs)[-1][2])


def _frame_counts(lengths, up: int, down: int, span: int, shift: int):
    """The tracked frames of signals of ``lengths`` samples (numpy), as
    :func:`_nccf_1d` counts them after resampling by ``up / down``."""
    n = -(-np.asarray(lengths, np.int64) * up // down)
    return np.where(n >= span, (n - span) // shift + 1, 0)


def kaldi_pitch(
    signal,
    rate: float,
    lengths=None,
    min_f0: float = 50.0,
    max_f0: float = 400.0,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    resample_rate: Optional[float] = 4000.0,
    lowpass_cutoff: Optional[float] = 1000.0,
    penalty_factor: float = 0.1,
    nccf_ballast: float = 1.0,
    soft_min_f0: float = 10.0,
    lag_resolution: float = 0.01,
    ballast_ms=None,
    device=None,
) -> PitchTrack:
    """Track pitch of ``(..., S)`` signals; returns ``(..., T)`` frames.

    Kaldi ``compute-kaldi-pitch`` semantics, as
    :func:`speech_tpu.ops.pitch.kaldi_pitch`: resample to
    ``resample_rate``, lowpass at ``lowpass_cutoff``, NCCF over integer
    lags covering ``[min_f0, max_f0]`` with the ballast ``nccf_ballast *
    window * mean_square(signal)``, sinc-interpolated onto a geometric lag
    grid of relative step ``lag_resolution``; the whole-utterance Viterbi
    optimum under ``penalty_factor * log(lag_i / lag_j)^2`` and the
    subharmonic tiebreak ``nccf * (1 - soft_min_f0 * lag_seconds)``,
    refined by a parabola in log-lag.

    ``lengths`` (integers over the leading axes) marks each padded
    signal's valid extent; frames past it come back with ``valid=False``
    and a zero ``nccf``, and each row equals the solo call on its valid
    extent.  Lengths in host memory (numpy, a list, a CPU tensor) also end
    the Viterbi's loops at the longest row's frames (the same track, in
    fewer steps) and go to the card by one pinned copy that does not wait
    for it; lengths already on the card leave the loops over every frame.
    ``ballast_ms`` fixes the ballast's mean square instead of
    measuring it.  A tensor stays on its device; other input goes to
    ``device`` (the GPU by default).
    """
    signal = as_tensor(signal, device)
    if not signal.is_floating_point():
        signal = signal.to(torch.float32)
    S = signal.shape[-1]
    batch_shape = signal.shape[:-1]
    ragged = lengths is not None
    host_len = None
    if not ragged:
        lengths = torch.full(batch_shape, S, dtype=torch.int64, device=signal.device)
    else:
        if isinstance(lengths, torch.Tensor) and lengths.device.type != "cpu":
            lengths = lengths.to(signal.device, torch.int64)
        else:
            host_len = np.ascontiguousarray(np.asarray(lengths, np.int64))
            lengths = torch.from_numpy(host_len)
            if signal.device.type == "cuda":
                # pageable memory would make the copy wait for the card
                lengths = lengths.pin_memory().to(signal.device, non_blocking=True)
            else:
                lengths = lengths.to(signal.device)
        if lengths.shape != batch_shape:
            raise ValueError(
                f"lengths shape {tuple(lengths.shape)} does not match signal "
                f"batch shape {tuple(batch_shape)}"
            )
        # zero the padding before the resample / lowpass convolutions:
        # their taps cross the valid-length boundary
        signal = signal * (torch.arange(S, device=signal.device) < lengths[..., None])
    work_rate, up, down, window, shift, tables = _work_geometry(
        rate,
        min_f0,
        max_f0,
        frame_length_ms,
        frame_shift_ms,
        resample_rate,
        penalty_factor,
        lag_resolution,
    )
    steps = None
    if host_len is not None:
        # the longest row's tracked frames, from the host's lengths: no
        # row's path moves past them (_viterbi)
        span = _nccf_span(window, tables)
        steps = int(_frame_counts(host_len, up, down, span, shift).max(initial=0))
    if (up, down) != (1, 1):
        signal = resample(signal, up, down)
        lengths = -torch.div(-lengths * up, down, rounding_mode="floor")
        # the resampler's taps leave nonzero output past the resampled
        # length where a standalone signal ends with zeros: re-zero so
        # that a batch equals its rows run alone
        signal = signal * (torch.arange(signal.shape[-1], device=signal.device)
                           < lengths[..., None])
    if lowpass_cutoff and lowpass_cutoff < work_rate / 2:
        signal = _lowpass(signal, work_rate, float(lowpass_cutoff))

    flat_sig = signal.reshape((-1, signal.shape[-1]))
    flat_len = lengths.reshape((-1,))
    # at most _GROUP utterances' lag windows live at once
    parts = [
        _nccf_1d(
            flat_sig[i : i + _GROUP], flat_len[i : i + _GROUP], window, shift, tables,
            float(nccf_ballast), ballast_ms=ballast_ms,
        )
        for i in range(0, flat_sig.shape[0], _GROUP)
    ]
    nccf_pitch, nccf_pov, valid = (torch.cat(p) for p in zip(*parts))
    f0, nccf = _choose_lags(
        nccf_pitch, nccf_pov, work_rate, tables, float(lag_resolution), float(soft_min_f0),
        counts=valid.sum(dim=-1) if ragged else None, steps=steps,
    )
    T = f0.shape[-1]
    return PitchTrack(
        f0.reshape(batch_shape + (T,)),
        nccf.reshape(batch_shape + (T,)),
        valid.reshape(batch_shape + (T,)),
    )


def nccf_to_pov(nccf):
    """Probability of voicing from a ballast-free NCCF value: with ``a =
    |nccf|``, ``sigmoid(-5.2 + 5.4 e^{7.5(a-1)} + 4.8 a - 2 e^{-10 a} + 4.2
    e^{20(a-1)})`` (Ghahremani et al. 2014, eq. 2)."""
    a = torch.abs(torch.as_tensor(nccf))
    logit = (
        -5.2
        + 5.4 * torch.exp(7.5 * (a - 1.0))
        + 4.8 * a
        - 2.0 * torch.exp(-10.0 * a)
        + 4.2 * torch.exp(20.0 * (a - 1.0))
    )
    return torch.sigmoid(logit)


def pitch_feats(
    signal,
    rate: float,
    lengths=None,
    normalization_window: int = 151,
    delta_window: int = 2,
    return_valid: bool = False,
    **kwargs,
):
    """Kaldi ``process-kaldi-pitch-feats``-style features, ``(..., T, 3)``:
    the POV feature ``2((1.001 - nccf)^0.15 - 1)``, the normalized log
    pitch (log f0 minus its POV-weighted mean over a centered, edge-clipped
    ``normalization_window``) and delta log pitch (the order-1 Kaldi delta
    filter of half-width ``delta_window``).  Rows past a signal's valid
    length are zero.  With ``return_valid``, also the valid frame counts.
    Extra keyword arguments (``device`` too) go to :func:`kaldi_pitch`.
    """
    track = kaldi_pitch(signal, rate, lengths=lengths, **kwargs)
    return pitch_feats_from_track(
        track,
        normalization_window=normalization_window,
        delta_window=delta_window,
        return_valid=return_valid,
    )


def pitch_feats_from_track(
    track: PitchTrack,
    normalization_window: int = 151,
    delta_window: int = 2,
    return_valid: bool = False,
):
    """The :func:`pitch_feats` post-processing of an existing ``(..., T)``
    :class:`PitchTrack`: the same three columns and padding semantics."""
    if normalization_window < 1:
        raise ValueError(
            f"normalization_window must be >= 1, got {normalization_window}"
        )
    if delta_window < 1:
        raise ValueError(f"delta_window must be >= 1, got {delta_window}")
    f0, nccf, valid = (torch.as_tensor(a) for a in track)
    pov_feat = 2.0 * (torch.exp(0.15 * torch.log(1.001 - nccf)) - 1.0)
    logf0 = torch.log(f0)
    # the last valid frame's log-f0 over the padding, so that the delta
    # filter's edge sees what a standalone signal's edge replication gives
    nf = valid.sum(dim=-1)
    last = torch.clamp_min(nf - 1, 0)
    logf0 = torch.where(valid, logf0, torch.take_along_dim(logf0, last[..., None], dim=-1))
    # padded frames get exactly zero weight; the baseline keeps
    # all-unvoiced valid stretches at their own mean
    w = torch.where(valid, nccf_to_pov(nccf).to(f0.dtype) + 1e-6, 0.0)
    T = f0.shape[-1]
    # a plain centered window, clipped at both ends (made on the device:
    # a table copied from the host would wait for the card)
    idx = torch.arange(T, device=f0.device) - normalization_window // 2
    lo = torch.clamp_min(idx, 0)
    hi = torch.clamp_max(idx + normalization_window, T)

    def windowed_sum(x):
        c = torch.cumsum(x, dim=-1)
        c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
        return c[..., hi] - c[..., lo]

    # the floor engages only on fully padded windows, whose rows are
    # zeroed below (every valid frame's window holds itself)
    mean = windowed_sum(w * logf0) / torch.clamp_min(windowed_sum(w), 1e-6)
    norm_log_pitch = logf0 - mean
    filt = delta_filters(1, delta_window)[0]
    dlog = deltas(logf0[..., None], [filt], time_axis=-2)[..., 1]
    out = torch.stack([pov_feat, norm_log_pitch, dlog], dim=-1)
    out = torch.where(valid[..., None], out, 0.0)
    if return_valid:
        return out, valid.sum(dim=-1)
    return out
