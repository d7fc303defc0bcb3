"""Visualization helpers (requires matplotlib).

The counterpart of :mod:`speech_tpu.vis`, with the reference's API surface
(reference: src/pydrobert/speech/vis.py): filter-bank frequency-response
plots and side-by-side spectrogram-style comparisons of frame computers,
on this package's banks and computers.  Features are computed where the
computer runs (the GPU unless it was built with ``device="cpu"``) and
plotted on the host.  matplotlib is imported on use.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .compute import FrameComputer, LinearFilterBankFrameComputer
from .filters import LinearFilterBank
from .post import PostProcessor
from .utils import angular_to_hertz

__all__ = ["plot_frequency_response", "compare_feature_frames"]


def _hz_feature_bounds(computer) -> np.ndarray:
    """Per-coefficient frequency boundaries for a filter-bank computer.

    Adjacent filters may overlap or leave gaps, so the boundary between
    filters ``j-1`` and ``j`` is a point between their center frequencies,
    weighted by the lower filter's support endpoints; the outermost
    filters extend to their own supports, clipped to ``[0, Nyquist]``
    (reference: vis.py:477-501, including its choice of the lower filter's
    ``(left, right)`` as the weights).
    """
    sup = computer.bank.supports_hz
    centers = [(left + right) / 2 for left, right in sup]
    bounds = np.empty(len(sup) + 1)
    bounds[0] = max(0.0, sup[0][0])
    bounds[-1] = min(computer.sampling_rate / 2, sup[-1][1])
    for j in range(1, len(sup)):
        w_low, w_high = sup[j - 1]
        bounds[j] = (centers[j - 1] * w_high + centers[j] * w_low) / (
            w_low + w_high
        )
    return bounds


def _time_bounds(computer, num_samples: int) -> np.ndarray:
    """Per-frame time boundaries in seconds, full frames only.

    Frame edges sit a shift apart; centered computers offset interior
    edges back by half a shift and close the final frame at its padding,
    causal ones close it at the frame length (reference: vis.py:443-474).
    """
    length, shift = computer.frame_length, computer.frame_shift
    pad_left = 0 if computer.frame_style == "causal" else (length + 1) // 2 - 1
    num_frames = max(0, (num_samples + pad_left - length) // shift + 1)
    if not num_frames:
        raise ValueError(
            f"signal too short for a full frame of computer {computer}"
        )
    bounds = np.arange(num_frames + 1, dtype=float) * shift
    if pad_left:
        bounds[1:-1] -= (shift + 1) // 2 - 1
        bounds[-1] = bounds[-2] + pad_left
    else:
        bounds[-1] = bounds[-2] + length
    return bounds / computer.sampling_rate


def _require_plt():
    import matplotlib.pyplot as plt

    return plt


def plot_frequency_response(
    banks: Union[Sequence[LinearFilterBank], LinearFilterBank],
    axes=None,
    dft_size: Optional[int] = None,
    half: Optional[bool] = None,
    title: Optional[str] = None,
    x_scale: str = "hz",
    y_scale: str = "dB",
    cmap=None,
):
    """Plot frequency responses of filters in one or more banks.

    ``x_scale``: 'hz' (cycles/sec), 'ang' (radians/sec), or 'bins' (DFT
    index); ``y_scale``: 'dB' (relative to the bank max, floored at -20 dB),
    'power' (|H|^2), 'real', 'imag', or 'both'
    (reference: vis.py:49-229).  Returns the containing figure.
    """
    plt = _require_plt()
    if isinstance(banks, LinearFilterBank):
        banks = [banks]
    banks = list(banks)
    if not banks or not all(b.num_filts for b in banks):
        raise ValueError(
            "Filter banks must have at least one filter to be visualized"
        )
    rate = banks[0].sampling_rate
    if not all(b.sampling_rate == rate for b in banks):
        raise ValueError("Banks must all have the same sampling rate")
    if x_scale not in ("hz", "ang", "bins"):
        raise ValueError(f"Invalid x_scale: {x_scale}")
    if y_scale not in ("dB", "power", "real", "imag", "both"):
        raise ValueError(f"Invalid y_scale: {y_scale}")
    if cmap is None:
        cmap = plt.get_cmap()
    if dft_size is None:
        dft_size = max(
            max(
                max(right - left for left, right in bank.supports),
                int(
                    2
                    * rate
                    / min(right - left for left, right in bank.supports_hz)
                ),
            )
            for bank in banks
        )
    if half is None:
        half = all(b.is_real for b in banks)
    if axes is None:
        fig, axes = plt.subplots()
    else:
        fig = axes.get_figure()
    num_bins = dft_size // 2 + 1 if half else dft_size
    if x_scale == "hz":
        x = angular_to_hertz(
            2 * np.pi * np.arange(num_bins) / dft_size, rate
        )
        axes.set_xlabel("Frequency (Hz)")
    elif x_scale == "ang":
        x = 2 * np.pi * np.arange(num_bins) / dft_size * rate
        axes.set_xlabel("Angular frequency (rad/s)")
    else:
        x = np.arange(num_bins)
        axes.set_xlabel("DFT bin")
    responses = []
    for bank in banks:
        for filt_idx in range(bank.num_filts):
            responses.append(
                bank.get_frequency_response(filt_idx, dft_size, half=half)
            )
    total = len(responses)
    if y_scale == "dB":
        mags = [np.abs(r) for r in responses]
        peak = max(m.max() for m in mags)
        axes.set_ylabel("Response (dB)")
        axes.set_ylim(-20, 0.5)
        for i, m in enumerate(mags):
            y = 20 * np.log10(np.maximum(m / max(peak, 1e-20), 1e-10))
            axes.plot(x, np.maximum(y, -20), color=cmap(i / max(total - 1, 1)))
    elif y_scale == "power":
        axes.set_ylabel("Power")
        for i, r in enumerate(responses):
            axes.plot(x, np.abs(r) ** 2, color=cmap(i / max(total - 1, 1)))
    else:
        parts = ("real", "imag") if y_scale == "both" else (y_scale,)
        axes.set_ylabel("Response")
        for i, r in enumerate(responses):
            color = cmap(i / max(total - 1, 1))
            if "real" in parts:
                axes.plot(x, np.real(r), color=color)
            if "imag" in parts:
                axes.plot(x, np.imag(r), color=color, linestyle="--")
    if title:
        axes.set_title(title)
    return fig


def compare_feature_frames(
    computers: Union[FrameComputer, Sequence[FrameComputer]],
    signal: np.ndarray,
    axes=None,
    figure_height: Optional[float] = None,
    figure_width: Optional[float] = None,
    plot_titles: Optional[Tuple[str, ...]] = None,
    positions: Optional[Tuple] = None,
    post_ops=None,
    title: Optional[str] = None,
    **kwargs,
):
    """Compare frame computers' features as aligned spectrogram heat maps.

    All computers share the frame-boundary interpretation, so their feature
    matrices plot against a common time axis (reference: vis.py:253-533).
    ``post_ops`` may be post-processors or ``(op, axis)`` pairs; ops must
    preserve the feature shape.  Returns the containing figure.
    """
    plt = _require_plt()
    if isinstance(computers, FrameComputer):
        computers = (computers,)
    computers = tuple(computers)
    if not computers:
        raise ValueError("Expected at least one computer")
    n = len(computers)
    if plot_titles is not None and len(plot_titles) != n:
        raise ValueError("Expected one plot title per computer")
    if post_ops is None:
        post_ops = ()
    elif isinstance(post_ops, PostProcessor):
        post_ops = (post_ops,)
    post_ops = [
        op if isinstance(op, tuple) else (op, -1) for op in post_ops
    ]
    # compute features
    feats = []
    for computer in computers:
        # compute_full reads its features back from the computer's device
        f = computer.compute_full(np.asarray(signal, dtype=np.float64))
        for op, axis in post_ops:
            g = op.apply(f, axis=axis)
            if g.shape != f.shape:
                raise ValueError(
                    "Post-processors must not change the feature shape"
                )
            f = g
        feats.append(f)
    if axes is not None:
        try:
            axes = list(axes)
        except TypeError:
            axes = [axes]
        if len(axes) != n:
            raise ValueError("Expected one axes per computer")
        if figure_height is not None or figure_width is not None:
            raise ValueError("Cannot set figure size when axes are given")
        if positions is not None:
            raise ValueError("Cannot set positions when axes are given")
        fig = axes[0].get_figure()
        if not all(a.get_figure() is fig for a in axes):
            raise ValueError("All axes must belong to the same figure")
    else:
        if positions is None:
            rows, cols = n, 1
            index = [(i, 0) for i in range(n)]
        else:
            positions = [
                p if isinstance(p, tuple) else (p, 0) for p in positions
            ]
            if sorted(set(positions)) != sorted(positions) or min(
                positions
            ) != (0, 0):
                raise ValueError("positions must be unique and start at 0")
            rows = max(p[0] for p in positions) + 1
            cols = max(p[1] for p in positions) + 1
            index = positions
        if figure_width is None:
            figure_width = 3.33 if cols == 1 else 7.0
        if figure_height is None:
            figure_height = max(2.0, 1.8 * rows)
        fig, grid = plt.subplots(
            rows,
            cols,
            figsize=(figure_width, figure_height),
            squeeze=False,
            sharex=True,
        )
        axes = [grid[r][c] for r, c in index]
    shared_right = np.inf
    for i, (computer, f, ax) in enumerate(zip(computers, feats, axes)):
        t_bounds = _time_bounds(computer, len(signal))
        shared_right = min(shared_right, t_bounds[-1])
        f = f[: len(t_bounds) - 1]
        if isinstance(computer, LinearFilterBankFrameComputer):
            # y axis in Hz, boundaries from the filter supports; the
            # energy coefficient (if any) has no frequency and is dropped
            if computer.includes_energy:
                f = f[:, 1:]
            y_bounds = _hz_feature_bounds(computer)
            y_label = "Frequency (Hz)"
        else:
            y_bounds = np.arange(f.shape[1] + 1, dtype=float)
            y_label = "Coefficient"
        ax.pcolormesh(t_bounds, y_bounds, f.T, **kwargs)
        ax.set_ylabel(y_label)
        if plot_titles is not None:
            ax.set_title(plot_titles[i])
    for ax in axes:
        ax.set_xlim((0.0, shared_right))
    axes[-1].set_xlabel("Time (s)")
    if title:
        fig.suptitle(title)
    return fig
