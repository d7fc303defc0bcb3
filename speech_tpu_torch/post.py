"""Post-processors: transforms applied to computed feature tensors.

The PyTorch port's copy of :mod:`speech_tpu.post`: the reference-compatible
host API (``apply(features, axis=-1, in_place=False)``; reference:
src/pydrobert/speech/post.py) in numpy, with tensor twins in
:mod:`speech_tpu_torch.ops.postops` for on-device pipelines.  Statistics and
transforms load from files through :func:`speech_tpu_torch.io.read_signal`.
"""

import abc
import warnings

from itertools import count
from typing import Callable, Optional, Union

import numpy as np
import torch

from .alias import AliasedFactory

__all__ = [
    "CMVN",
    "DCT",
    "Deltas",
    "PCEN",
    "PLP",
    "SlidingCMVN",
    "Splice",
    "PostProcessor",
    "Stack",
    "Standardize",
    "Transform",
    "VADTrim",
]

class PostProcessor(AliasedFactory):
    """A transform applied to a feature tensor."""

    @abc.abstractmethod
    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        """Apply the transformation along ``axis`` of ``features``."""
        ...


class Standardize(PostProcessor):
    """Standardize feature coefficients to mean 0 (and variance 1).

    With no statistics file, coefficients standardize locally (within the
    tensor, over all axes but the target).  With accumulated or loaded
    sufficient statistics ``stats[(2, F+1)] = [sum x | count ; sum x^2 | _]``
    standardization is global, Kaldi-style (reference: post.py:66-364).
    Output is always float64.

    Parameters
    ----------
    rfilename
        Optional file of sufficient statistics, loaded via
        :func:`speech_tpu_torch.io.read_signal`.
    norm_var
        Whether to normalize variance as well as mean.
    """

    aliases = {"standardize", "normalize", "unit", "cmvn"}

    def __init__(
        self, rfilename: Optional[str] = None, norm_var: bool = True, **kwargs
    ):
        self._stats = None
        self._norm_var = bool(norm_var)
        if rfilename is not None:
            from .io import read_signal

            if "dtype" in kwargs:
                self._stats = read_signal(rfilename, **kwargs)
            else:
                # float widths first; then the Kaldi matrix dtype strings
                # so stats archived in Kaldi tables load too (reference:
                # post.py:109 tries ('dm', 'fm') after the float widths)
                for dtype in (np.float64, np.float32, "dm", "fm"):
                    try:
                        self._stats = read_signal(rfilename, dtype=dtype, **kwargs)
                        break
                    except (IOError, ValueError, ImportError, TypeError):
                        pass
                if self._stats is None:
                    raise IOError(
                        f"statistics at {rfilename} were unreadable at "
                        "either float width or as a Kaldi matrix"
                    )
                self._stats = np.asarray(self._stats)
                if len(self._stats.shape) == 1:
                    self._sanitize_stats()
        elif kwargs:
            raise TypeError(f"unexpected keyword arguments: {tuple(kwargs)}")
        super().__init__()

    @staticmethod
    def _plausible_stats(arr: np.ndarray):
        """``arr`` reshaped to the ``[sums|count ; sumsqs|-]`` layout if its
        values are consistent with it (nonnegative, integral count), else
        None."""
        if arr.size % 2:
            return None
        arr = arr.reshape(2, -1)
        count = arr[0, -1]
        if np.all(arr >= 0) and np.isclose(np.round(count), count):
            return arr
        return None

    def _sanitize_stats(self):
        # a flat stats array (raw binary load) may have been serialized at
        # the other float width; accept whichever reinterpretation yields a
        # plausible sufficient-statistics layout
        raw = self._stats
        ok = self._plausible_stats(raw)
        if ok is None:
            if raw.dtype == np.float32:
                reread = np.frombuffer(raw.tobytes(), dtype=np.float64)
            elif raw.dtype == np.float64:
                reread = np.frombuffer(raw.tobytes(), dtype=np.float32)
            else:
                raise ValueError(
                    f"loaded statistics have unusable dtype {raw.dtype}"
                )
            ok = self._plausible_stats(reread.astype(np.float64))
        if ok is None:
            raise IOError(
                "loaded data does not look like sufficient statistics at "
                "any float width; pass an explicit dtype to the constructor"
            )
        self._stats = ok

    @classmethod
    def from_stats(
        cls, stats: np.ndarray, norm_var: bool = True
    ) -> "Standardize":
        """Build a global standardizer from ``(2, F+1)`` statistics.

        The layout matches Kaldi CMVN archives (``[sums | count ;
        sumsqs | _]``), so matrices read from a ``compute-cmvn-stats``
        table plug in directly.
        """
        stats = np.asarray(stats, np.float64)
        if stats.ndim != 2 or stats.shape[0] != 2 or stats.shape[1] < 2:
            raise ValueError(
                f"expected (2, F+1) sufficient statistics, got {stats.shape}"
            )
        out = cls(norm_var=norm_var)
        out._stats = stats
        return out

    @property
    def have_stats(self) -> bool:
        """Whether at least one feature vector has been accumulated."""
        return self._stats is not None and bool(self._stats[0, -1])

    @property
    def stats(self) -> Optional[np.ndarray]:
        """The ``(2, F+1)`` sufficient statistics, or None."""
        return self._stats

    def _check_coeffs(self, num_coeffs: int):
        if self._stats is not None and self._stats.shape[1] != num_coeffs + 1:
            raise ValueError(
                "Expected feature vector of length {}; got {}".format(
                    self._stats.shape[1] - 1, num_coeffs
                )
            )

    def accumulate(self, features: np.ndarray, axis: int = -1) -> None:
        """Accumulate sufficient statistics from a feature tensor."""
        if (features.shape and not np.prod(features.shape)) or not len(features):
            raise ValueError("Cannot accumulate from empty array")
        if not features.shape or features.ndim == 1:
            features = features.reshape(1, -1)
            axis = -1
        num_coeffs = features.shape[axis]
        self._check_coeffs(num_coeffs)
        if self._stats is None:
            self._stats = np.zeros((2, num_coeffs + 1), dtype=np.float64)
        other_axes = tuple(
            idx for idx in range(features.ndim) if idx != axis % features.ndim
        )
        self._stats[0, -1] += np.prod(
            tuple(features.shape[idx] for idx in other_axes)
        )
        self._stats[0, :-1] += features.sum(axis=other_axes, dtype=np.float64)
        self._stats[1, :-1] += np.square(features, dtype=np.float64).sum(
            axis=other_axes
        )

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        if features.size == 0:
            raise ValueError("cannot standardize an empty array")
        # a bare vector standardizes along itself; lift it to 2-D so one
        # code path below covers every rank
        squeeze_to = features.shape if features.ndim < 2 else None
        work = features.reshape(1, -1) if squeeze_to is not None else features
        ax = (axis if squeeze_to is None else -1) % work.ndim
        reduce_axes = tuple(i for i in range(work.ndim) if i != ax)
        self._check_coeffs(work.shape[ax])
        if not in_place or work.dtype != np.float64:
            work = work.astype(np.float64)

        lone_vector = all(work.shape[i] == 1 for i in reduce_axes)
        if self.have_stats:
            count = self._stats[0, -1]
            mean = self._stats[0, :-1] / count
            var = self._stats[1, :-1] / count - mean * mean
        elif lone_vector:
            # nothing to estimate moments from
            if self._norm_var:
                raise ValueError(
                    "a lone vector has no variance to normalize; accumulate "
                    "or load global statistics first"
                )
            warnings.warn(
                "standardizing a lone vector without statistics zeroes it"
            )
            work[...] = 0
            return work.reshape(squeeze_to) if squeeze_to is not None else work
        else:
            count = np.prod([work.shape[i] for i in reduce_axes])
            mean = work.mean(axis=reduce_axes)
            var = np.square(work).sum(axis=reduce_axes) / count - mean * mean

        if self._norm_var:
            degenerate = np.isclose(var, 0)
            if degenerate.any():
                warnings.warn(
                    "some coefficients have ~zero variance; their scale is "
                    "clamped to 1"
                )
                var = np.where(degenerate, 1.0, var)
            scale = var ** -0.5
        else:
            scale = np.ones(1)
        bcast = [1] * work.ndim
        bcast[ax] = -1
        work *= scale.reshape(bcast)
        work -= (mean * scale).reshape(bcast)
        return work.reshape(squeeze_to) if squeeze_to is not None else work

    def save(
        self,
        wfilename: str,
        key: Optional[str] = None,
        compress: bool = False,
        overwrite: bool = True,
    ) -> None:
        r"""Save accumulated statistics to ``.npy``, ``.npz``, or raw binary.

        ``.npy`` uses :func:`numpy.save`; ``.npz`` stores under ``key`` (or
        the first unused ``arr_\d+``), merging with existing keys unless
        ``overwrite``; anything else uses :func:`numpy.ndarray.tofile`
        (reference: post.py:307-361).
        """
        if not self.have_stats:
            raise ValueError("No stats have been accumulated to save")
        if wfilename.endswith(".npy"):
            np.save(wfilename, self._stats)
        elif wfilename.endswith(".npz"):
            array = dict()
            if overwrite:
                try:
                    with np.load(wfilename) as existing:
                        array = dict(existing)
                except IOError:
                    pass
            if key is None:
                for key in ("arr_{}".format(v) for v in count(0)):
                    if key not in array:
                        break
            array[key] = self._stats
            if compress:
                np.savez_compressed(wfilename, **array)
            else:
                np.savez(wfilename, **array)
        else:
            self._stats.tofile(wfilename)


CMVN = Standardize


class Deltas(PostProcessor):
    r"""Append feature deltas (weighted rolling averages) of increasing order.

    Deltas are computed by correlating with the Kaldi-compatible filter
    ``f(t) = t / sum_t t^2`` over a context window, iterated per order, with
    edge-replication padding by default (reference: post.py:367-491).

    If ``concatenate``, deltas are appended along ``target_axis``
    (multiplying its size by ``num_deltas + 1``); otherwise a new axis of
    size ``num_deltas + 1`` is inserted at ``target_axis``.

    Parameters
    ----------
    num_deltas
        Number of delta orders to compute.
    target_axis
        Axis deltas are concatenated along / inserted at.
    concatenate
        Concatenate (True) or stack along a new axis (False).
    context_window
        Filter half-width; positive.
    pad_mode
        Padding mode for :func:`numpy.pad` at sequence edges.
    """

    aliases = {"deltas"}

    def __init__(
        self,
        num_deltas: int,
        target_axis: int = -1,
        concatenate: bool = True,
        context_window: int = 2,
        pad_mode: Union[str, Callable] = "edge",
        **kwargs,
    ):
        self._target_axis = target_axis
        self._pad_mode = pad_mode
        self._pad_kwargs = kwargs
        self.concatenate = bool(concatenate)
        self.num_deltas = num_deltas
        self._filts = [np.ones(1, dtype=np.float64)]
        delta_filter = np.arange(1 + 2 * context_window, dtype=np.float64)
        delta_filter -= context_window
        delta_filter /= np.sum(delta_filter ** 2)
        for idx in range(num_deltas):
            self._filts.append(np.convolve(self._filts[idx], delta_filter))

    @property
    def filters(self):
        """The per-order correlation filters (order 0 first)."""
        return list(self._filts)

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        axis = axis % max(features.ndim, 1)
        delta_feats = [features]
        for filt in self._filts[1:]:
            max_offset = (len(filt) - 1) // 2
            if features.size:
                pad = [(0, 0)] * features.ndim
                pad[axis] = (max_offset, max_offset)
                padded = np.pad(
                    features.astype(np.float64, copy=False),
                    pad,
                    self._pad_mode,
                    **self._pad_kwargs,
                )
                # correlate along `axis`: windows @ filt
                windows = np.moveaxis(
                    np.lib.stride_tricks.sliding_window_view(
                        padded, len(filt), axis=axis
                    ),
                    -1,
                    -1,
                )
                delta = np.tensordot(windows, filt, axes=([-1], [0]))
                delta = delta.astype(features.dtype, copy=False)
            else:
                delta = np.empty_like(features)
            delta_feats.append(delta)
        if self.concatenate:
            return np.concatenate(delta_feats, self._target_axis)
        return np.stack(delta_feats, self._target_axis)


class Stack(PostProcessor):
    """Stack contiguous feature vectors into longer vectors.

    ``num_vectors`` consecutive frames along ``time_axis`` merge into one
    frame along the feature axis; the tail is either dropped or padded to
    divisibility with ``pad_mode`` (reference: post.py:494-563).

    Parameters
    ----------
    num_vectors
        Number of consecutive frames to merge.
    time_axis
        Axis along which frames are drawn.
    pad_mode
        :func:`numpy.pad` mode for right-padding to divisibility; if None,
        leftover frames are discarded.
    """

    aliases = {"stack"}

    def __init__(
        self,
        num_vectors: int,
        time_axis: int = 0,
        pad_mode: Optional[Union[str, Callable]] = None,
        **kwargs,
    ) -> None:
        if num_vectors < 1:
            raise ValueError(f"Expected num_vectors to be positive, got {num_vectors}")
        self.num_vectors = num_vectors
        self.time_axis = time_axis
        self._pad_mode = pad_mode
        self._pad_kwargs = kwargs

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        axis = axis % features.ndim
        time_axis = self.time_axis % features.ndim
        if axis == time_axis:
            raise RuntimeError(f"feature and time axes are the same ({axis})")
        T = features.shape[time_axis]
        if self._pad_mode is not None:
            rem = T % self.num_vectors
            if rem:
                padding = [(0, 0)] * features.ndim
                padding[time_axis] = (0, self.num_vectors - rem)
                features = np.pad(
                    features, padding, self._pad_mode, **self._pad_kwargs
                )
                T += self.num_vectors - rem
        nT = T // self.num_vectors
        T = nT * self.num_vectors
        feat_slice = [slice(None)] * features.ndim
        buffs = []
        for i in range(self.num_vectors):
            feat_slice[time_axis] = slice(i, T, self.num_vectors)
            buffs.append(features[tuple(feat_slice)])
        return np.concatenate(buffs, axis)


class PCEN(PostProcessor):
    """Per-channel energy normalization (Wang et al. 2017).

    ``PCEN = (E / (eps + M)^alpha + delta)^power - delta^power`` with the
    per-channel IIR smoother ``M_t = (1 - smooth) M_{t-1} + smooth E_t``
    (started at the first frame's energy).  A trainable-frontend-era
    alternative to log compression + CMVN: apply it to *linear*
    (magnitude or power) features, i.e. computers built with
    ``use_log=False``.  No reference counterpart; the device twin is
    :func:`speech_tpu_torch.ops.postops.pcen` (a log-depth prefix-scan
    formulation).

    Parameters
    ----------
    smooth
        Smoother coefficient in (0, 1].
    alpha
        Gain exponent (scalar or per-channel array).
    delta
        Stabilized-root bias.
    power
        Compression exponent.
    eps
        Smoother floor.
    time_axis
        Axis the smoother runs along.
    """

    aliases = {"pcen"}

    def __init__(
        self,
        smooth: float = 0.025,
        alpha=0.98,
        delta=2.0,
        power=0.5,
        eps: float = 1e-6,
        time_axis: int = 0,
    ):
        if not 0.0 < smooth <= 1.0:
            raise ValueError(f"Expected smooth in (0, 1], got {smooth}")
        self.smooth = float(smooth)
        self.alpha = np.asarray(alpha, dtype=np.float64)
        self.delta = np.asarray(delta, dtype=np.float64)
        self.power = np.asarray(power, dtype=np.float64)
        self.eps = float(eps)
        self.time_axis = time_axis

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        features = np.asarray(features, dtype=np.float64)
        axis = axis % features.ndim
        time_axis = self.time_axis % features.ndim
        if axis == time_axis:
            raise RuntimeError(f"feature and time axes are the same ({axis})")
        # broadcast per-channel parameters along the feature axis
        shape = [1] * features.ndim
        shape[axis] = -1
        alpha = self.alpha.reshape(shape) if self.alpha.ndim else self.alpha
        delta = self.delta.reshape(shape) if self.delta.ndim else self.delta
        power = self.power.reshape(shape) if self.power.ndim else self.power
        mov = np.moveaxis(features, time_axis, 0)
        m = mov[0].copy()
        smoothed = np.empty_like(mov)
        for t in range(mov.shape[0]):
            m += self.smooth * (mov[t] - m)
            smoothed[t] = m
        m = np.moveaxis(smoothed, 0, time_axis)
        gain = np.exp(-alpha * np.log(self.eps + m))
        return (features * gain + delta) ** power - delta ** power


class SlidingCMVN(PostProcessor):
    """Sliding-window cepstral mean (and variance) normalization.

    Kaldi ``apply-cmvn-sliding`` semantics — see the device twin
    :func:`speech_tpu_torch.ops.postops.sliding_cmvn`, to which this host
    class delegates, on the CPU in float64 (no reference counterpart).

    Parameters
    ----------
    window
        Sliding window width in frames.
    center
        Center the (edge-clipped) window on each frame; otherwise the
        window trails, with at least ``min_window`` frames near the
        start.
    norm_var
        Also normalize variance.
    min_window
        Minimum window for the non-centered mode.
    time_axis
        Axis the window slides along.
    """

    aliases = {"sliding_cmvn", "cmvn_sliding"}

    def __init__(
        self,
        window: int = 600,
        center: bool = True,
        norm_var: bool = False,
        min_window: int = 100,
        time_axis: int = 0,
    ):
        if window < 1:
            raise ValueError(f"Expected window to be positive, got {window}")
        self.window = int(window)
        self.center = bool(center)
        self.norm_var = bool(norm_var)
        self.min_window = int(min_window)
        self.time_axis = time_axis

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        from .ops.postops import sliding_cmvn

        features = np.asarray(features, dtype=np.float64)
        axis = axis % features.ndim
        time_axis = self.time_axis % features.ndim
        if axis == time_axis:
            raise RuntimeError(f"feature and time axes are the same ({axis})")
        return sliding_cmvn(
            torch.from_numpy(features),
            window=self.window,
            center=self.center,
            norm_var=self.norm_var,
            min_window=self.min_window,
            time_axis=time_axis,
        ).numpy()


class DCT(PostProcessor):
    """Type-II orthonormal DCT along the feature axis (MFCC cepstrum).

    Applied after a log-mel computer this turns filter-bank features
    into MFCCs, Kaldi ``compute-mfcc-feats``-style: keep ``num_ceps``
    coefficients, optionally liftered with coefficient ``lifter``
    (Kaldi ``--cepstral-lifter``, conventionally 22; 0 disables).  No
    reference counterpart; the device twin is
    :func:`speech_tpu_torch.ops.postops.dct` (one constant-matrix matmul).

    Parameters
    ----------
    num_ceps
        Number of cepstral coefficients kept (default: all).
    lifter
        Cepstral liftering coefficient; 0 disables.
    """

    aliases = {"dct", "mfcc"}

    def __init__(self, num_ceps: int = None, lifter: float = 0.0):
        if num_ceps is not None and num_ceps < 1:
            raise ValueError(f"Expected num_ceps >= 1, got {num_ceps}")
        if lifter < 0:
            raise ValueError(f"Expected lifter >= 0, got {lifter}")
        self.num_ceps = None if num_ceps is None else int(num_ceps)
        self.lifter = float(lifter)

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        from .ops.postops import dct_matrix

        features = np.asarray(features)
        axis = axis % max(features.ndim, 1)
        num_feats = features.shape[axis]
        if self.num_ceps is not None and self.num_ceps > num_feats:
            raise RuntimeError(
                f"num_ceps ({self.num_ceps}) exceeds the feature width "
                f"({num_feats})"
            )
        mat = dct_matrix(num_feats, self.num_ceps, self.lifter)
        moved = np.moveaxis(features.astype(np.float64, copy=False), axis, -1)
        out = moved @ mat
        return np.moveaxis(out, -1, axis).astype(features.dtype, copy=False)


class PLP(PostProcessor):
    """Perceptual linear prediction cepstra from band powers.

    Applied to *linear power* filter-bank features (a computer built with
    ``use_log=False, use_power=True``) this gives PLP cepstra, Kaldi
    ``compute-plp-feats``-style (Hermansky 1990): equal-loudness weighting
    at the bank's center frequencies, cube-root loudness compression,
    autocorrelation by inverse cosine transform, Levinson-Durbin, LPC ->
    liftered cepstra with ``c[0] = log`` residual energy.  The tensor twin
    is :func:`speech_tpu_torch.ops.plp.plp`.

    Parameters
    ----------
    bank
        The filter bank the features came from (a
        :class:`speech_tpu_torch.filters.LinearFilterBank`, or its config
        dict or name): it supplies the per-band center frequencies.
        Alternatively pass ``center_hz``.
    center_hz
        Explicit per-band center frequencies (mutually exclusive with
        ``bank``).
    order, num_ceps, compress, lifter, eps
        See :func:`speech_tpu_torch.ops.plp.plp`.
    """

    aliases = {"plp"}

    def __init__(
        self,
        bank=None,
        center_hz=None,
        order: int = 12,
        num_ceps: int = 13,
        compress: float = 1.0 / 3.0,
        lifter: float = 22.0,
        eps: float = 1e-10,
    ):
        from .alias import alias_factory_subclass_from_arg
        from .filters import LinearFilterBank
        from .ops.plp import _validate

        if (bank is None) == (center_hz is None):
            raise ValueError("pass exactly one of bank= or center_hz=")
        if bank is not None:
            bank = alias_factory_subclass_from_arg(LinearFilterBank, bank)
            center_hz = bank.centers_hz
        self.center_hz = tuple(float(f) for f in center_hz)
        _validate(len(self.center_hz), order, num_ceps, compress, lifter)
        self.order = int(order)
        self.num_ceps = int(num_ceps)
        self.compress = float(compress)
        self.lifter = float(lifter)
        self.eps = float(eps)

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        from .ops.plp import plp_np

        features = np.asarray(features)
        axis = axis % max(features.ndim, 1)
        if features.shape[axis] != len(self.center_hz):
            raise RuntimeError(
                f"expected {len(self.center_hz)} bands along axis {axis}, "
                f"got {features.shape[axis]} (PLP applies to the bank's "
                "linear power outputs, before any width-changing op)"
            )
        moved = np.moveaxis(features.astype(np.float64, copy=False), axis, -1)
        out = plp_np(
            moved,
            self.center_hz,
            order=self.order,
            num_ceps=self.num_ceps,
            compress=self.compress,
            lifter=self.lifter,
            eps=self.eps,
        )
        return np.moveaxis(out, -1, axis).astype(features.dtype, copy=False)


class Splice(PostProcessor):
    """Concatenate each frame with its surrounding context frames.

    Kaldi ``splice-feats`` semantics (no reference counterpart): frame
    ``t`` becomes ``[x[t-left], ..., x[t], ..., x[t+right]]`` along the
    feature axis, with edge replication at the boundaries.  The device
    twin is :func:`speech_tpu_torch.ops.postops.splice`.
    """

    aliases = {"splice"}

    def __init__(self, left: int = 4, right: int = 4, time_axis: int = 0):
        if left < 0 or right < 0:
            raise ValueError(
                f"Expected left/right to be non-negative, got {left}/{right}"
            )
        self.left = int(left)
        self.right = int(right)
        self.time_axis = time_axis

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        features = np.asarray(features)
        axis = axis % features.ndim
        time_axis = self.time_axis % features.ndim
        if axis == time_axis:
            raise RuntimeError(f"feature and time axes are the same ({axis})")
        if axis != features.ndim - 1:
            raise RuntimeError("splice concatenates along the last axis")
        T = features.shape[time_axis]
        pad = [(0, 0)] * features.ndim
        pad[time_axis] = (self.left, self.right)
        padded = np.pad(features, pad, mode="edge")
        sl = [slice(None)] * features.ndim
        outs = []
        for k in range(self.left + self.right + 1):
            sl[time_axis] = slice(k, k + T)
            outs.append(padded[tuple(sl)])
        return np.concatenate(outs, axis=-1)


class Transform(PostProcessor):
    """Apply a linear or affine feature transform matrix.

    Kaldi ``transform-feats`` semantics (no reference counterpart): a
    ``(out_dim, in_dim)`` matrix maps each frame ``x`` to ``M x``; a
    ``(out_dim, in_dim + 1)`` matrix is affine with the bias in the
    last column, ``M[:, :-1] x + M[:, -1]`` — the convention Kaldi
    uses for LDA/MLLT/fMLLR transform estimates.  The device twin is
    :func:`speech_tpu_torch.ops.postops.transform` (one constant matmul);
    frame-local, so it streams trivially.

    Parameters
    ----------
    rfilename
        Optional file holding the matrix, loaded via
        :func:`speech_tpu_torch.io.read_signal` (``.npy``/``.npz``/``.pt``/
        Kaldi ``dm``/``fm`` tables all work).
    matrix
        The matrix itself (mutually exclusive with ``rfilename``).
    """

    aliases = {"transform", "affine", "lda"}

    def __init__(self, rfilename: Optional[str] = None, matrix=None, **kwargs):
        if (rfilename is None) == (matrix is None):
            raise ValueError("pass exactly one of rfilename= or matrix=")
        if rfilename is not None:
            from .io import read_signal

            if "dtype" in kwargs:
                matrix = read_signal(rfilename, **kwargs)
            else:
                # float widths first, then the Kaldi matrix dtype strings
                # (the Standardize stats-loading convention)
                for dtype in (np.float64, np.float32, "dm", "fm"):
                    try:
                        matrix = read_signal(rfilename, dtype=dtype, **kwargs)
                        break
                    except (IOError, ValueError, ImportError, TypeError):
                        pass
                if matrix is None:
                    raise IOError(
                        f"transform at {rfilename} was unreadable at either "
                        "float width or as a Kaldi matrix"
                    )
        elif kwargs:
            raise TypeError(f"unexpected keyword arguments: {tuple(kwargs)}")
        matrix = np.asarray(matrix, dtype=np.float64)
        if matrix.ndim != 2 or 0 in matrix.shape:
            raise ValueError(
                f"expected a nonempty 2-D transform, got shape {matrix.shape}"
            )
        self._matrix = matrix
        super().__init__()

    @property
    def matrix(self) -> np.ndarray:
        """The ``(out_dim, in_dim[+1])`` transform matrix."""
        return self._matrix

    @property
    def out_dim(self) -> int:
        return self._matrix.shape[0]

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        features = np.asarray(features)
        axis = axis % max(features.ndim, 1)
        in_dim = features.shape[axis]
        if self._matrix.shape[1] == in_dim:
            mat, bias = self._matrix, None
        elif self._matrix.shape[1] == in_dim + 1:
            mat, bias = self._matrix[:, :-1], self._matrix[:, -1]
        else:
            raise RuntimeError(
                f"transform of shape {self._matrix.shape} does not apply "
                f"to {in_dim}-dimensional features (expected {in_dim} "
                f"columns, or {in_dim + 1} for an affine transform)"
            )
        moved = np.moveaxis(features.astype(np.float64, copy=False), axis, -1)
        out = moved @ mat.T
        if bias is not None:
            out = out + bias
        return np.moveaxis(out, -1, axis).astype(features.dtype, copy=False)


class VADTrim(PostProcessor):
    """Drop unvoiced frames by energy VAD (Kaldi ``compute-vad`` +
    ``select-voiced-frames`` fused).

    The decision runs :func:`speech_tpu_torch.ops.vad.energy_vad_np` over
    the log-energy column (``energy_idx``; the computers'
    ``include_energy`` convention puts it first) of a ``(time,
    features)`` matrix and keeps the voiced rows.
    """

    aliases = {"vad_trim", "vad"}

    def __init__(
        self,
        energy_threshold: float = 5.0,
        energy_mean_scale: float = 0.5,
        frames_context: int = 0,
        proportion_threshold: float = 0.6,
        energy_idx: int = 0,
        time_axis: int = 0,
    ):
        if frames_context < 0:
            raise ValueError(
                f"frames_context must be >= 0, got {frames_context}"
            )
        if not 0.0 < proportion_threshold < 1.0:
            raise ValueError(
                f"proportion_threshold must be in (0, 1), got "
                f"{proportion_threshold}"
            )
        if energy_mean_scale < 0:
            raise ValueError(
                f"energy_mean_scale must be >= 0, got {energy_mean_scale}"
            )
        self.energy_threshold = float(energy_threshold)
        self.energy_mean_scale = float(energy_mean_scale)
        self.frames_context = int(frames_context)
        self.proportion_threshold = float(proportion_threshold)
        self.energy_idx = int(energy_idx)
        self.time_axis = time_axis

    def apply(
        self, features: np.ndarray, axis: int = -1, in_place: bool = False
    ) -> np.ndarray:
        from .ops.vad import energy_vad_np

        features = np.asarray(features)
        if features.ndim != 2:
            raise RuntimeError(
                f"VADTrim expects (time, features) matrices, got shape "
                f"{features.shape}"
            )
        axis = axis % 2
        time_axis = self.time_axis % 2
        if axis == time_axis:
            raise RuntimeError(f"feature and time axes are the same ({axis})")
        energy = np.moveaxis(features, time_axis, 0)[:, self.energy_idx]
        voiced = energy_vad_np(
            np.asarray(energy, np.float64),
            energy_threshold=self.energy_threshold,
            energy_mean_scale=self.energy_mean_scale,
            frames_context=self.frames_context,
            proportion_threshold=self.proportion_threshold,
        )
        return np.compress(voiced, features, axis=time_axis)
