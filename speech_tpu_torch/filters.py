"""Filter banks and window functions (host-side precompute).

These classes are *config -> weights compilers*: they run once, on the host,
in float64 numpy, when a computer is constructed.  The GPU never sees them —
frame computers bake their outputs (truncated frequency responses, windows,
impulse responses) into dense weight matrices that the device compute path
consumes (see :mod:`speech_tpu_torch.compute` and :mod:`speech_tpu_torch.ops`).

The public contract (`LinearFilterBank` with ``supports``/``supports_hz``/
``get_impulse_response``/``get_frequency_response``/``get_truncated_response``,
plus the four concrete banks and five windows) mirrors the reference
implementation's API and numerics (reference: src/pydrobert/speech/filters.py)
so that configs and golden tests carry over; the implementations here are
vectorized over bins/samples rather than per-element Python loops.
"""

import abc
import math

from typing import Mapping, Optional, Tuple, Union

import numpy as np

from . import config
from .alias import AliasedFactory, alias_factory_subclass_from_arg
from .scales import MelScaling, ScalingFunction, VTLNScaling
from .utils import angular_to_hertz, hertz_to_angular

__all__ = [
    "BartlettWindow",
    "BlackmanWindow",
    "ComplexGammatoneFilterBank",
    "Fbank",
    "GaborFilterBank",
    "GammaWindow",
    "HammingWindow",
    "HannWindow",
    "LinearFilterBank",
    "TriangularOverlappingFilterBank",
    "WindowFunction",
]


def _half_dft_size(width: int) -> int:
    """Number of bins in the [0, pi] half spectrum of a width-point DFT."""
    return (width + 1) // 2 if width % 2 else width // 2 + 1


def _layout_vertices(
    scaling_function, low_hz: float, high_hz: float, num: int, offset: float = 0.0
) -> np.ndarray:
    """Place ``num`` points uniformly in the scale domain, mapped back to Hz.

    ``offset`` shifts the uniform grid by a fraction of the step (the
    Gabor/Gammatone banks use 0.5 to get intersection edges between centers;
    reference: filters.py:300-306, 719-722).
    """
    scale_low = scaling_function.hertz_to_scale(low_hz)
    scale_high = scaling_function.hertz_to_scale(high_hz)
    scale_delta = (scale_high - scale_low) / (num + 1)
    idx = np.arange(num + 2 if not offset else num + 1, dtype=np.float64)
    return np.asarray(
        scaling_function.scale_to_hertz(scale_low + scale_delta * (idx + offset)),
        dtype=np.float64,
    )


class LinearFilterBank(AliasedFactory):
    """A collection of linear, time-invariant filters, lowest frequency first.

    Same contract as the reference (filters.py:49-237): factory methods
    instantiate each filter in the time domain (`get_impulse_response`), the
    2pi-periodized frequency domain (`get_frequency_response`), or as the
    nonzero region of the frequency response (`get_truncated_response`).
    """

    @property
    @abc.abstractmethod
    def is_real(self) -> bool:
        """Whether filters are real (conjugate-symmetric spectrum)."""
        ...

    @property
    @abc.abstractmethod
    def is_analytic(self) -> bool:
        """Whether filters are (approximately) analytic."""
        ...

    @property
    @abc.abstractmethod
    def is_zero_phase(self) -> bool:
        """Whether filters are zero phase (even, real spectrum)."""
        ...

    @property
    @abc.abstractmethod
    def num_filts(self) -> int:
        """Number of filters in the bank."""
        ...

    @property
    @abc.abstractmethod
    def sampling_rate(self) -> float:
        """Samples per second of the target recordings."""
        ...

    @property
    @abc.abstractmethod
    def supports_hz(self) -> Tuple[Tuple[float, float], ...]:
        """Effective frequency supports (low, high) in Hz per filter."""
        ...

    @property
    @abc.abstractmethod
    def supports(self) -> Tuple[Tuple[int, int], ...]:
        """Effective sample-domain supports (first, last) per filter."""
        ...

    @property
    def supports_ms(self) -> Tuple[Tuple[float, float], ...]:
        """Effective sample-domain supports in milliseconds."""
        rate = self.sampling_rate
        return tuple((s[0] * 1000 / rate, s[1] * 1000 / rate) for s in self.supports)

    @abc.abstractmethod
    def get_impulse_response(self, filt_idx: int, width: int) -> np.ndarray:
        """Filter impulse response in a width-sample buffer (aliases if short).

        Returns a 1D float64 or complex128 array of length ``width``.
        """
        ...

    @abc.abstractmethod
    def get_frequency_response(
        self, filt_idx: int, width: int, half: bool = False
    ) -> np.ndarray:
        """2pi-periodized frequency response over a width-point DFT grid.

        With ``half=True`` only bins in ``[0, pi]`` are returned
        (``width // 2 + 1`` bins for even width, ``(width + 1) // 2`` odd).
        Zero-phase filters return float64; others complex128.
        """
        ...

    @abc.abstractmethod
    def get_truncated_response(
        self, filt_idx: int, width: int
    ) -> Tuple[int, np.ndarray]:
        """Nonzero region ``(bin_idx, buf)`` of the frequency response.

        Complex filters may wrap: ``bin_idx + len(buf)`` can exceed ``width``.
        Real filters return only the nonzero half-spectrum region, never
        wrapped.  See reference filters.py:189-237 for reconstruction
        recipes (exercised in tests/test_filters.py).
        """
        ...


class TriangularOverlappingFilterBank(LinearFilterBank):
    """Triangular frequency responses with vertices laid out along a scale.

    Triangles are triangular *in frequency*; if the scale is nonlinear the
    triangles are asymmetric (reference: filters.py:240-440).

    Parameters
    ----------
    scaling_function
        Layout of filters in the Fourier domain (``ScalingFunction``,
        alias string, or config mapping).
    num_filts
        Number of filters in the bank.
    high_hz
        Topmost edge of filter frequencies; defaults to the Nyquist.
    low_hz
        Bottommost edge of the filter frequencies.
    sampling_rate
        Sampling rate (cycles/sec) of target recordings.
    analytic
        Whether to suppress the negative-frequency half, making the filters
        complex and analytic.
    """

    aliases = {"tri", "triangular"}

    def __init__(
        self,
        scaling_function: Union[ScalingFunction, Mapping, str],
        num_filts: int = 40,
        high_hz: Optional[float] = None,
        low_hz: float = 20.0,
        sampling_rate: float = 16000,
        analytic: bool = False,
    ):
        scaling_function = alias_factory_subclass_from_arg(
            ScalingFunction, scaling_function
        )
        nyquist = sampling_rate / 2
        if high_hz is None:
            high_hz = nyquist
        # 1 Hz of leeway for float/serialization slop (reference:292-297)
        if not (0 <= low_hz < high_hz <= nyquist + 1):
            raise ValueError(
                "Invalid frequency range: ({:.2f},{:.2f})".format(low_hz, high_hz)
            )
        high_hz = min(high_hz, nyquist)
        self._rate = sampling_rate
        self._vertices = tuple(
            _layout_vertices(scaling_function, low_hz, high_hz, num_filts)
        )
        self._analytic = analytic

    @property
    def is_real(self) -> bool:
        return not self._analytic

    @property
    def is_analytic(self) -> bool:
        return self._analytic

    @property
    def is_zero_phase(self) -> bool:
        return True

    @property
    def num_filts(self) -> int:
        return len(self._vertices) - 2

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def centers_hz(self) -> Tuple[float, ...]:
        """Frequency of maximum gain per filter, in Hz."""
        return self._vertices[1:-1]

    @property
    def supports_hz(self) -> Tuple[Tuple[float, float], ...]:
        return tuple(zip(self._vertices[:-2], self._vertices[2:]))

    @property
    def supports(self) -> Tuple[Tuple[int, int], ...]:
        # |h(t)| is bounded by 2(w_r - w_l) / ((w_c - w_l)(w_r - w_c) t^2 pi);
        # solve for where the bound crosses the support threshold
        # (reference:345-358)
        supports = []
        for idx in range(len(self._vertices) - 2):
            left = hertz_to_angular(self._vertices[idx], self._rate)
            mid = hertz_to_angular(self._vertices[idx + 1], self._rate)
            right = hertz_to_angular(self._vertices[idx + 2], self._rate)
            K = np.sqrt(8 * (right - left) / np.pi)
            K /= np.sqrt(config.EFFECTIVE_SUPPORT_THRESHOLD)
            K /= np.sqrt(mid - left) * np.sqrt(right - mid)
            K = int(np.ceil(K))
            supports.append((-K // 2 - 1, K // 2 + 1))
        return tuple(supports)

    def get_impulse_response(self, filt_idx: int, width: int) -> np.ndarray:
        left = hertz_to_angular(self._vertices[filt_idx], self._rate)
        mid = hertz_to_angular(self._vertices[filt_idx + 1], self._rate)
        right = hertz_to_angular(self._vertices[filt_idx + 2], self._rate)
        res = np.zeros(width, dtype=np.complex128 if self._analytic else np.float64)
        # divide by the larger gap for numerical stability (reference:366-372)
        if right - mid > mid - left:
            denom, div_term = right - mid, mid - left
        else:
            denom, div_term = mid - left, right - mid
        denom *= (int(self._analytic) + 1) * np.pi
        t = np.arange(1, width + 1, dtype=np.float64)
        if self._analytic:
            numer = (right - left) / div_term * np.exp(1j * mid * t)
            numer = numer - (right - mid) / div_term * np.exp(1j * left * t)
            numer = numer - (mid - left) / div_term * np.exp(1j * right * t)
        else:
            numer = (right - left) / div_term * np.cos(mid * t)
            numer = numer - (right - mid) / div_term * np.cos(left * t)
            numer = numer - (mid - left) / div_term * np.cos(right * t)
        vals = numer / (t * t)
        # t in [1, width): res[t] += v(t), res[width - t] += conj(v(t));
        # the t == width term aliases onto res[0]
        res[1:] += vals[: width - 1]
        res[1:] += np.conj(vals[: width - 1])[::-1]
        res[0] += vals[width - 1]
        dc = mid / div_term * (right ** 2 - left ** 2)
        dc += right / div_term * (left ** 2 - mid ** 2)
        dc += left / div_term * (mid ** 2 - right ** 2)
        res[0] += dc / 2
        res /= denom
        return res

    def _response_values(self, filt_idx: int, idx: np.ndarray, width: int):
        left = self._vertices[filt_idx]
        mid = self._vertices[filt_idx + 1]
        right = self._vertices[filt_idx + 2]
        hz = self._rate * idx.astype(np.float64) / width
        return np.where(
            hz <= mid,
            (hz - left) / (mid - left),
            (right - hz) / (right - mid),
        )

    def _bin_bounds(self, filt_idx: int, width: int) -> Tuple[int, int]:
        left = self._vertices[filt_idx]
        right = self._vertices[filt_idx + 2]
        left_idx = int(np.ceil(width * left / self._rate))
        right_idx = int(width * right / self._rate)
        return left_idx, right_idx

    def get_frequency_response(
        self, filt_idx: int, width: int, half: bool = False
    ) -> np.ndarray:
        left_idx, right_idx = self._bin_bounds(filt_idx, width)
        dft_size = _half_dft_size(width) if half else width
        res = np.zeros(dft_size, dtype=np.float64)
        idx = np.arange(left_idx, min(dft_size, right_idx + 1))
        if len(idx):
            vals = self._response_values(filt_idx, idx, width)
            res[idx] = vals
            if not half and not self._analytic:
                res[(-idx) % width] = vals
        return res

    def get_truncated_response(
        self, filt_idx: int, width: int
    ) -> Tuple[int, np.ndarray]:
        left_idx, right_idx = self._bin_bounds(filt_idx, width)
        res = np.zeros(1 + right_idx - left_idx, dtype=np.float64)
        idx = np.arange(left_idx, min(width, right_idx + 1))
        if len(idx):
            res[idx - left_idx] = self._response_values(filt_idx, idx, width)
        return left_idx, res


class Fbank(LinearFilterBank):
    """Kaldi/HTK-compatible mel-triangular bank, square-rooted.

    Triangular *in the mel domain* (unlike `TriangularOverlappingFilterBank`,
    which is triangular in frequency), with the pointwise square root of the
    usual response because this framework filters *before* taking the power
    (reference: filters.py:443-626 and its Notes section).

    Parameters
    ----------
    num_filts
        Number of filters in the bank.
    high_hz
        Topmost edge of filter frequencies; defaults to the Nyquist.
    low_hz
        Bottommost edge of the filter frequencies.
    sampling_rate
        Sampling rate (cycles/sec) of target recordings.
    analytic
        Whether to suppress the negative-frequency half.
    """

    aliases = {"fbank"}

    def __init__(
        self,
        num_filts: int = 40,
        high_hz: Optional[float] = None,
        low_hz: float = 20.0,
        sampling_rate: float = 16000,
        analytic: bool = False,
        vtln_warp: float = 1.0,
        vtln_low_hz: float = 100.0,
        vtln_high_hz: float = -500.0,
    ):
        if low_hz < 0 or (
            high_hz and (high_hz <= low_hz or high_hz > sampling_rate // 2)
        ):
            raise ValueError(
                "Invalid frequency range: ({:.2f},{:.2f})".format(low_hz, high_hz)
            )
        self._rate = sampling_rate
        if high_hz is None:
            high_hz = sampling_rate // 2
        if vtln_warp != 1.0:
            # Kaldi compute-fbank-feats --vtln-warp: mel layout with the
            # vertex frequencies VTLN-warped (scales.VTLNScaling)
            scaling_function = VTLNScaling(
                MelScaling(),
                warp=vtln_warp,
                low_hz=low_hz,
                high_hz=high_hz,
                vtln_low_hz=vtln_low_hz,
                vtln_high_hz=vtln_high_hz,
            )
        else:
            scaling_function = MelScaling()
        self._vertices = tuple(
            _layout_vertices(scaling_function, low_hz, high_hz, num_filts)
        )
        self._analytic = analytic

    @property
    def is_real(self) -> bool:
        return not self._analytic

    @property
    def is_analytic(self) -> bool:
        return self._analytic

    @property
    def is_zero_phase(self) -> bool:
        return True

    @property
    def num_filts(self) -> int:
        return len(self._vertices) - 2

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def centers_hz(self) -> Tuple[float, ...]:
        """Frequency of maximum gain per filter, in Hz."""
        return self._vertices[1:-1]

    @property
    def supports_hz(self) -> Tuple[Tuple[float, float], ...]:
        return tuple(zip(self._vertices[:-2], self._vertices[2:]))

    @property
    def supports(self) -> Tuple[Tuple[int, int], ...]:
        # |h(t)| bound for t > 0 (reference:543-560)
        supports = []
        for idx in range(len(self._vertices) - 2):
            left = hertz_to_angular(self._vertices[idx], self._rate)
            mid = hertz_to_angular(self._vertices[idx + 1], self._rate)
            right = hertz_to_angular(self._vertices[idx + 2], self._rate)
            K = right - left + 2 * ((right - mid) * (mid - left)) ** 2
            K /= config.EFFECTIVE_SUPPORT_THRESHOLD ** 2 * np.pi
            K /= (right - mid) * (mid - left)
            K /= np.sqrt(config.EFFECTIVE_SUPPORT_THRESHOLD)
            K /= np.sqrt(mid - left) * np.sqrt(right - mid)
            K **= 0.3333
            K = int(np.ceil(K))
            supports.append((-K // 2 - 1, K // 2 + 1))
        return tuple(supports)

    def get_impulse_response(self, filt_idx: int, width: int) -> np.ndarray:
        # invert the frequency response (reference:562-569)
        if self.is_analytic:
            freq_response = self.get_frequency_response(filt_idx, width, half=False)
            return np.fft.ifft(freq_response)
        freq_response = self.get_frequency_response(filt_idx, width, half=True)
        return np.fft.irfft(freq_response, n=width)

    def _response_values(self, filt_idx: int, idx: np.ndarray, width: int):
        scaling_function = MelScaling()
        left_mel = scaling_function.hertz_to_scale(self._vertices[filt_idx])
        mid_mel = scaling_function.hertz_to_scale(self._vertices[filt_idx + 1])
        right_mel = scaling_function.hertz_to_scale(self._vertices[filt_idx + 2])
        hz = self._rate * idx.astype(np.float64) / width
        mel = np.asarray(scaling_function.hertz_to_scale(hz))
        return np.where(
            mel <= mid_mel,
            (mel - left_mel) / (mid_mel - left_mel),
            (right_mel - mel) / (right_mel - mid_mel),
        )

    def _bin_bounds(self, filt_idx: int, width: int) -> Tuple[int, int]:
        left_hz = self._vertices[filt_idx]
        right_hz = self._vertices[filt_idx + 2]
        left_idx = int(np.ceil(width * left_hz / self._rate))
        right_idx = int(width * right_hz / self._rate)
        return left_idx, right_idx

    def get_frequency_response(
        self, filt_idx: int, width: int, half: bool = False
    ) -> np.ndarray:
        left_idx, right_idx = self._bin_bounds(filt_idx, width)
        dft_size = _half_dft_size(width) if half else width
        res = np.zeros(dft_size, dtype=np.float64)
        idx = np.arange(left_idx, min(dft_size, right_idx + 1))
        if len(idx):
            vals = self._response_values(filt_idx, idx, width) ** 0.5
            res[idx] = vals
            if not half and not self._analytic:
                res[(-idx) % width] = vals
        return res

    def get_truncated_response(
        self, filt_idx: int, width: int
    ) -> Tuple[int, np.ndarray]:
        left_idx, right_idx = self._bin_bounds(filt_idx, width)
        idx = np.arange(left_idx, min(width, right_idx + 1))
        res = self._response_values(filt_idx, idx, width)
        return left_idx, res ** 0.5


class GaborFilterBank(LinearFilterBank):
    r"""Gabor filters with bandwidths set by intersections along a scale.

    Complex, mostly analytic filters with Gaussian envelopes in both domains:

    .. math::

        f(t) = C \sigma^{-1/2} \pi^{-1/4} e^{-t^2/(2\sigma^2) + i\xi t},
        \qquad
        \hat f(\omega) = C \sqrt{2\sigma} \pi^{1/4}
            e^{-\sigma^2 (\xi - \omega)^2 / 2}

    Adjacent filters intersect at their equivalent rectangular bandwidth
    (``erb=True``) or 3 dB point (reference: filters.py:629-900).

    Parameters
    ----------
    scaling_function
        Layout of filters in the Fourier domain.
    num_filts
        Number of filters in the bank.
    high_hz
        Topmost edge of filter frequencies; defaults to the Nyquist.
    low_hz
        Bottommost edge of the filter frequencies.
    sampling_rate
        Sampling rate (cycles/sec) of target recordings.
    scale_l2_norm
        Scale each filter to unit L2 norm; otherwise peak response is 1.
    erb
        Use ERB intersections rather than 3 dB.
    """

    aliases = {"gabor"}

    def __init__(
        self,
        scaling_function: Union[ScalingFunction, Mapping, str],
        num_filts: int = 40,
        high_hz: Optional[float] = None,
        low_hz: float = 20.0,
        sampling_rate: float = 16000,
        scale_l2_norm: bool = False,
        erb: bool = False,
    ):
        scaling_function = alias_factory_subclass_from_arg(
            ScalingFunction, scaling_function
        )
        self._scale_l2_norm = scale_l2_norm
        self._erb = erb
        if low_hz < 0 or (
            high_hz and (high_hz <= low_hz or high_hz > sampling_rate // 2)
        ):
            raise ValueError(
                "Invalid frequency range: ({:.2f},{:.2f})".format(low_hz, high_hz)
            )
        self._rate = sampling_rate
        if high_hz is None:
            high_hz = sampling_rate // 2
        # edges are pretend intersection points spaced uniformly in the scale
        # domain, offset half a step from the centers (reference:714-722)
        edges = _layout_vertices(
            scaling_function, low_hz, high_hz, num_filts, offset=0.5
        )
        log_2 = np.log(2)
        log_pi = np.log(np.pi)
        time_thresh_log = -2 * np.log(config.EFFECTIVE_SUPPORT_THRESHOLD)
        freq_thresh_log = time_thresh_log
        if scale_l2_norm:
            freq_thresh_log += log_2 + 0.5 * log_pi
            time_thresh_log -= 0.5 * log_pi
        else:
            time_thresh_log -= log_2 + log_pi
        if erb:
            crossing_factor = np.sqrt(np.pi) / 2
        else:
            crossing_factor = np.sqrt(3 / 10 * np.log(10))
        left_edges, right_edges = edges[:-1], edges[1:]
        centers_hz = (left_edges + right_edges) / 2
        centers_ang = hertz_to_angular(centers_hz, self._rate)
        stds = crossing_factor / hertz_to_angular(
            centers_hz - left_edges, self._rate
        )
        log_stds = np.log(stds)
        if scale_l2_norm:
            halfwidth_ang = np.sqrt(log_stds + freq_thresh_log) / stds
            wrap_halfwidth_ang = np.sqrt(log_stds + freq_thresh_log + log_2) / stds
            halfwidth_samps = np.ceil(
                stds * np.sqrt(time_thresh_log - log_stds)
            ).astype(np.int64)
        else:
            halfwidth_ang = np.sqrt(freq_thresh_log) / stds
            wrap_halfwidth_ang = np.sqrt(freq_thresh_log + log_2) / stds
            halfwidth_samps = np.ceil(
                stds * np.sqrt(time_thresh_log - 2 * log_stds)
            ).astype(np.int64)
        self._wrap_below = bool(np.any(centers_ang - halfwidth_ang < 0))
        self._centers_ang = tuple(centers_ang)
        self._centers_hz = tuple(centers_hz)
        self._stds = tuple(stds)
        self._supports_ang = tuple(
            zip(centers_ang - halfwidth_ang, centers_ang + halfwidth_ang)
        )
        self._wrap_supports_ang = tuple(2 * wrap_halfwidth_ang)
        self._supports_hz = tuple(
            (
                angular_to_hertz(ang_l, self._rate),
                angular_to_hertz(ang_h, self._rate),
            )
            for ang_l, ang_h in self._supports_ang
        )
        self._supports = tuple(
            (-int(d), int(d)) for d in halfwidth_samps
        )

    @property
    def is_real(self) -> bool:
        return False

    @property
    def is_analytic(self) -> bool:
        return not self._wrap_below

    @property
    def is_zero_phase(self) -> bool:
        return True

    @property
    def num_filts(self) -> int:
        return len(self._centers_hz)

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def centers_hz(self) -> Tuple[float, ...]:
        """Frequency of maximum gain per filter, in Hz."""
        return self._centers_hz

    @property
    def supports_hz(self) -> Tuple[Tuple[float, float], ...]:
        return self._supports_hz

    @property
    def supports(self) -> Tuple[Tuple[int, int], ...]:
        return self._supports

    @property
    def scaled_l2_norm(self) -> bool:
        return self._scale_l2_norm

    @property
    def erb(self) -> bool:
        return self._erb

    def get_impulse_response(self, filt_idx: int, width: int) -> np.ndarray:
        center_ang = self._centers_ang[filt_idx]
        std = self._stds[filt_idx]
        res = np.zeros(width, dtype=np.complex128)
        if self._scale_l2_norm:
            const_term = -0.5 * np.log(std) - 0.25 * np.log(np.pi)
        else:
            const_term = -0.5 * np.log(2 * np.pi) - np.log(std)
        denom_term = 2 * std ** 2
        t = np.arange(width + 1, dtype=np.float64)
        vals = np.exp(
            -(t ** 2) / denom_term + const_term + 1j * center_ang * t
        )
        # t in [0, width): res[t] += v(t); t in [1, width]: res[-t] += conj
        res += vals[:width]
        res[0] += np.conj(vals[width])
        res[1:] += np.conj(vals[1:width])[::-1]
        return res

    def _freq_response_values(
        self, filt_idx: int, idx: np.ndarray, width: int, periods: range
    ) -> np.ndarray:
        center_ang = self._centers_ang[filt_idx]
        std = self._stds[filt_idx]
        if self._scale_l2_norm:
            const_term = 0.5 * np.log(2 * std) + 0.25 * np.log(np.pi)
        else:
            const_term = 0.0
        num_term = -(std ** 2) / 2
        res = np.zeros(len(idx), dtype=np.float64)
        frac = idx.astype(np.float64) / width
        for period in periods:
            omega = (frac + period) * 2 * np.pi
            res += np.exp(num_term * (center_ang - omega) ** 2 + const_term)
        return res

    def get_frequency_response(
        self, filt_idx: int, width: int, half: bool = False
    ) -> np.ndarray:
        lowest_ang, highest_ang = self._supports_ang[filt_idx]
        dft_size = _half_dft_size(width) if half else width
        periods = range(
            -1 - int(max(-lowest_ang, 0) / (2 * np.pi)),
            2 + int(highest_ang / (2 * np.pi)),
        )
        return self._freq_response_values(
            filt_idx, np.arange(dft_size), width, periods
        )

    def get_truncated_response(
        self, filt_idx: int, width: int
    ) -> Tuple[int, np.ndarray]:
        # if the support at *half* the effective threshold exceeds the 2pi
        # period, aliasing overlap exceeds the threshold everywhere: the
        # entire period is supported (reference:870-879)
        if self._wrap_supports_ang[filt_idx] >= 2 * np.pi:
            return 0, self.get_frequency_response(filt_idx, width)
        lowest_ang, highest_ang = self._supports_ang[filt_idx]
        left_idx = int(np.ceil(width * lowest_ang / (2 * np.pi)))
        right_idx = int(width * highest_ang / (2 * np.pi))
        periods = range(
            -int(max(-lowest_ang, 0) / (2 * np.pi)),
            1 + int(highest_ang / (2 * np.pi)),
        )
        res = self._freq_response_values(
            filt_idx, np.arange(left_idx, right_idx + 1), width, periods
        )
        return left_idx % width, res


class ComplexGammatoneFilterBank(LinearFilterBank):
    r"""Gammatone filters with complex carriers.

    .. math::

        h(t) = c t^{n-1} e^{-\alpha t + i\xi t} u(t), \qquad
        H(\omega) = \frac{c (n-1)!}{(\alpha + i(\omega - \xi))^n}

    with order :math:`n`, bandwidth :math:`\alpha`, carrier :math:`\xi`
    (reference: filters.py:903-1211).  Bandwidths are set so adjacent filters
    intersect at their ERB (``erb=True``) or 3 dB point.

    Parameters
    ----------
    scaling_function
        Layout of filters in the Fourier domain.
    num_filts
        Number of filters in the bank.
    high_hz
        Topmost edge of filter frequencies; defaults to the Nyquist.
    low_hz
        Bottommost edge of the filter frequencies.
    sampling_rate
        Sampling rate (cycles/sec) of target recordings.
    order
        The :math:`n` parameter; positive. Larger is more symmetric.
    max_centered
        Shift filters so the envelope maximum sits at sample 0.
    scale_l2_norm
        Scale each filter to unit L2 norm; otherwise peak response is 1.
    erb
        Use ERB intersections rather than 3 dB.
    """

    aliases = {"gammatone", "tonebank"}

    def __init__(
        self,
        scaling_function: Union[ScalingFunction, Mapping, str],
        num_filts: int = 40,
        high_hz: Optional[float] = None,
        low_hz: float = 20.0,
        sampling_rate: float = 16000,
        order: int = 4,
        max_centered: bool = False,
        scale_l2_norm: bool = False,
        erb: bool = False,
    ):
        scaling_function = alias_factory_subclass_from_arg(
            ScalingFunction, scaling_function
        )
        self._scale_l2_norm = scale_l2_norm
        self._erb = erb
        if low_hz < 0 or (
            high_hz and (high_hz <= low_hz or high_hz > sampling_rate // 2)
        ):
            raise ValueError(
                "Invalid frequency range: ({:.2f},{:.2f})".format(low_hz, high_hz)
            )
        if not isinstance(order, int) or order <= 0:
            raise ValueError("order must be a positive integer")
        self._order = order
        self._rate = sampling_rate
        if high_hz is None:
            high_hz = sampling_rate // 2
        edges = _layout_vertices(
            scaling_function, low_hz, high_hz, num_filts, offset=0.5
        )
        log_eps = np.log(config.EFFECTIVE_SUPPORT_THRESHOLD)
        log_double_factorial = np.log(math.factorial(2 * order - 2))
        log_factorial = np.log(math.factorial(order - 1))
        log_2 = np.log(2)
        if erb:
            alpha_const = log_2 * (2 * order - 1)
            alpha_const += 2 * log_factorial
            alpha_const -= log_double_factorial
        else:
            alpha_const = -0.5 * np.log(4 * (2 ** (1 / order)) - 4)
        left_edges, right_edges = edges[:-1], edges[1:]
        centers_hz = (left_edges + right_edges) / 2
        xis = hertz_to_angular(centers_hz, self._rate)
        log_alphas = alpha_const + np.log(
            hertz_to_angular(right_edges - left_edges, self._rate)
        )
        alphas = np.exp(log_alphas)
        if scale_l2_norm:
            log_cs = 0.5 * (log_2 + log_alphas + log_double_factorial)
            log_cs -= order * (log_alphas + log_2)
        else:
            log_cs = order * log_alphas - log_factorial
        cs = np.exp(log_cs)
        if max_centered:
            offsets = -(order - 1) / alphas
        else:
            offsets = np.zeros_like(alphas)
        supp_a = (2 / order) * (log_cs + log_factorial - log_eps)
        wrap_supp_a = supp_a + (2 / order) * log_2
        supp_b = np.exp(2 * log_alphas)
        halfwidth_ang = (np.exp(supp_a) - supp_b) ** 0.5
        wrap_halfwidth_ang = (np.exp(wrap_supp_a) - supp_b) ** 0.5
        self._centers_hz = tuple(centers_hz)
        self._xis = tuple(xis)
        self._alphas = tuple(alphas)
        self._cs = tuple(cs)
        self._offsets = tuple(offsets)
        self._supports_ang = tuple(zip(xis - halfwidth_ang, xis + halfwidth_ang))
        self._wrap_below = bool(np.any(xis - halfwidth_ang < 0))
        self._wrap_supports_ang = tuple(2 * wrap_halfwidth_ang)
        self._supports_hz = tuple(
            (
                angular_to_hertz(ang_l, self._rate),
                angular_to_hertz(ang_h, self._rate),
            )
            for ang_l, ang_h in self._supports_ang
        )
        self._supports = tuple(
            self._calculate_temp_support(idx) for idx in range(len(centers_hz))
        )

    @property
    def is_real(self) -> bool:
        return False

    @property
    def is_analytic(self) -> bool:
        return not self._wrap_below

    @property
    def is_zero_phase(self) -> bool:
        return False

    @property
    def num_filts(self) -> int:
        return len(self._centers_hz)

    @property
    def order(self) -> int:
        return self._order

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def centers_hz(self) -> Tuple[float, ...]:
        """Frequency of maximum gain per filter, in Hz."""
        return self._centers_hz

    @property
    def supports_hz(self) -> Tuple[Tuple[float, float], ...]:
        return self._supports_hz

    @property
    def supports(self) -> Tuple[Tuple[int, int], ...]:
        return self._supports

    @property
    def scaled_l2_norm(self) -> bool:
        return self._scale_l2_norm

    @property
    def erb(self) -> bool:
        return self._erb

    def _h(self, t: np.ndarray, idx: int) -> np.ndarray:
        """Impulse response at (array of) sample times ``t``."""
        t = np.asarray(t, dtype=np.float64)
        offset = self._offsets[idx]
        alpha = self._alphas[idx]
        log_c = np.log(self._cs[idx])
        xi = self._xis[idx]
        n = self._order
        tdiff = t - offset
        active = tdiff > 0
        safe = np.where(active, tdiff, 1.0)
        r = log_c + (n - 1) * np.log(safe) + (-alpha + 1j * xi) * safe
        return np.where(active, np.exp(r), 0j)

    def _H(self, omega: np.ndarray, idx: int) -> np.ndarray:
        """Frequency response at (array of) angular frequencies ``omega``."""
        omega = np.asarray(omega, dtype=np.float64)
        alpha = self._alphas[idx]
        c = self._cs[idx]
        xi = self._xis[idx]
        offset = self._offsets[idx]
        n = self._order
        numer = np.exp(-1j * omega * offset) * c * math.factorial(n - 1)
        denom = (alpha + 1j * (omega - xi)) ** n
        return numer / denom

    def get_impulse_response(self, filt_idx: int, width: int) -> np.ndarray:
        left_sup, right_sup = self.supports[filt_idx]
        left_period = int(np.floor(left_sup / width))
        right_period = int(np.ceil(right_sup / width))
        res = np.zeros(width, dtype=np.complex128)
        base = np.arange(width, dtype=np.float64)
        for period in range(left_period, right_period + 1):
            res += self._h(base + period * width, filt_idx)
        return res

    def get_frequency_response(
        self, filt_idx: int, width: int, half: bool = False
    ) -> np.ndarray:
        left_sup, right_sup = self._supports_ang[filt_idx]
        left_period = int(np.floor(left_sup / 2 / np.pi))
        right_period = int(np.ceil(right_sup / 2 / np.pi))
        dft_size = _half_dft_size(width) if half else width
        res = np.zeros(dft_size, dtype=np.complex128)
        omega = np.arange(dft_size, dtype=np.float64) * 2 * np.pi / width
        for period in range(left_period, right_period + 1):
            res += self._H(omega + 2 * np.pi * period, filt_idx)
        return res

    def get_truncated_response(
        self, filt_idx: int, width: int
    ) -> Tuple[int, np.ndarray]:
        left_sup, right_sup = self._supports_ang[filt_idx]
        wrap_ang = self._wrap_supports_ang[filt_idx]
        # the support at half the effective threshold exceeding one period
        # means wrapped contributions stay above threshold everywhere
        # (reference:1146-1156)
        if right_sup - left_sup + wrap_ang >= 2 * np.pi:
            return 0, self.get_frequency_response(filt_idx, width)
        left_idx = int(np.ceil(width * left_sup / (2 * np.pi)))
        right_idx = int(width * right_sup / (2 * np.pi))
        omega = np.arange(left_idx, right_idx + 1, dtype=np.float64)
        omega *= 2 * np.pi / width
        return left_idx % width, self._H(omega, filt_idx)

    def _calculate_temp_support(self, idx: int) -> Tuple[int, int]:
        # Newton iteration on the envelope to find where |h| drops below the
        # effective-support threshold (reference:1187-1211)
        alpha = self._alphas[idx]
        c = self._cs[idx]
        offset = self._offsets[idx]
        n = self._order
        eps = config.EFFECTIVE_SUPPORT_THRESHOLD
        if n == 1:
            right = int(np.ceil((np.log(c) - np.log(eps) / alpha)))
        else:

            def _d(t):
                v = c * np.exp(-alpha * t) * t ** (n - 2)
                v *= (n - 1) - alpha * t
                return v

            right = (n - 1 + np.sqrt((n - 1) / 2)) / alpha
            h_0 = np.abs(self._h(right, idx))
            while h_0 > eps:
                d_0 = _d(right)
                right -= h_0 / d_0
                h_0 = np.abs(self._h(right, idx))
        return (int(np.floor(offset)), int(np.ceil(right) + offset))


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


class WindowFunction(AliasedFactory):
    """A real, usually lowpass, linear filter (analysis window)."""

    @abc.abstractmethod
    def get_impulse_response(self, width: int) -> np.ndarray:
        """The window as a 1D float64 vector of length ``width``."""
        ...


class BartlettWindow(WindowFunction):
    """Unit-normalized triangular window (reference: filters.py:1237-1250)."""

    aliases = {"bartlett", "triangular", "tri"}

    def get_impulse_response(self, width: int) -> np.ndarray:
        window = np.bartlett(width)
        window /= max(1, width - 1) / 2
        return window


class BlackmanWindow(WindowFunction):
    """Unit-normalized Blackman window (reference: filters.py:1253-1266)."""

    aliases = {"blackman", "black"}

    def get_impulse_response(self, width: int) -> np.ndarray:
        window = np.blackman(width)
        window /= 0.42 * max(1, width - 1)
        return window


class HammingWindow(WindowFunction):
    """Unit-normalized Hamming window (reference: filters.py:1269-1282)."""

    aliases = {"hamming"}

    def get_impulse_response(self, width: int) -> np.ndarray:
        window = np.hamming(width)
        window /= 0.54 * max(1, width - 1)
        return window


class HannWindow(WindowFunction):
    """Unit-normalized Hann window (reference: filters.py:1285-1298).

    The unit normalization (division by ``0.5 * (width - 1)``) is why
    Kaldi-parity tests add back ``2 log(0.5 (width - 1))`` to log-power
    features.
    """

    aliases = {"hanning", "hann"}

    def get_impulse_response(self, width: int) -> np.ndarray:
        window = np.hanning(width)
        window /= 0.5 * max(1, width - 1)
        return window


class GammaWindow(WindowFunction):
    r"""Asymmetric window from a reflected Gamma density, for causal framing.

    :math:`p(t; \alpha, n) = t^{n-1} e^{-\alpha t} u(t)` reflected in time,
    with :math:`\alpha` chosen so the maximum lands at ``peak * width``
    (reference: filters.py:1301-1349).

    Parameters
    ----------
    order
        The :math:`n` parameter of the Gamma density.
    peak
        ``peak * width`` is the approximate argmax of the window.
    """

    aliases = {"gamma"}

    def __init__(self, order: int = 4, peak: float = 0.75):
        self.order = order
        self.peak = peak

    def get_impulse_response(self, width: int) -> np.ndarray:
        if width <= 0:
            return np.zeros(0, np.float64)
        if width == 1:
            return np.ones(1, np.float64)
        n = self.order
        # sample i sits at reflected time t = width - 1 - i
        t = np.arange(width - 1, -1, -1, dtype=np.float64)
        if n > 1:
            # the density's mode is (n - 1) / alpha; pin it to the
            # reflected peak position
            alpha = (n - 1) / (width - self.peak * width)
        else:
            alpha = 5.0 / width  # no interior mode at n = 1: fixed decay
        # evaluate entirely in log space (normalizer alpha^n / (n-1)!)
        # so large orders cannot overflow the t^(n-1) factor
        log_norm = n * np.log(alpha) - math.lgamma(n)
        out = np.zeros(width, np.float64)
        pos = t > 0
        out[pos] = np.exp(
            (n - 1) * np.log(t[pos]) - alpha * t[pos] + log_norm
        )
        if n == 1:
            out[~pos] = np.exp(log_norm)
        return out
