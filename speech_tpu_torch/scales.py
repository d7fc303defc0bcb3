"""Frequency scaling functions.

Invertible maps between frequency (Hz) and a perceptual "scale" domain, used
to lay out filter bandwidths (reference: src/pydrobert/speech/scales.py).

Unlike the reference (scalar-only), every scale here is vectorized: both
directions accept floats or numpy arrays, which lets filter banks lay out all
their vertices in one shot at construction time.  All arithmetic is float64
on the host; scales are construction-time objects and never run on the GPU.
"""

import abc

import numpy as np

from .alias import AliasedFactory

__all__ = [
    "BarkScaling",
    "LinearScaling",
    "MelScaling",
    "OctaveScaling",
    "ScalingFunction",
    "VTLNScaling",
]


class ScalingFunction(AliasedFactory):
    """Invertible map between frequency (Hz) and a scale domain."""

    @abc.abstractmethod
    def scale_to_hertz(self, scale):
        """Convert scale value(s) to frequency in Hertz."""
        ...

    @abc.abstractmethod
    def hertz_to_scale(self, hertz):
        """Convert frequency (Hertz) to scale value(s)."""
        ...


class LinearScaling(ScalingFunction):
    """Linear scaling from a low frequency with a fixed slope.

    Parameters
    ----------
    low_hz
        Frequency (Hz) mapping to scale 0.
    slope_hz
        Scale increase per 1 Hz increase in frequency.
    """

    aliases = {"linear", "uniform"}

    def __init__(self, low_hz: float, slope_hz: float = 1.0):
        self.low_hz = low_hz
        self.slope_hz = slope_hz

    def scale_to_hertz(self, scale):
        return scale / self.slope_hz + self.low_hz

    def hertz_to_scale(self, hertz):
        return (hertz - self.low_hz) * self.slope_hz


class OctaveScaling(ScalingFunction):
    """Uniform scaling in the log2 (octave) domain above a low frequency.

    Parameters
    ----------
    low_hz
        Positive frequency (Hz) mapping to scale 0.
    """

    aliases = {"octave"}

    def __init__(self, low_hz: float):
        if low_hz <= 0:
            raise ValueError("low_hz must be positive")
        self.low_hz = low_hz

    def scale_to_hertz(self, scale):
        return np.exp2(scale) * max(1e-10, self.low_hz)

    def hertz_to_scale(self, hertz):
        return np.log2(hertz / max(1e-10, self.low_hz))


class MelScaling(ScalingFunction):
    r"""Mel psychoacoustic scale: :math:`s = 1127 \ln(1 + f / 700)`.

    O'Shaughnessy's functional approximation of Stevens' mel scale
    (reference: scales.py:104-125).
    """

    aliases = {"mel"}

    def scale_to_hertz(self, scale):
        return 700.0 * (np.exp(np.asarray(scale, dtype=np.float64) / 1127.0) - 1.0)

    def hertz_to_scale(self, hertz):
        return 1127.0 * np.log(1.0 + np.asarray(hertz, dtype=np.float64) / 700.0)


class BarkScaling(ScalingFunction):
    r"""Bark psychoacoustic scale (Traunmüller's approximation).

    .. math::

        z = 26.81 f / (1960 + f) - 0.53, \qquad
        s = \begin{cases}
            z + 0.15(2 - z) & z < 2 \\
            z + 0.22(z - 20.1) & z > 20.1 \\
            z & \text{otherwise}
        \end{cases}

    (reference: scales.py:128-171).
    """

    aliases = {"bark"}

    def scale_to_hertz(self, scale):
        scale = np.asarray(scale, dtype=np.float64)
        bark = np.where(
            scale < 2,
            (20.0 * scale - 6.0) / 17.0,
            np.where(scale > 20.1, (50.0 * scale + 221.1) / 61.0, scale),
        )
        out = 1960.0 * (bark + 0.53) / (26.28 - bark)
        return float(out) if out.ndim == 0 else out

    def hertz_to_scale(self, hertz):
        hertz = np.asarray(hertz, dtype=np.float64)
        bark = 26.81 * hertz / (1960.0 + hertz) - 0.53
        out = np.where(
            bark < 2,
            bark + 0.15 * (2.0 - bark),
            np.where(bark > 20.1, bark + 0.22 * (bark - 20.1), bark),
        )
        return float(out) if out.ndim == 0 else out


class VTLNScaling(ScalingFunction):
    r"""Vocal tract length normalization warp composed with another scale.

    Kaldi-style piecewise-linear frequency warping (the
    ``--vtln-warp`` option of ``compute-mfcc-feats``/
    ``compute-fbank-feats``; no reference counterpart): the band
    ``[low_hz, high_hz]`` maps onto itself with middle slope
    ``1 / warp`` between the VTLN cutoffs and linear outer segments
    chosen for continuity, so a filter bank laid out on this scale has
    its vertex frequencies warped exactly as Kaldi's mel banks are.
    Conventionally ``warp > 1`` shifts filters down (longer vocal
    tract), ``warp < 1`` up.

    ``scale_to_hertz(s) = warp(inner.scale_to_hertz(s))`` and
    ``hertz_to_scale(f) = inner.hertz_to_scale(unwarp(f))`` — i.e.
    vertices are laid out uniformly in the *inner* scale domain and
    then moved by the warp, matching Kaldi's construction.  Outside
    ``[low_hz, high_hz]`` the warp is the identity, keeping the scale
    globally invertible.

    Parameters
    ----------
    scaling_function
        The inner scale (instance, alias, or config dict) — typically
        ``"mel"``.
    warp
        The VTLN warp factor (Kaldi ``--vtln-warp``, typically in
        ``[0.8, 1.2]``; 1.0 is the identity).
    low_hz, high_hz
        The frequency band the warp maps onto itself.  Should match
        the filter bank's edges (Kaldi ``--low-freq``/``--high-freq``;
        defaults match Kaldi's 16 kHz defaults).
    vtln_low_hz, vtln_high_hz
        The inner cutoffs of the piecewise warp (Kaldi
        ``--vtln-low``/``--vtln-high``; a non-positive ``vtln_high_hz``
        is an offset from ``high_hz``, Kaldi's convention).
    """

    aliases = {"vtln"}

    def __init__(
        self,
        scaling_function,
        warp: float = 1.0,
        low_hz: float = 20.0,
        high_hz: float = 8000.0,
        vtln_low_hz: float = 100.0,
        vtln_high_hz: float = -500.0,
    ):
        from .alias import alias_factory_subclass_from_arg

        self.inner = alias_factory_subclass_from_arg(
            ScalingFunction, scaling_function
        )
        if warp <= 0:
            raise ValueError(f"warp must be positive, got {warp}")
        if vtln_high_hz <= 0:
            vtln_high_hz = high_hz + vtln_high_hz
        if not low_hz < vtln_low_hz < vtln_high_hz < high_hz:
            raise ValueError(
                f"need low_hz < vtln_low_hz < vtln_high_hz < high_hz, got "
                f"{low_hz} / {vtln_low_hz} / {vtln_high_hz} / {high_hz}"
            )
        self.warp = float(warp)
        self.low_hz = float(low_hz)
        self.high_hz = float(high_hz)
        self.vtln_low_hz = float(vtln_low_hz)
        self.vtln_high_hz = float(vtln_high_hz)
        # breakpoints of the warp: [low, l] / [l, h] / [h, high] map to
        # [low, Fl] / [Fl, Fh] / [Fh, high] with Fl = l/warp, Fh = h/warp
        l = self.vtln_low_hz * max(1.0, self.warp)
        h = self.vtln_high_hz * min(1.0, self.warp)
        scale = 1.0 / self.warp
        Fl, Fh = scale * l, scale * h
        if not (low_hz < l < h < high_hz and low_hz < Fl < Fh < high_hz):
            raise ValueError(
                f"warp {warp} pushes the VTLN cutoffs outside "
                f"({low_hz}, {high_hz}); widen the cutoffs or the band"
            )
        self._l, self._h, self._fl, self._fh = l, h, Fl, Fh
        self._scale_left = (Fl - low_hz) / (l - low_hz)
        self._scale_right = (high_hz - Fh) / (high_hz - h)
        super().__init__()

    def warp_hz(self, hertz):
        """The piecewise-linear VTLN warp itself (Hz -> warped Hz)."""
        f = np.asarray(hertz, dtype=np.float64)
        out = np.where(
            f < self._l,
            self.low_hz + self._scale_left * (f - self.low_hz),
            np.where(
                f < self._h,
                f / self.warp,
                self.high_hz + self._scale_right * (f - self.high_hz),
            ),
        )
        out = np.where((f < self.low_hz) | (f > self.high_hz), f, out)
        return float(out) if out.ndim == 0 else out

    def unwarp_hz(self, hertz):
        """The exact inverse of :meth:`warp_hz` on the warped axis."""
        y = np.asarray(hertz, dtype=np.float64)
        out = np.where(
            y < self._fl,
            self.low_hz + (y - self.low_hz) / self._scale_left,
            np.where(
                y < self._fh,
                y * self.warp,
                self.high_hz + (y - self.high_hz) / self._scale_right,
            ),
        )
        out = np.where((y < self.low_hz) | (y > self.high_hz), y, out)
        return float(out) if out.ndim == 0 else out

    def scale_to_hertz(self, scale):
        return self.warp_hz(self.inner.scale_to_hertz(scale))

    def hertz_to_scale(self, hertz):
        return self.inner.hertz_to_scale(self.unwarp_hz(hertz))
