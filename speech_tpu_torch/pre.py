"""Pre-processors: transforms applied to raw signals before computing features.

The PyTorch counterpart of :mod:`speech_tpu.pre`.  Each processor exposes
the reference-compatible host API (``apply(signal, in_place=False)``;
reference: src/pydrobert/speech/pre.py) plus a tensor form for on-device
pipelines: :func:`preemphasize`, and :func:`dither`, which draws its noise
from an explicit :class:`torch.Generator` (the JAX package takes a PRNG
key; the two give different numbers from the same seed).
"""

import abc

from typing import Optional

import numpy as np
import torch

from .alias import AliasedFactory

__all__ = [
    "Dither",
    "Preemphasize",
    "PreProcessor",
    "dither",
    "preemphasize",
]


def preemphasize(signal, coeff: float = 0.97):
    """Preemphasis along the last axis: ``new[i] = old[i] - coeff *
    old[i-1]``, ``new[0] = old[0]`` (reference: pre.py:107-149)."""
    signal = torch.as_tensor(signal)
    shifted = torch.nn.functional.pad(signal[..., :-1], (1, 0))
    return signal - coeff * shifted


def dither(generator: Optional[torch.Generator], signal, coeff: float = 1.0):
    """Dithering: add N(0, coeff^2) noise drawn from ``generator`` (on the
    signal's device; None draws from torch's default generator there)
    (reference: pre.py:67-104)."""
    signal = torch.as_tensor(signal)
    noise = torch.randn(
        signal.shape, generator=generator, dtype=signal.dtype, device=signal.device
    )
    return signal + coeff * noise


class PreProcessor(AliasedFactory):
    """A transform applied to a 1D signal tensor."""

    @abc.abstractmethod
    def apply(
        self, signal: np.ndarray, axis: Optional[int] = None, in_place: bool = False
    ) -> np.ndarray:
        """Apply the transformation to a signal.

        Intermediate values are float64; the result is cast back to the
        input dtype.  ``axis`` exists for API compatibility and is ignored
        (preprocessors apply to 1D signals).
        """
        ...


class Dither(PreProcessor):
    """Add Gaussian noise with standard deviation ``coeff`` to a signal.

    The host `apply` draws from numpy's global RNG for reference parity;
    the tensor form (:meth:`as_torch`, :func:`dither`) takes an explicit
    :class:`torch.Generator`.

    Parameters
    ----------
    coeff
        Standard deviation of the dither.
    """

    aliases = {"dither", "dithering"}

    def __init__(self, coeff: float = 1.0):
        super().__init__()
        self.coeff = coeff

    def apply(
        self, signal: np.ndarray, axis: Optional[int] = None, in_place: bool = False
    ) -> np.ndarray:
        signal_dtype = signal.dtype
        if not in_place or signal.dtype != np.float64:
            signal = signal.astype(np.float64)
        signal += np.random.normal(0, self.coeff, signal.shape)
        return signal.astype(signal_dtype, copy=False)

    def as_torch(self):
        """Return ``(generator, signal) -> signal`` for device pipelines."""
        coeff = self.coeff
        return lambda generator, signal: dither(generator, signal, coeff)


class Preemphasize(PreProcessor):
    """Attenuate low frequencies by differencing with the previous sample.

    ``new[i] = old[i] - coeff * old[i-1]`` with ``new[0] = old[0]``;
    essentially convolution with a Haar wavelet for positive ``coeff``.

    Parameters
    ----------
    coeff
        Preemphasis coefficient.
    """

    aliases = {"preemphasize", "preemphasis", "preemph"}

    def __init__(self, coeff: float = 0.97):
        super().__init__()
        self.coeff = coeff

    def apply(
        self, signal: np.ndarray, axis: Optional[int] = None, in_place: bool = False
    ) -> np.ndarray:
        signal_dtype = signal.dtype
        if not in_place or signal.dtype != np.float64:
            signal = signal.astype(np.float64)
        signal[..., 1:] -= self.coeff * signal[..., :-1]
        return signal.astype(signal_dtype, copy=False)

    def as_torch(self):
        """Return ``signal -> signal`` for device pipelines."""
        coeff = self.coeff
        return lambda signal: preemphasize(signal, coeff)
