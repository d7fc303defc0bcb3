"""Miscellaneous host-side math utilities, and the process's library store.

The counterpart of :mod:`speech_tpu.utils` (reference:
src/pydrobert/speech/util.py:55-186; the signal-reading dispatch that
makes up the rest of that module lives in :mod:`speech_tpu_torch.io`).
"""

import os
import threading
from typing import Optional

import numpy as np

__all__ = [
    "angular_to_hertz",
    "circshift_fourier",
    "enable_persistent_compilation_cache",
    "gauss_quant",
    "hertz_to_angular",
]

_CACHE_LOCK = threading.Lock()
_CACHE = None  # the store enable_persistent_compilation_cache set


def enable_persistent_compilation_cache(cache_dir=None, explain=False):
    """Move the process's default kernel-library store to ``cache_dir``
    (no-op if already moved); returns the store, or None on a machine
    without CUDA.

    The port compiles nothing but its native libraries (nvcc for the CUDA
    kernels, g++ for the shorten decoder), so its persistent compilation
    cache is the default :class:`speech_tpu_torch.aot.AOTCache`: by
    default ``build/speech_tpu_torch`` in the checkout, which a fresh
    container does not have.  This puts it where later processes find it:
    ``cache_dir`` (a path or an ``AOTCache``), else
    ``$TORCH_EXTENSIONS_DIR/speech_tpu_torch`` (PyTorch's own variable for
    built extension libraries), else ``~/.cache/speech_tpu_torch``.
    Libraries this process already loaded are copied in at their next
    use.  Called by the CLIs; safe to call any time.

    ``explain=True`` logs each library's hit or miss, and the key parts of
    a miss: the first thing to reach for when a "warm" process still
    builds.  A no-op where ``torch.cuda.is_available()`` is false, as the
    JAX package's is on its CPU backend.
    """
    global _CACHE
    import torch

    from . import aot

    if not torch.cuda.is_available():
        return None
    with _CACHE_LOCK:
        if _CACHE is None:
            if cache_dir is None:
                ext = os.environ.get("TORCH_EXTENSIONS_DIR")
                cache_dir = (
                    os.path.join(ext, "speech_tpu_torch") if ext
                    else os.path.join(os.path.expanduser("~"), ".cache", "speech_tpu_torch")
                )
            _CACHE = aot.set_default_store(cache_dir)
        if explain:
            _CACHE.explain = True
        return _CACHE


def hertz_to_angular(hertz, samp_rate):
    """Convert cycles/sec to radians/sec."""
    return hertz * 2 * np.pi / samp_rate


def angular_to_hertz(angle, samp_rate):
    """Convert radians/sec to cycles/sec."""
    return angle * samp_rate / (2 * np.pi)


def _gauss_quant_odeh_evans(p: float, mu: float = 0, std: float = 1) -> float:
    # rational approximation of the normal quantile (Odeh & Evans 1974)
    r = 1 - p if p > 0.5 else p
    if r < 1e-20:
        z = 10
    else:
        y = (-2 * np.log(r)) ** 0.5
        z = (
            ((4.53642210148e-5 * y + 0.0204231210245) * y + 0.342242088547) * y + 1
        ) * y + 0.322232431088
        z /= (
            ((0.0038560700634 * y + 0.10353775285) * y + 0.531103462366) * y
            + 0.588581570495
        ) * y + 0.099348462606
        z = y - z
    if p < 0.5:
        z = -z
    return z * std + mu


try:
    from scipy.stats import norm as _norm

    def gauss_quant(p: float, mu: float = 0, std: float = 1) -> float:
        return _norm.ppf(p) * std + mu

except ImportError:  # pragma: no cover
    gauss_quant = _gauss_quant_odeh_evans

gauss_quant.__doc__ = """Gaussian quantile (inverse CDF) function.

Uses :func:`scipy.stats.norm.ppf` when scipy is importable, otherwise the
Odeh & Evans (1974) rational approximation.

Parameters
----------
p
    The probability.
mu
    The Gaussian mean.
std
    The Gaussian standard deviation.
"""


def circshift_fourier(
    filt: np.ndarray,
    shift: float,
    start_idx: int = 0,
    dft_size: Optional[int] = None,
    copy: bool = True,
) -> np.ndarray:
    r"""Circularly shift a filter in time, from the Fourier domain.

    Applies the DFT shift theorem
    :math:`DFT(T_u x)[k] = DFT(x)[k] e^{-2 i \pi k u}` with
    ``u = shift / dft_size`` (reference: util.py:118-186).

    Parameters
    ----------
    filt
        The filter, in the Fourier domain.
    shift
        Number of samples to translate by.
    start_idx
        If ``filt`` is a truncated response, the DFT index where its nonzero
        region starts.
    dft_size
        DFT size; defaults to ``len(filt) + start_idx``.
    copy
        Whether to leave ``filt`` untouched.

    Returns
    -------
    np.ndarray
        complex128 shifted frequency response.
    """
    if dft_size is None:
        dft_size = len(filt) + start_idx
    shift %= dft_size
    phase = np.exp(
        -2j
        * np.pi
        * shift
        / dft_size
        * (np.arange(start_idx, start_idx + len(filt)) % dft_size)
    )
    if copy or filt.dtype != np.complex128:
        return filt * phase
    filt *= phase
    return filt


def read_signal(*args, **kwargs):
    """Compatibility re-export of :func:`speech_tpu_torch.io.read_signal`.

    The reference exposes signal reading from its util module
    (reference: util.py:362); the canonical home here is
    :mod:`speech_tpu_torch.io`.
    """
    from .io import read_signal as _read_signal

    return _read_signal(*args, **kwargs)


def wds_read_signal(key, data):
    """Compatibility re-export of :func:`speech_tpu_torch.io.wds_read_signal`
    (reference: util.py:513)."""
    from .io import wds_read_signal as _wds

    return _wds(key, data)


def alias_factory_subclass_from_arg(factory_class, arg):
    """Compatibility re-export of
    :func:`speech_tpu_torch.alias.alias_factory_subclass_from_arg`.

    The reference re-exports the alias-factory helper from its util module
    (reference: util.py:28-34); the canonical home here is
    :mod:`speech_tpu_torch.alias`.
    """
    from .alias import alias_factory_subclass_from_arg as _impl

    return _impl(factory_class, arg)
