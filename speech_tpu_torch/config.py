"""Package-wide constants and runtime flags.

The PyTorch counterpart of :mod:`speech_tpu.config` (the constants module
of ``pydrobert-speech``, reference: src/pydrobert/speech/config.py).  The
runtime switch selects how the short-time Fourier transform is realised on
the GPU: ``torch.fft.rfft``, a windowed DFT as two matrix products, or the
fused hand-written CUDA kernels of :mod:`speech_tpu_torch.ops.stft_kernels`.
"""

from typing import Set

__all__ = [
    "EFFECTIVE_SUPPORT_THRESHOLD",
    "LOG_FLOOR_VALUE",
    "FFT_MODE",
    "VALID_FFT_MODES",
    "SI_DIGIT_PARAM_BYTE_LIMIT",
    "SOUNDFILE_SUPPORTED_FILE_TYPES",
]

EFFECTIVE_SUPPORT_THRESHOLD: float = 5e-4
"""Value considered roughly zero for filter support computations.

No function is compactly supported in both the time and Fourier domains, but
large regions of either domain can be very close to zero. This threshold
defines "effectively zero" when deriving finite supports of analytically
infinite filters (reference: config.py:43).
"""

LOG_FLOOR_VALUE: float = 1e-5
"""Floor applied before taking logarithms in feature computations
(reference: config.py:52)."""

VALID_FFT_MODES = ("auto", "fft", "matmul", "pallas")

SI_DIGIT_PARAM_BYTE_LIMIT: int = 1 << 29  # 512 MiB
"""Construction-time ceiling on the SI digit tiers' parameter planes.

The SI ``precision='double'``/``'accurate'`` tiers store banded-Toeplitz
convolution matrices as integer digit planes whose size scales with the
squared filter support (``n_digits * parts * (K + 1) * num_filts * V * V``
float32s, ``K = ceil((max_support - 1) / V)``).  Gammatone/gabor-class
supports (hundreds of taps) cost 100-150 MiB; fbank-class SI supports
(~7000 taps) cost ~700-850 MiB of parameter planes alone, and several
times that again in live product buffers at production batch sizes.
Constructors estimate the parameter bytes up front and raise a
descriptive ``ValueError`` above this limit; raise it (or set it to 0 to
disable the guard) if the device really has the memory.
"""

FFT_MODE: str = "auto"
"""How computers realise the DFT on the device.

- ``"fft"``: ``torch.fft.rfft``.
- ``"matmul"``: windowed DFT as two real matrix products against
  precomputed cosine/sine matrices.
- ``"pallas"``: the fused hand-written CUDA kernels (framing + DFT +
  filter reduction in one kernel).  The name is the JAX package's, kept so
  that configurations carry over.
- ``"auto"``: pick per DFT size and precision tier.

A runtime-mutable global selecting the implementation, which must not
change results beyond numerical noise (reference: config.py:27-41).
"""

# Optional soundfile probing, mirroring reference config.py:56-85: the
# dispatch of speech_tpu_torch.io honours it where soundfile is importable.
_BASE_SOUNDFILE_SUPPORTED_TYPES = {"wav", "ogg", "flac", "aiff"}
_FULL_SOUNDFILE_SUPPORTED_TYPES: Set[str] = set()

SOUNDFILE_SUPPORTED_FILE_TYPES: Set[str] = set()
"""File suffixes delegated to :mod:`soundfile` when it is importable
(reference: config.py:61-85)."""

try:  # pragma: no cover - soundfile is an optional backend
    import soundfile as _sf

    _FULL_SOUNDFILE_SUPPORTED_TYPES = set(x.lower() for x in _sf.available_formats())
    SOUNDFILE_SUPPORTED_FILE_TYPES = (
        _BASE_SOUNDFILE_SUPPORTED_TYPES & _FULL_SOUNDFILE_SUPPORTED_TYPES
    )
except ImportError:
    pass
