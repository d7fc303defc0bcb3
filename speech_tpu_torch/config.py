"""Package-wide constants and runtime flags.

The PyTorch counterpart of :mod:`speech_tpu.config` (the constants module
of ``pydrobert-speech``, reference: src/pydrobert/speech/config.py).  The
runtime switch selects how the short-time Fourier transform is realised on
the GPU: ``torch.fft.rfft``, a windowed DFT as two matrix products, or the
fused hand-written CUDA kernels of :mod:`speech_tpu_torch.ops.stft_kernels`.
"""

__all__ = [
    "EFFECTIVE_SUPPORT_THRESHOLD",
    "LOG_FLOOR_VALUE",
    "FFT_MODE",
    "VALID_FFT_MODES",
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
