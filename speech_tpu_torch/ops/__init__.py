"""Device ops of the PyTorch port: framing, the plain STFT feature path and
the hand-written CUDA kernels beside it."""

from . import framing, stft, stft_kernels  # noqa: F401
