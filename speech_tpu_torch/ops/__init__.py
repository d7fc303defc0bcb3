"""Device ops of the PyTorch port: framing, the plain STFT feature path and
the hand-written CUDA kernels beside it, short integration, PLP and energy
VAD."""

from . import framing, plp, si, stft, stft_kernels, vad  # noqa: F401
