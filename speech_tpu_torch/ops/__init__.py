"""Device ops of the PyTorch port: framing, the plain STFT feature path and
the hand-written CUDA kernels beside it, short integration, PLP, energy
VAD, resampling, pitch, augmentation and feature inversion."""

from . import augment, framing, invert, pitch, plp, resample, si, stft, stft_kernels, vad, xmath  # noqa: F401
