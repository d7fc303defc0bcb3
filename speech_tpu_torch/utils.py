"""Host-side math helpers that :mod:`speech_tpu_torch.filters` needs
(reference: src/pydrobert/speech/util.py:55-70)."""

__all__ = ["angular_to_hertz", "hertz_to_angular"]

import numpy as np


def hertz_to_angular(hertz, samp_rate):
    """Convert cycles/sec to radians/sec."""
    return hertz * 2 * np.pi / samp_rate


def angular_to_hertz(angle, samp_rate):
    """Convert radians/sec to cycles/sec."""
    return angle * samp_rate / (2 * np.pi)
