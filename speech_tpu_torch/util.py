"""Drop-in alias for the reference's ``util`` module name.

The reference puts its grab-bag helpers in ``pydrobert.speech.util``
(reference: src/pydrobert/speech/util.py); this package splits them into
:mod:`speech_tpu_torch.utils` (math helpers) and
:mod:`speech_tpu_torch.io` (signal reading).  ``import
speech_tpu_torch.util`` keeps reference code working unchanged: every
public name of the reference module resolves here.
"""

from .alias import alias_factory_subclass_from_arg  # noqa: F401
from .io import read_signal, wds_read_signal  # noqa: F401
from .utils import (  # noqa: F401
    angular_to_hertz,
    circshift_fourier,
    gauss_quant,
    hertz_to_angular,
)

__all__ = [
    "alias_factory_subclass_from_arg",
    "angular_to_hertz",
    "circshift_fourier",
    "gauss_quant",
    "hertz_to_angular",
    "read_signal",
    "wds_read_signal",
]
