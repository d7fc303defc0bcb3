"""Named feature-extraction recipes.

The counterpart of :mod:`speech_tpu.models.presets`; the table is a copy.

The reference ships one worked config (``tests/data/fbank.json``) and
leaves every pipeline to be assembled by hand.  Here the standard recipes
are first-class: ``preset_config(name)`` returns the plain JSON-able
config dict (so presets flow through the same alias-factory contract as
hand-written configs; reference: alias.py:72-100), and ``create(name)``
builds the computer.  The CLI accepts a preset name anywhere it accepts a
computer config.

Naming: ``<family>-<num_filts>-<rate>``, e.g. ``fbank-80-16k``.
"""

from typing import Any, Dict

from ..alias import alias_factory_subclass_from_arg
from ..compute import FrameComputer

__all__ = ["PRESETS", "preset_config", "create"]


def _stft(bank: dict, **kw) -> dict:
    cfg = {
        "name": "stft",
        "bank": bank,
        "frame_length_ms": 25,
        "frame_shift_ms": 10,
        "frame_style": "centered",
        "use_log": True,
        "use_power": True,
        "pad_to_nearest_power_of_two": True,
    }
    cfg.update(kw)
    return cfg


def _fbank(num_filts: int, rate: int) -> dict:
    return {
        "name": "fbank",
        "num_filts": num_filts,
        "low_hz": 20,
        "high_hz": rate // 2,
        "sampling_rate": rate,
        "analytic": False,
    }


PRESETS: Dict[str, dict] = {
    # log-mel fbanks, this package's frame alignment
    "fbank-40-16k": _stft(_fbank(40, 16000)),
    "fbank-80-16k": _stft(_fbank(80, 16000)),
    "fbank-40-8k": _stft(_fbank(40, 8000)),
    # Kaldi-compatible alignment (kaldi_shift + Hann window; see
    # tests/data/kaldi.conf parity tests)
    "kaldi-fbank-40-16k": _stft(
        _fbank(40, 16000), kaldi_shift=True, window_function="hanning"
    ),
    "kaldi-fbank-80-16k": _stft(
        _fbank(80, 16000), kaldi_shift=True, window_function="hanning"
    ),
    # energy-augmented flagship (the headline benchmark config)
    "fbank-energy-41-16k": _stft(_fbank(40, 16000), include_energy=True),
    # auditory-model banks
    "gabor-40-16k": _stft(
        {
            "name": "gabor",
            "scaling_function": "mel",
            "num_filts": 40,
            "sampling_rate": 16000,
        }
    ),
    "gammatone-si-40-16k": {
        "name": "si",
        "bank": {
            "name": "gammatone",
            "scaling_function": "mel",
            "num_filts": 40,
            "sampling_rate": 16000,
        },
        "frame_shift_ms": 10,
        "use_log": True,
    },
    "gammatone-si-40-8k": {
        "name": "si",
        "bank": {
            "name": "gammatone",
            "scaling_function": "mel",
            "num_filts": 40,
            "sampling_rate": 8000,
        },
        "frame_shift_ms": 10,
        "use_log": True,
    },
}


def preset_config(name: str) -> dict:
    """A deep copy of the named preset's config dict."""
    import copy

    if name not in PRESETS:
        raise KeyError(
            f"unknown preset '{name}'; available: {sorted(PRESETS)}"
        )
    return copy.deepcopy(PRESETS[name])


def create(name: str, **overrides: Any) -> FrameComputer:
    """Build the named preset's computer; ``overrides`` update the
    top-level config (e.g. ``dtype='float64'``, ``precision='double'``,
    ``device='cpu'``; the computer runs on the GPU unless ``device`` names
    another)."""
    cfg = preset_config(name)
    cfg.update(overrides)
    return alias_factory_subclass_from_arg(FrameComputer, cfg)
