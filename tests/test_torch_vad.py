"""speech_tpu_torch's energy VAD (ops/vad.py, post.VADTrim) against
speech_tpu's on the same log energies."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speech_tpu.post as jpost
from speech_tpu.ops import vad as JV

import speech_tpu_torch.post as tpost
from speech_tpu_torch.ops import vad as TV

SETTINGS = [
    {},
    dict(energy_threshold=4.0, energy_mean_scale=0.0),
    dict(frames_context=3, proportion_threshold=0.5),
    dict(energy_threshold=-1.0, energy_mean_scale=1.0, frames_context=1,
         proportion_threshold=0.3),
]
SETTING_IDS = ["kaldi", "fixed", "context3", "context1"]


def _log_energy(shape, seed=0):
    """Log energies of speech-like frames: loud runs between quiet ones."""
    rng = np.random.RandomState(seed)
    loud = np.sin(np.arange(shape[-1]) / 5.0) > 0
    return np.where(loud, 9.0, 2.0) + rng.randn(*shape)


@pytest.mark.parametrize("kw", SETTINGS, ids=SETTING_IDS)
def test_energy_vad_np_equal(kw):
    for n in (60, 7, 1, 0):
        e = _log_energy((n,), seed=n)
        assert np.array_equal(TV.energy_vad_np(e, **kw), JV.energy_vad_np(e, **kw))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("kw", SETTINGS, ids=SETTING_IDS)
def test_energy_vad_matches_jax(kw, ragged, dtype):
    e = _log_energy((3, 60), seed=1).astype(dtype)
    lengths = [60, 33, 1] if ragged else None
    want = np.asarray(JV.energy_vad(jnp.asarray(e), lengths=lengths, **kw))
    got = TV.energy_vad(torch.tensor(e), lengths=lengths, **kw)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    if not ragged:  # 1-D input and the host twin
        for row in range(3):
            one = TV.energy_vad(torch.tensor(e[row]), **kw)
            assert np.array_equal(one.numpy(), TV.energy_vad_np(e[row], **kw))


def test_energy_vad_validation():
    e = torch.zeros(5)
    for kw in (dict(frames_context=-1), dict(proportion_threshold=0.0),
               dict(proportion_threshold=1.0)):
        with pytest.raises(ValueError):
            TV.energy_vad(e, **kw)
        with pytest.raises(ValueError):
            TV.energy_vad_np(e.numpy(), **kw)
    with pytest.raises(ValueError, match="1-D"):
        TV.energy_vad_np(np.zeros((2, 3)))


@pytest.mark.parametrize("time_axis", [0, 1])
@pytest.mark.parametrize("kw", SETTINGS, ids=SETTING_IDS)
def test_post_vad_trim_matches_jax(kw, time_axis):
    feats = np.column_stack([_log_energy((50,), seed=2), np.random.RandomState(3).randn(50, 4)])
    if time_axis == 1:
        feats = feats.T.copy()
    axis = 1 - time_axis
    want = jpost.VADTrim(time_axis=time_axis, **kw).apply(feats, axis=axis)
    got = tpost.VADTrim(time_axis=time_axis, **kw).apply(feats, axis=axis)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert 0 < got.shape[time_axis] < 50


def test_post_vad_trim_guards():
    for kw in (dict(frames_context=-1), dict(proportion_threshold=1.5),
               dict(energy_mean_scale=-0.5)):
        with pytest.raises(ValueError):
            tpost.VADTrim(**kw)
    with pytest.raises(RuntimeError, match="time, features"):
        tpost.VADTrim().apply(np.zeros((2, 3, 4)))
    with pytest.raises(RuntimeError, match="same"):
        tpost.VADTrim().apply(np.zeros((5, 3)), axis=0)
