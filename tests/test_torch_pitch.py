"""speech_tpu_torch's pitch tracker (ops/pitch.py) against speech_tpu's on
the same signals, in float64 on the CPU: host tables bit-equal, the
Viterbi lag path equal on every frame, f0 within rtol 1e-9, the NCCF and
the pitch features within 1e-8."""

import os

import numpy as np
import pytest
import torch

from speech_tpu.io import read_signal
from speech_tpu.ops import pitch as JP

from speech_tpu_torch.ops import pitch as TP

RATE = 16000
RTOL_F0 = 1e-9
TOL = 1e-8
WAV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "audio", "test.wav")


def _harmonic(f0, seconds=1.0, rate=RATE, noise=0.01, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    sig = sum((0.6 / k) * np.sin(2 * np.pi * f0 * k * t + 0.3 * k) for k in (1, 2, 3))
    return sig + noise * rng.randn(t.size)


def _chirp():
    t = np.arange(RATE) / RATE
    return np.sin(2 * np.pi * (100 * t + 50 * t ** 2))


def _speech():
    x = read_signal(WAV, dtype=np.float64)[RATE // 2 : RATE // 2 + RATE]
    return x / np.abs(x).max()


SIGNALS = {
    "tones": lambda: np.stack([_harmonic(f, seed=i) for i, f in enumerate((120.0, 220.0, 330.0))]),
    "chirp": _chirp,
    "noise": lambda: 0.1 * np.random.RandomState(3).randn(RATE),
    "speech": _speech,
}


def _np(t):
    return np.asarray(t.detach().cpu()) if torch.is_tensor(t) else np.asarray(t)


def _tracks(monkeypatch, x, **kw):
    """Both trackers on ``x``, each with its Viterbi path captured."""
    paths = {}

    def capture(module, key):
        refine = module._refine_lags

        def wrapped(path, *args):
            paths[key] = _np(path)
            return refine(path, *args)

        monkeypatch.setattr(module, "_refine_lags", wrapped)

    capture(JP, "jax")
    capture(TP, "torch")
    want = JP.kaldi_pitch(x, RATE, **kw)
    got = TP.kaldi_pitch(x, RATE, device="cpu", **kw)
    return want, got, paths


def _check_tracks(want, got, paths):
    assert np.array_equal(paths["jax"], paths["torch"].reshape(paths["jax"].shape))
    assert got.f0.dtype == torch.float64
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    np.testing.assert_allclose(_np(got.f0), _np(want.f0), rtol=RTOL_F0, atol=0)
    np.testing.assert_allclose(_np(got.nccf), _np(want.nccf), rtol=0, atol=TOL)


@pytest.mark.parametrize(
    "args",
    [
        (16000.0, 50.0, 400.0, 25.0, 10.0, 4000.0, 0.1, 0.01),
        (8000.0, 60.0, 500.0, 30.0, 12.5, None, 0.2, 0.02),
        (22050.0, 70.0, 350.0, 25.0, 10.0, 8000.0, 0.05, 0.005),
    ],
)
def test_host_tables_bit_equal(args):
    got = TP._work_geometry(*args)
    want = JP._work_geometry(*args)
    assert got[:5] == want[:5]
    for a, b in zip(got[5], want[5]):
        assert np.array_equal(a, b)
    fine = got[5][2]
    assert np.array_equal(
        TP._soft_discount(fine, got[0], 10.0), JP._soft_discount(fine, got[0], 10.0)
    )
    x = np.linspace(-9.0, 9.0, 37)
    assert np.array_equal(TP._kaiser_at(x, 8), JP._kaiser_at(x, 8))
    assert np.array_equal(TP._lowpass_fir(got[0], 1000.0), JP._lowpass_fir(got[0], 1000.0))
    with pytest.raises(ValueError, match="min_f0"):
        TP._lag_tables(4000.0, 500.0, 400.0, 0.1, 0.01)
    with pytest.raises(ValueError, match="resolution"):
        TP._lag_tables(4000.0, 50.0, 400.0, 0.1, 1.5)


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_track_and_feats_match_jax(monkeypatch, name):
    x = SIGNALS[name]()
    want, got, paths = _tracks(monkeypatch, x)
    _check_tracks(want, got, paths)
    feats = TP.pitch_feats_from_track(got)
    ref = JP.pitch_feats_from_track(want)
    np.testing.assert_allclose(_np(feats), _np(ref), rtol=0, atol=TOL)


def test_ragged_batch_matches_jax_and_solo(monkeypatch):
    sig = _harmonic(180.0)
    batch = np.stack([sig, np.pad(sig[:8000], (0, 8000)), np.pad(_chirp()[:11000], (0, 5000))])
    lengths = np.array([16000, 8000, 11000])
    want, got, paths = _tracks(monkeypatch, batch, lengths=lengths)
    _check_tracks(want, got, paths)
    feats, counts = TP.pitch_feats(batch, RATE, lengths=lengths, return_valid=True,
                                   device="cpu")
    ref, ref_counts = JP.pitch_feats(batch, RATE, lengths=lengths, return_valid=True)
    np.testing.assert_array_equal(_np(counts), _np(ref_counts))
    np.testing.assert_allclose(_np(feats), _np(ref), rtol=0, atol=TOL)
    # each row equals its solo call on its valid extent
    solo = TP.kaldi_pitch(sig[:8000], RATE, device="cpu")
    nv = int(solo.valid.sum())
    assert int(got.valid[1].sum()) == nv and not got.valid[1, nv:].any()
    np.testing.assert_allclose(_np(got.f0[1, :nv]), _np(solo.f0[:nv]), rtol=1e-12)
    assert np.all(_np(feats)[1, nv:] == 0.0)


def test_options_match_jax(monkeypatch):
    """No resampling and no lowpass, a fixed ballast, other penalties."""
    x = _harmonic(150.0, seconds=0.6, rate=RATE)[None]
    kw = dict(resample_rate=None, lowpass_cutoff=None, ballast_ms=0.05, min_f0=80.0,
              max_f0=300.0, penalty_factor=0.3, soft_min_f0=5.0, lag_resolution=0.02)
    want, got, paths = _tracks(monkeypatch, x, **kw)
    _check_tracks(want, got, paths)
    assert got.f0.shape == want.f0.shape == (1, got.f0.shape[-1])


def test_nccf_from_frames_with_per_row_ballast():
    tables = JP._work_geometry(4000.0, 50.0, 400.0, 25.0, 10.0, None, 0.1, 0.01)[5]
    span = TP._nccf_span(100, tables)
    frames = np.random.RandomState(7).randn(2, 5, span)
    ballast = np.array([0.5, 3.0])
    got = TP._nccf_from_frames(torch.tensor(frames), 100, tables, torch.tensor(ballast))
    for row in range(2):
        want = JP._nccf_from_frames(frames[row], 100, tables, ballast[row])
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g[row]), _np(w), rtol=0, atol=1e-12)


def test_pov_and_float32():
    a = np.linspace(-1.0, 1.0, 41)
    np.testing.assert_allclose(_np(TP.nccf_to_pov(torch.tensor(a))), _np(JP.nccf_to_pov(a)),
                               rtol=0, atol=1e-15)
    x = _harmonic(200.0, seconds=0.5).astype(np.float32)
    got = TP.kaldi_pitch(x, RATE, device="cpu")
    assert got.f0.dtype == torch.float32
    # the float64 port is the JAX package's to rtol 1e-9 (above)
    want = _np(TP.kaldi_pitch(x.astype(np.float64), RATE, device="cpu").f0)
    assert np.abs(_np(got.f0) - want).max() < 1e-3 * want.max()
    pcm = np.round(x * 20000).astype(np.int16)
    assert TP.kaldi_pitch(pcm, RATE, device="cpu").f0.dtype == torch.float32


def test_validation_errors(monkeypatch):
    with pytest.raises(ValueError, match="min_f0"):
        TP.kaldi_pitch(np.zeros(8000, np.float32), RATE, min_f0=500, max_f0=400, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        TP.kaldi_pitch(np.zeros(200, np.float32), RATE, device="cpu")
    with pytest.raises(ValueError, match="lengths shape"):
        TP.kaldi_pitch(np.zeros((2, 8000)), RATE, lengths=np.array([1, 2, 3]), device="cpu")
    with pytest.raises(ValueError, match="normalization_window"):
        TP.pitch_feats(np.zeros(8000), RATE, normalization_window=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.kaldi_pitch(np.zeros(8000), RATE)
