"""speech_tpu_torch's feature inversion (ops/invert.py) against
speech_tpu's on the same inputs (float64 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_tpu.compute import ShortTimeFourierTransformFrameComputer
from speech_tpu.filters import Fbank, HannWindow
from speech_tpu.ops import invert as JI
from speech_tpu.ops import stft as JS

from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops import invert as TI

TOL = 1e-8


def _np(t):
    return np.asarray(t.detach().cpu()) if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("T,L,S", [(7, 8, 4), (5, 10, 3), (4, 6, 6), (3, 5, 7), (1, 9, 2)])
def test_overlap_add_matches_jax(T, L, S):
    frames = np.random.RandomState(T * 100 + L * 10 + S).randn(2, T, L)
    for length in (None, 3, (T - 1) * S + L + 5):
        want = np.asarray(JI.overlap_add(jnp.asarray(frames), S, length=length))
        got = _np(TI.overlap_add(frames, S, length=length, device="cpu"))
        assert got.shape == want.shape
        assert np.allclose(got, want, atol=1e-12)
    with pytest.raises(ValueError, match="frame_shift"):
        TI.overlap_add(frames, 0, device="cpu")


@pytest.mark.parametrize("L,S,dft", [(32, 16, 32), (25, 10, 32), (40, 17, 64)])
def test_istft_matches_jax(L, S, dft):
    rng = np.random.RandomState(1234)
    T = 20
    x = rng.randn(2, (T - 1) * S + L)
    window = HannWindow().get_impulse_response(L)
    C, Smat = JS.windowed_dft_matrices(window, dft)
    frames = np.stack([[x[b, t * S : t * S + L] for t in range(T)] for b in range(2)])
    re, im = frames @ C, frames @ Smat
    want = np.asarray(JI.istft(jnp.asarray(re), jnp.asarray(im), window, S, dft_size=dft))
    got = _np(TI.istft(re, im, window, S, dft_size=dft, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    IC, IS = TI.synthesis_matrices(window, dft)
    jc, js = JI.synthesis_matrices(window, dft)
    assert np.array_equal(IC, jc) and np.array_equal(IS, js)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_griffin_lim_matches_jax(with_lengths):
    window = np.asarray(HannWindow().get_impulse_response(64), np.float64)
    mag = np.abs(np.random.RandomState(8).randn(3, 12, 33)) + 0.1
    lengths = np.array([12, 7, 1]) if with_lengths else None
    kw = dict(dft_size=64, n_iters=5, lengths=lengths)
    want = np.asarray(JI.griffin_lim(mag, window, 16, **kw))
    got = _np(TI.griffin_lim(mag, window, 16, device="cpu", **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for momentum, length in ((0.0, 100), (0.5, 300)):
        kw = dict(dft_size=64, n_iters=3, momentum=momentum, length=length)
        want = np.asarray(JI.griffin_lim(mag[0], window, 16, **kw))
        got = _np(TI.griffin_lim(torch.tensor(mag[0]), window, 16, **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bank_pseudo_inverse_bit_equal():
    for rate, nf in ((16000, 80), (8000, 20)):
        W = JS.fold_bank_to_weights(Fbank(num_filts=nf, sampling_rate=rate), 512, use_power=True)
        for ridge in (1e-8, 1e-3):
            assert np.array_equal(TI.bank_pseudo_inverse(W, ridge), JI.bank_pseudo_inverse(W, ridge))


def _computers(num_filts, **kw):
    jc = ShortTimeFourierTransformFrameComputer(
        Fbank(num_filts=num_filts, sampling_rate=8000), frame_length_ms=25,
        frame_shift_ms=10, **kw,
    )
    tc = STFTFrameComputer(
        {"name": "fbank", "num_filts": num_filts, "sampling_rate": 8000},
        frame_length_ms=25, frame_shift_ms=10, device="cpu", dtype="float64", **kw,
    )
    return jc, tc


@pytest.mark.parametrize("include_energy", [False, True])
def test_feats_to_signal_matches_jax(include_energy):
    jc, tc = _computers(20, include_energy=include_energy)
    rng = np.random.RandomState(3)
    xs = rng.randn(2, 4000)
    feats = np.stack([np.asarray(jc.compute_full(x)) for x in xs])
    want = np.asarray(JI.feats_to_signal(jnp.asarray(feats), jc, n_iters=4, length=4000))
    got = _np(TI.feats_to_signal(feats, tc, n_iters=4, length=4000))
    assert got.shape == want.shape == xs.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_feats_to_signal_ragged_matches_jax_and_solo():
    jc, tc = _computers(20)
    rng = np.random.RandomState(5)
    rows = [np.asarray(jc.compute_full(rng.randn(n))) for n in (4000, 2666)]
    counts = np.array([r.shape[0] for r in rows])
    batch = np.stack([np.pad(r, ((0, counts.max() - r.shape[0]), (0, 0))) for r in rows])
    length = int(counts.max() * tc.frame_shift)
    want = np.asarray(JI.feats_to_signal(jnp.asarray(batch), jc, n_iters=4, length=length,
                                         lengths=jnp.asarray(counts)))
    got = _np(TI.feats_to_signal(torch.tensor(batch), tc, n_iters=4, length=length,
                                 lengths=counts))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for i, r in enumerate(rows):
        solo = _np(TI.feats_to_signal(torch.tensor(r), tc, n_iters=4,
                                      length=int(counts[i]) * tc.frame_shift))
        assert np.allclose(got[i, : solo.shape[-1]], solo, atol=1e-10), i
        tail = got[i, (counts[i] - 1) * tc.frame_shift + tc.frame_length :]
        assert tail.size == 0 or np.abs(tail).max() == 0.0


def test_feats_to_signal_roundtrip_float32():
    """The envelope contract of the reference test (features of the
    inverted signal near the originals), on the float32 port."""
    _, tc = _computers(40)
    tc32 = STFTFrameComputer({"name": "fbank", "num_filts": 40, "sampling_rate": 8000},
                             frame_length_ms=25, frame_shift_ms=10, device="cpu")
    t = np.arange(8000) / 8000
    x = np.sin(2 * np.pi * 300 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    x += 0.02 * np.random.RandomState(1).randn(8000)
    feats = tc32.compute_full(x.astype(np.float32))
    y = _np(TI.feats_to_signal(feats, tc32, n_iters=40, length=len(x)))
    assert y.dtype == np.float32 and y.shape == x.shape
    feats2 = tc.compute_full(y.astype(np.float64))
    err = np.mean((feats2 - feats) ** 2) / np.var(feats)
    assert err < 0.12
