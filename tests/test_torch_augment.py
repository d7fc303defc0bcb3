"""speech_tpu_torch's augmentations (ops/augment.py) against speech_tpu's.

The draws of ``jax.random`` and of a ``torch.Generator`` differ, so the
deterministic step of each random op (draws to masks, offsets and gains)
is fed JAX's own draws and compared with JAX's output; the random forms
are held to the reference tests' contracts.  The deterministic ops are
compared at the reference tests' tolerances (tests/test_augment.py)."""

import numpy as np
import pytest
import torch

import jax

from speech_tpu.ops import augment as JA

from speech_tpu_torch.ops import augment as TA
from speech_tpu_torch.ops import resample as TR

KEY = jax.random.PRNGKey(20260818)


def _np(t):
    return np.asarray(t.detach().cpu()) if torch.is_tensor(t) else np.asarray(t)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def feats():
    return np.random.RandomState(3).randn(4, 200, 80)


def _jax_axis_draws(key, shape, max_width):
    """The draws JAX's ``_axis_mask`` takes from ``key``."""
    kw, ks = jax.random.split(key)
    width = jax.random.uniform(kw, shape, maxval=float(max_width))
    return torch.tensor(np.asarray(width)), torch.tensor(np.asarray(jax.random.uniform(ks, shape)))


@pytest.mark.parametrize("mask_value", [0.0, -3.5, "mean"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_spec_augment_given_jax_draws_equals_jax(feats, mask_value, with_lengths):
    lengths = np.array([200, 120, 40, 7]) if with_lengths else None
    kw = dict(num_freq_masks=2, freq_mask_param=27, num_time_masks=3, time_mask_param=60)
    want = np.asarray(JA.spec_augment(KEY, feats, lengths=lengths, mask_value=mask_value, **kw))
    kf, kt = jax.random.split(KEY)
    freq = _jax_axis_draws(kf, (4, 2), 27)
    time = _jax_axis_draws(kt, (4, 3), 60)
    got = _np(TA._spec_augment_from_draws(torch.tensor(feats), freq, time, lengths, mask_value))
    assert np.array_equal(got != feats, want != feats)
    if mask_value == "mean":
        # a float64 mean, summed in another order than XLA's
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    else:
        assert np.array_equal(got, want)


def test_spec_augment_basic_contract(feats):
    out = _np(TA.spec_augment(_gen(), feats, device="cpu"))
    assert out.shape == feats.shape
    changed = out != feats
    assert changed.any()
    assert np.array_equal(out[~changed], feats[~changed])
    assert (out[changed] == 0.0).all()
    per = changed[0]
    recon = per.all(axis=1)[:, None] | per.all(axis=0)[None, :]
    assert np.array_equal(per, recon)
    # each batch element draws its own masks
    patterns = [out[i] == 0.0 for i in range(feats.shape[0])]
    assert any(not np.array_equal(patterns[0], p) for p in patterns[1:])


def test_spec_augment_deterministic_and_generator_dependent(feats):
    x = torch.tensor(feats)
    a = TA.spec_augment(_gen(1), x)
    assert torch.equal(a, TA.spec_augment(_gen(1), x))
    assert not torch.equal(a, TA.spec_augment(_gen(2), x))


def test_spec_augment_lengths_and_mean_fill(feats):
    lengths = np.array([200, 120, 40, 7])
    out = _np(TA.spec_augment(_gen(3), feats, lengths=lengths, device="cpu"))
    for i, n in enumerate(lengths):
        assert np.array_equal(out[i, n:], feats[i, n:])
        assert (out[i, :n] == 0.0).any()
    out = _np(TA.spec_augment(_gen(3), feats, lengths=lengths, mask_value="mean", device="cpu"))
    changed = out != feats
    for i, n in enumerate(lengths):
        got = out[i][changed[i]]
        assert got.size and np.allclose(got, feats[i, :n].mean())
    with pytest.raises(ValueError, match="mask_value"):
        TA.spec_augment(_gen(), feats, mask_value="median", device="cpu")


def test_spec_augment_identity_axes_and_widths(feats):
    x = torch.tensor(feats)
    assert torch.equal(TA.spec_augment(_gen(), x, num_freq_masks=0, num_time_masks=0), x)
    direct = TA.spec_augment(_gen(4), x)
    swapped = TA.spec_augment(_gen(4), x.transpose(1, 2), time_axis=-1, feat_axis=-2)
    assert torch.equal(swapped.transpose(1, 2), direct)
    with pytest.raises(ValueError, match="axes"):
        TA.spec_augment(_gen(), x, time_axis=1, feat_axis=1)
    out = _np(TA.spec_augment(_gen(5), x, num_freq_masks=1, freq_mask_param=5,
                              num_time_masks=1, time_mask_param=9))
    changed = out == 0.0
    for i in range(feats.shape[0]):
        assert changed[i].all(axis=1).sum() <= 9
        assert changed[i].all(axis=0).sum() <= 5


def _rir(rng, W=2000, delay=170):
    rir = rng.randn(W) * np.exp(-np.arange(W) / (W / 6.0)) * 0.05
    rir[delay] = 1.0
    return rir


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("power_norm", [True, False])
def test_reverberate_matches_jax(align, power_norm):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4000)
    rir = _rir(rng)
    want = np.asarray(JA.reverberate(x, rir, align=align, power_norm=power_norm))
    got = _np(TA.reverberate(x, rir, align=align, power_norm=power_norm, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_reverberate_long_rir_and_padded_batch():
    rng = np.random.RandomState(8)
    rir = _rir(rng, W=8000, delay=300)
    lengths = np.array([4000, 2500, 1])
    x = rng.randn(3, 4096) * (np.arange(4096) < lengths[:, None])
    want = np.asarray(JA.reverberate(x, rir, lengths=lengths))
    got = _np(TA.reverberate(torch.tensor(x), rir, lengths=lengths))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    for i, n in enumerate(lengths):
        solo = _np(TA.reverberate(x[i, :n], rir, device="cpu"))
        np.testing.assert_allclose(got[i, :n], solo, rtol=1e-9, atol=1e-12)
        assert (got[i, n:] == 0).all()
    with pytest.raises(ValueError, match="rir"):
        TA.reverberate(x, np.ones((2, 2)), device="cpu")


def test_mix_noise_given_jax_offsets_equals_jax():
    rng = np.random.RandomState(12)
    x = rng.randn(4, 2000) * 1e-3
    key = jax.random.PRNGKey(0)
    for buf in (rng.randn(16000), rng.randn(700)):
        want = np.asarray(JA.mix_noise(key, x, buf, 0.0))
        tiled = np.tile(buf, -(-2000 // buf.size)) if buf.size < 2000 else buf
        offsets = np.asarray(jax.random.randint(key, (4,), 0, tiled.size))
        got = _np(TA._mix_noise_at(torch.tensor(x), torch.tensor(buf), torch.tensor(offsets),
                                   0.0, None))
        # the same windows; the scale's float64 sums in another order than
        # XLA's (the tolerance stands for cancellation at 1e-3 signals)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-18)


def test_mix_noise_snr_lengths_and_solo():
    rng = np.random.RandomState(11)
    lengths = np.array([8000, 5000, 1000])
    x = rng.randn(3, 8000) * (np.arange(8000) < lengths[:, None])
    snrs = np.array([5.0, 15.0, 25.0])
    noise = rng.randn(3, 8000)
    want = np.asarray(JA.mix_noise(None, x, noise, snrs, lengths=lengths))
    noisy = _np(TA.mix_noise(None, x, noise, snrs, lengths=lengths, device="cpu"))
    np.testing.assert_allclose(noisy, want, rtol=1e-12, atol=1e-15)
    for i, (n, s) in enumerate(zip(lengths, snrs)):
        added = noisy[i, :n] - x[i, :n]
        meas = 10 * np.log10((x[i, :n] ** 2).sum() / (added ** 2).sum())
        np.testing.assert_allclose(meas, s, atol=1e-8)
        assert (noisy[i, n:] == 0).all()
        solo = _np(TA.mix_noise(None, x[i, :n], noise[i, :n], s, device="cpu"))
        np.testing.assert_allclose(noisy[i, :n], solo, rtol=1e-12, atol=0)
    for snr in (0.0, 10.0, 20.0):
        out = _np(TA.mix_noise(_gen(int(snr)), x[:, :1000] + 0.1, noise[0], snr, device="cpu"))
        added = out - (x[:, :1000] + 0.1)
        meas = 10 * np.log10(((x[:, :1000] + 0.1) ** 2).sum(-1) / (added ** 2).sum(-1))
        np.testing.assert_allclose(meas, snr, atol=1e-8)
    zero = _np(TA.mix_noise(None, x, np.zeros(8000), 10.0, device="cpu"))
    np.testing.assert_array_equal(zero, x)


def test_mix_noise_random_offsets():
    rng = np.random.RandomState(12)
    x = rng.randn(4, 2000) * 1e-3
    noise = rng.randn(16000)
    a = TA.mix_noise(_gen(9), x, noise, 0.0, device="cpu")
    assert torch.equal(a, TA.mix_noise(_gen(9), x, noise, 0.0, device="cpu"))
    w = _np(a) - x
    assert not np.allclose(w[0], w[1])
    short = _np(TA.mix_noise(_gen(9), x, noise[:700], 0.0, device="cpu"))
    assert short.shape == x.shape and np.isfinite(short).all()


def test_speed_perturb_matches_jax_and_lengths():
    rng = np.random.RandomState(14)
    N = 6400
    x = rng.randn(2, N)
    for factor, up, down in [(1.1, 10, 11), (0.9, 10, 9), (1.0, 1, 1)]:
        out = TA.speed_perturb(x, factor, device="cpu")
        assert torch.equal(out, TR.resample(x, up, down, device="cpu"))
        np.testing.assert_allclose(_np(out), np.asarray(JA.speed_perturb(x, factor)),
                                   rtol=1e-12, atol=1e-15)
        assert out.shape[-1] == -(-N * up // down)
    lengths = np.array([6400, 3001])
    x2 = x * (np.arange(N) < lengths[:, None])
    out, new_lengths = TA.speed_perturb(x2, 1.1, lengths=lengths, device="cpu")
    want, want_lengths = JA.speed_perturb(x2, 1.1, lengths=lengths)
    np.testing.assert_array_equal(_np(new_lengths), np.asarray(want_lengths))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-12, atol=1e-15)
    for i, (n, nl) in enumerate(zip(lengths, _np(new_lengths))):
        solo = _np(TA.speed_perturb(x2[i, :n], 1.1, device="cpu"))
        np.testing.assert_allclose(_np(out)[i, :nl], solo[:nl], rtol=1e-12, atol=1e-15)
        assert (_np(out)[i, nl:] == 0).all()
    with pytest.raises(ValueError, match="positive"):
        TA.speed_perturb(x, -1.0, device="cpu")


def test_random_gain_given_jax_draws_equals_jax():
    x = np.random.RandomState(15).randn(64, 100)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JA.random_gain(key, x, -6.0, 6.0))
    db = np.asarray(jax.random.uniform(key, (64,), minval=-6.0, maxval=6.0, dtype=x.dtype))
    got = _np(TA._gain_from_db(torch.tensor(x), torch.tensor(db)))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_random_gain_range_and_independence():
    x = np.random.RandomState(15).randn(64, 100)
    out = _np(TA.random_gain(_gen(3), x, -6.0, 6.0, device="cpu"))
    g = out[:, 0] / x[:, 0]
    db = 20 * np.log10(np.abs(g))
    assert (db >= -6.0 - 1e-6).all() and (db <= 6.0 + 1e-6).all()
    assert len(np.unique(np.round(db, 6))) > 32
    np.testing.assert_allclose(out / x, np.broadcast_to(g[:, None], x.shape), rtol=1e-12)
    again = _np(TA.random_gain(_gen(3), x, -6.0, 6.0, device="cpu"))
    assert np.array_equal(out, again)
