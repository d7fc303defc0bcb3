"""speech_tpu_torch's PLP (ops/plp.py, post.PLP and the PLP stage of
device_post_chain) against speech_tpu's on the same band powers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speech_tpu.post as jpost
from speech_tpu.ops import plp as JP
from speech_tpu.ops import postops as JPO

import speech_tpu_torch.post as tpost
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as t_factory
from speech_tpu_torch.ops import plp as TP
from speech_tpu_torch.ops import postops as TPO

TOL_F64 = 1e-10  # the same float64 arithmetic, sums in other orders
TOL_F32 = 1e-4  # float32 cepstra (a log and an order-12 recursion)
BANK = {"name": "fbank", "num_filts": 23, "sampling_rate": 16000}
CENTERS = tuple(np.linspace(120.0, 7000.0, 23))
SETTINGS = [
    {},
    dict(order=8, num_ceps=6, compress=0.5, lifter=0.0),
    dict(order=24, num_ceps=25, lifter=30.0, eps=1e-6),
]
SETTING_IDS = ["kaldi", "short", "long"]


def _power(shape, seed=0):
    """Positive band powers spanning several decades, a few zero frames."""
    rng = np.random.RandomState(seed)
    x = np.exp(rng.randn(*shape) * 2.0)
    x[..., :2, :] = 0.0
    return x


def test_host_builders_equal():
    assert np.array_equal(TP.equal_loudness(CENTERS), JP.equal_loudness(CENTERS))
    for bands, order in ((23, 12), (5, 6), (40, 24)):
        assert np.array_equal(
            TP.autocorr_idft_matrix(bands, order), JP.autocorr_idft_matrix(bands, order)
        )
    for num_ceps, lifter in ((13, 22.0), (6, 0.0), (25, 30.0)):
        assert np.array_equal(
            TP._lifter_weights(num_ceps, lifter), JP._lifter_weights(num_ceps, lifter)
        )


@pytest.mark.parametrize("kw", SETTINGS, ids=SETTING_IDS)
def test_plp_np_equal(kw):
    x = _power((2, 30, 23))
    assert np.array_equal(TP.plp_np(x, CENTERS, **kw), JP.plp_np(x, CENTERS, **kw))


@pytest.mark.parametrize("dtype,tol", [("float64", TOL_F64), ("float32", TOL_F32)])
@pytest.mark.parametrize("kw", SETTINGS, ids=SETTING_IDS)
def test_plp_matches_jax(kw, dtype, tol):
    x = _power((3, 25, 23), seed=1).astype(dtype)
    want = np.asarray(JP.plp(jnp.asarray(x), CENTERS, **kw))
    got = TP.plp(torch.tensor(x), CENTERS, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= tol


def test_plp_validation_matches_jax():
    x = _power((4, 23))
    bad = [
        dict(order=0), dict(num_ceps=1), dict(order=12, num_ceps=14),
        dict(order=30, num_ceps=13), dict(compress=0.0), dict(lifter=-1.0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            JP.plp_np(x, CENTERS, **kw)
        with pytest.raises(ValueError):
            TP.plp(torch.tensor(x), CENTERS, **kw)
        with pytest.raises(ValueError):
            TP.plp_np(x, CENTERS, **kw)
    with pytest.raises(ValueError, match="center_hz has"):
        TP.plp(torch.tensor(x), CENTERS[:-1])


@pytest.mark.parametrize("axis", [-1, 0])
def test_post_plp_matches_jax(axis):
    x = _power((30, 23), seed=2)
    if axis == 0:
        x = x.T.copy()
    for kw in ({"bank": dict(BANK)}, {"center_hz": CENTERS, "order": 10, "num_ceps": 8}):
        want = jpost.PLP(**kw).apply(x, axis=axis)
        got = t_factory(tpost.PostProcessor, {"name": "plp", **kw}).apply(x, axis=axis)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(RuntimeError, match="bands along axis"):
        tpost.PLP(center_hz=CENTERS).apply(x[:, :5] if axis else x[:5])
    with pytest.raises(ValueError, match="exactly one"):
        tpost.PLP()


def test_device_post_chain_plp_stage_matches_jax():
    """PLP then deltas through the device chain, on a ragged batch."""
    x = _power((3, 37, 23), seed=3)
    lengths = [37, 20, 1]
    jchain = [jpost.PLP(bank=dict(BANK)), jpost.Deltas(1)]
    tchain = [tpost.PLP(bank=dict(BANK)), tpost.Deltas(1)]
    jf, jn = JPO.device_post_chain(jchain)(jnp.asarray(x), np.asarray(lengths))
    tf, tn = TPO.device_post_chain(tchain)(torch.tensor(x), lengths)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tf.shape == np.asarray(jf).shape == (3, 37, 26)
    for row, n in enumerate(lengths):
        assert np.abs(tf[row, :n].numpy() - np.asarray(jf)[row, :n]).max() <= TOL_F64
