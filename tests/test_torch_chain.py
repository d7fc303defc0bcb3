"""The full feature chain of bench.py:514-539 through the port against the
JAX package: dither + preemphasis, the fbank computer, deltas of order 2,
local standardization and stacking by 3, on 2 x 1 s."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu import pre as jpre
from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.ops import postops as jpost

from speech_tpu_torch import pre as tpre
from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops import postops as tpost

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
MAIN = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True)
BATCH, N = 2, 16000
# float64 end to end: the computers agree to ~1e-12 (reduction order) and
# standardization divides by per-coefficient deviations of order 0.1-10
TOL_F64 = 1e-9
# the port's float32 'double' tier against JAX in float64: features within
# the tier's 1e-5 class, then float32 post-processing (standardization's
# E[x^2] - E[x]^2 cancels), all scaled by 1/std of each coefficient
TOL_DOUBLE = 1e-4


def _signals(seed):
    """Unit noise under a 3 Hz envelope (a ~26 dB swing, as syllables give
    speech), and noise of the chain's dither size (0.1) to add to it."""
    rng = np.random.RandomState(seed)
    envelope = 0.05 + np.abs(np.sin(2 * np.pi * 3.0 * np.arange(N) / 16000))
    return rng.randn(BATCH, N) * envelope, rng.randn(BATCH, N) * 0.1


def _jax_chain(signals, noise):
    computer = JaxSTFT(dict(BANK), dtype="float64", **MAIN)
    key = jax.random.PRNGKey(0)
    sigs = jpre.preemphasize(jpre.dither(key, jnp.asarray(signals), 0.0) + noise)
    feats, _ = computer.compute_batch(np.asarray(sigs), np.full(BATCH, N))
    feats = jpost.deltas(jnp.asarray(feats), jpost.delta_filters(2))
    feats = jpost.standardize(feats)
    return np.asarray(jpost.stack(feats, 3, pad=True))


def _port_chain(signals, noise, **kw):
    computer = STFTFrameComputer(dict(BANK), device="cpu", **{**MAIN, **kw})
    x = torch.tensor(signals, dtype=computer._dtype)
    gen = torch.Generator().manual_seed(0)
    sigs = tpre.preemphasize(tpre.dither(gen, x, 0.0) + torch.tensor(noise, dtype=x.dtype))
    feats, counts = computer.compute_batch(sigs, np.full(BATCH, N))
    assert counts.tolist() == [100] * BATCH
    feats = tpost.deltas(feats, tpost.delta_filters(2))
    feats = tpost.standardize(feats)
    return tpost.stack(feats, 3, pad=True)


@pytest.mark.parametrize("noisy", [False, True], ids=["no-dither", "same-noise"])
def test_chain_matches_jax_float64(noisy):
    signals, noise = _signals(30)
    if not noisy:
        noise = np.zeros_like(noise)
    want = _jax_chain(signals, noise)
    got = _port_chain(signals, noise, dtype="float64")
    assert got.shape == want.shape == (BATCH, 34, 369)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= TOL_F64


def test_chain_double_tier_float32():
    """The chain with the port's exact digit tier in float32 (the
    configuration chip_smoke.py drives on the card) against float64."""
    signals, noise = _signals(31)
    want = _jax_chain(signals, noise)
    got = _port_chain(signals, noise, dtype="float32", precision="double")
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert np.abs(got.numpy() - want).max() <= TOL_DOUBLE
