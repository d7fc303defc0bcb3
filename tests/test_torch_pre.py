"""speech_tpu_torch.pre against speech_tpu.pre: preemphasis and the host
classes equal in float64, dither checked statistically (torch's and JAX's
generators give different numbers) and for reproducibility."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speech_tpu.pre as jpre
from speech_tpu.alias import alias_factory_subclass_from_arg as j_factory

import speech_tpu_torch.pre as tpre
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as t_factory

TOL_F64 = 1e-12  # float64 elementwise: at most a rounding apart


@pytest.mark.parametrize("coeff", [0.97, 0.5, 0.0])
@pytest.mark.parametrize("shape", [(1000,), (3, 777)])
def test_preemphasize_matches_jax(shape, coeff):
    x = np.random.RandomState(1).randn(*shape)
    want = np.asarray(jpre.preemphasize(jnp.asarray(x), coeff))
    got = tpre.preemphasize(torch.tensor(x), coeff)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= TOL_F64
    assert got[..., 0].equal(torch.tensor(x)[..., 0])


def test_dither_statistics():
    """N(0, coeff^2) noise: mean and standard deviation within five
    standard errors over 200,000 draws; the signal passes through."""
    n, coeff = 200_000, 0.1
    x = torch.linspace(-1, 1, n, dtype=torch.float64)
    noise = tpre.dither(torch.Generator().manual_seed(3), x, coeff) - x
    assert abs(noise.mean().item()) < 5 * coeff / np.sqrt(n)
    assert abs(noise.std().item() - coeff) < 5 * coeff / np.sqrt(2 * n)
    jnoise = np.asarray(jpre.dither(jax.random.PRNGKey(3), jnp.zeros(n), coeff))
    assert abs(noise.std().item() - jnoise.std()) < 10 * coeff / np.sqrt(2 * n)


def test_dither_reproducible_per_generator_seed():
    x = torch.zeros(2, 500, dtype=torch.float32)
    a = tpre.dither(torch.Generator().manual_seed(7), x, 1.0)
    b = tpre.dither(torch.Generator().manual_seed(7), x, 1.0)
    c = tpre.dither(torch.Generator().manual_seed(8), x, 1.0)
    assert a.dtype == torch.float32 and a.equal(b) and not a.equal(c)
    assert tpre.dither(torch.Generator().manual_seed(7), x, 0.0).equal(x)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16])
def test_host_classes_match_jax(dtype):
    """The host ``apply`` of both packages draws from numpy's global RNG,
    so one seed gives equal results."""
    x = (np.random.RandomState(2).randn(4000) * 1000).astype(dtype)
    for name, kw in (("dither", {"coeff": 0.5}), ("preemph", {"coeff": 0.9})):
        jp = j_factory(jpre.PreProcessor, {"name": name, **kw})
        tp = t_factory(tpre.PreProcessor, {"name": name, **kw})
        assert type(tp).__name__ == type(jp).__name__
        np.random.seed(11)
        want = jp.apply(x.copy())
        np.random.seed(11)
        got = tp.apply(x.copy())
        assert got.dtype == x.dtype and np.array_equal(got, want)
    y = x.astype(np.float64)
    assert tpre.Preemphasize(0.9).apply(y, in_place=True) is y


def test_as_torch_forms():
    x = np.random.RandomState(4).randn(2, 300)
    pre = tpre.Preemphasize(0.95).as_torch()
    want = np.asarray(jpre.Preemphasize(0.95).as_jax()(jnp.asarray(x)))
    assert np.abs(pre(torch.tensor(x)).numpy() - want).max() <= TOL_F64
    dith = tpre.Dither(0.25).as_torch()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert dith(g1, torch.tensor(x)).equal(tpre.dither(g2, torch.tensor(x), 0.25))
