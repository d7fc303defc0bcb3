"""The port's utils, util alias, xmath and top-level shim against the JAX
package's (tests/test_utils.py)."""

import os

import numpy as np
import pytest
import torch

import speech_tpu.util as jutil
import speech_tpu.utils as jutils
import speech_tpu_torch
import speech_tpu_torch.util as tutil
import speech_tpu_torch.utils as tutils
from speech_tpu.ops import xmath as jxmath
from speech_tpu_torch import aot
from speech_tpu_torch.ops import xmath as txmath

AUDIO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "audio")


@pytest.mark.parametrize("p", [1e-12, 0.01, 0.3, 0.5, 0.77, 0.999])
def test_gauss_quant_equals_jax(p):
    assert tutils.gauss_quant(p, 2.0, 3.0) == jutils.gauss_quant(p, 2.0, 3.0)
    assert tutils._gauss_quant_odeh_evans(p, 2.0, 3.0) == jutils._gauss_quant_odeh_evans(p, 2.0, 3.0)
    assert abs(tutils._gauss_quant_odeh_evans(p) - tutils.gauss_quant(p)) < 1e-3


@pytest.mark.parametrize("start_idx,dft_size", [(0, None), (3, None), (5, 64)])
@pytest.mark.parametrize("copy", [True, False])
def test_circshift_fourier_equals_jax(start_idx, dft_size, copy):
    rng = np.random.RandomState(5)
    filt = rng.randn(20) + 1j * rng.randn(20)
    want = jutils.circshift_fourier(filt.copy(), 3.5, start_idx, dft_size, copy)
    mine = filt.copy()
    got = tutils.circshift_fourier(mine, 3.5, start_idx, dft_size, copy)
    assert np.array_equal(got, want)
    assert (got is mine) == (not copy)


def test_util_alias_names():
    assert tutil.__all__ == jutil.__all__
    for name in tutil.__all__:
        assert callable(getattr(tutil, name)), name
    path = os.path.join(AUDIO, "test.wav")
    assert np.array_equal(tutil.read_signal(path), jutil.read_signal(path))
    assert np.array_equal(tutils.read_signal(path), jutils.read_signal(path))
    with open(path, "rb") as f:
        data = f.read()
    assert np.array_equal(tutils.wds_read_signal("x.wav", data), jutils.wds_read_signal("x.wav", data))
    from speech_tpu_torch.compute import FrameComputer

    c = tutils.alias_factory_subclass_from_arg(
        FrameComputer, {"name": "stft", "bank": {"name": "fbank", "num_filts": 4}, "device": "cpu"})
    assert type(c).__name__ == "ShortTimeFourierTransformFrameComputer"
    assert tutils.hertz_to_angular(1000.0, 8000) == jutils.hertz_to_angular(1000.0, 8000)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_log32_within_one_ulp_of_jax():
    rng = np.random.RandomState(11)
    x = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 100000)).astype(np.float32)
    x = np.concatenate([x, np.float32([1.0, 2.0, 0.5, 1.4142135, 1.4142137, 1e-30, 1e30])])
    got = txmath.log32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), jxmath.log32(x)).max() <= 1
    # and a few ulp of float64's log, as the JAX package measures it
    assert np.abs(got.numpy() - np.log(x.astype(np.float64))).max() < 1e-5


def test_log32_gradient_is_one_over_x():
    x = torch.tensor([1e-3, 0.5, 1.0, 3.0, 1e4], dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(txmath.log32(x).sum(), x)
    assert torch.equal(g, 1 / x.detach())
    w = torch.tensor([2.0, -1.0, 0.5, 1.0, 3.0])
    (g,) = torch.autograd.grad((txmath.log32(x) * w).sum(), x)
    assert torch.allclose(g, w / x.detach(), rtol=0, atol=0)


def test_xlog_picks_by_dtype():
    x32 = torch.tensor([0.1, 2.0, 7.0], dtype=torch.float32)
    assert torch.equal(txmath.xlog(x32), txmath.log32(x32))
    x64 = x32.double()
    assert torch.equal(txmath.xlog(x64), torch.log(x64))
    assert np.array_equal(txmath.xlog(x32).numpy(), np.asarray(jxmath.xlog(x32.numpy())))


def test_deprecated_top_level_reexports_warn():
    from speech_tpu_torch import alias

    for name in ("AliasedFactory", "alias_factory_subclass_from_arg"):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert getattr(speech_tpu_torch, name) is getattr(alias, name)
    with pytest.raises(AttributeError):
        speech_tpu_torch.not_a_name


def test_enable_persistent_compilation_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "_DEFAULT", None)
    monkeypatch.setattr(tutils, "_CACHE", None)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "ext"))
    if not torch.cuda.is_available():
        # a no-op without CUDA, as the JAX package's is on its CPU backend
        assert tutils.enable_persistent_compilation_cache() is None
        assert aot.default_store().directory == str(aot.DEFAULT_DIR)
        monkeypatch.setattr(aot, "_DEFAULT", None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    store = tutils.enable_persistent_compilation_cache(explain=True)
    assert store.directory == str(tmp_path / "ext" / "speech_tpu_torch")
    assert aot.default_store() is store and aot.active_store() is store and store.explain
    # already moved: a no-op
    assert tutils.enable_persistent_compilation_cache(str(tmp_path / "other")) is store
    assert not (tmp_path / "other").exists()
    # without TORCH_EXTENSIONS_DIR, the user's cache directory
    monkeypatch.setattr(tutils, "_CACHE", None)
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    store = tutils.enable_persistent_compilation_cache()
    assert store.directory == str(tmp_path / "home" / ".cache" / "speech_tpu_torch")
