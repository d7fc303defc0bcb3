"""The port's PyTorch compatibility layer (speech_tpu_torch.torch) against
the JAX package's (speech_tpu.torch, tests/test_torch.py).

Both layers' modules are built from their own package's computer on the
same config, moved to float64, and run on the same float64 signal made
with numpy from a seed, eagerly, scripted and traced: they agree within
1e-10.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import speech_tpu.torch as jtorch
import speech_tpu_torch.torch as ttorch
from speech_tpu import post as jpost
from speech_tpu import pre as jpre
from speech_tpu.compute import SIFrameComputer as JSI
from speech_tpu.compute import STFTFrameComputer as JSTFT
from speech_tpu_torch import post as tpost
from speech_tpu_torch import pre as tpre
from speech_tpu_torch.compute import SIFrameComputer as TSI
from speech_tpu_torch.compute import STFTFrameComputer as TSTFT

BANK = {"name": "fbank", "num_filts": 13, "sampling_rate": 8000}
JIT_MODES = ["none", "script", "trace"]
TOL = 1e-10


def _jitted(mod, mode, example):
    """As tests/test_torch.py:_jitted: the functional computers are
    ``script_if_tracing``, so a trace on a different-length example still
    generalizes."""
    if mode == "none":
        return mod
    with warnings.catch_warnings():
        # this torch version deprecates script/trace themselves; tracer
        # warnings (shape specialization) must still be errors
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        if mode == "script":
            return torch.jit.script(mod)
        return torch.jit.trace(mod, (example,))


@pytest.fixture(scope="module")
def signal():
    return np.random.RandomState(30).randn(4000)


def _stft(**kw):
    return (
        jtorch.PyTorchSTFTFrameComputer.from_stft_frame_computer(
            JSTFT(dict(BANK), dtype="float64", frame_length_ms=25, frame_shift_ms=10, **kw)),
        ttorch.PyTorchSTFTFrameComputer.from_stft_frame_computer(
            TSTFT(dict(BANK), dtype="float64", frame_length_ms=25, frame_shift_ms=10,
                  device="cpu", **kw)),
    )


def _si(**kw):
    return (
        jtorch.PyTorchSIFrameComputer.from_si_frame_computer(
            JSI(dict(BANK), dtype="float64", include_energy=True, **kw)),
        ttorch.PyTorchSIFrameComputer.from_si_frame_computer(
            TSI(dict(BANK), dtype="float64", include_energy=True, device="cpu", **kw)),
    )


def _close(a, b):
    a, b = a.detach().numpy(), b.detach().numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= TOL, np.abs(a - b).max()


@pytest.mark.parametrize("jit_mode", JIT_MODES)
@pytest.mark.parametrize("include_energy", [False, True], ids=["", "energy"])
@pytest.mark.parametrize("use_power", [False, True], ids=["mag", "power"])
@pytest.mark.parametrize("style", ["centered", "causal"])
def test_stft_module_matches_jax(signal, include_energy, use_power, style, jit_mode):
    jmod, tmod = _stft(frame_style=style, include_energy=include_energy, use_power=use_power)
    for name in ("weights", "window"):
        assert torch.equal(getattr(jmod, name), getattr(tmod, name))
    example = torch.randn(2500, dtype=torch.float64)
    x = torch.as_tensor(signal)
    _close(_jitted(jmod.double(), jit_mode, example)(x), _jitted(tmod.double(), jit_mode, example)(x))


@pytest.mark.parametrize("jit_mode", JIT_MODES)
@pytest.mark.parametrize("style", ["centered", "causal"])
def test_si_module_matches_jax(signal, style, jit_mode):
    jmod, tmod = _si(frame_style=style)
    example = torch.randn(2500, dtype=torch.float64)
    x = torch.as_tensor(signal)
    _close(_jitted(jmod.double(), jit_mode, example)(x), _jitted(tmod.double(), jit_mode, example)(x))


def test_modules_match_the_ports_computers(signal):
    """float32 parameters against the port's float64 computers, at the
    tolerance of tests/test_torch.py."""
    for tcls, convert, kw in (
        (TSTFT, ttorch.PyTorchSTFTFrameComputer.from_stft_frame_computer,
         dict(frame_length_ms=25, frame_shift_ms=10)),
        (TSI, ttorch.PyTorchSIFrameComputer.from_si_frame_computer, dict(include_energy=True)),
    ):
        computer = tcls(dict(BANK), dtype="float64", device="cpu", **kw)
        want = computer.compute_full(signal)
        got = convert(computer)(torch.as_tensor(signal, dtype=torch.float32)).detach().numpy()
        assert got.shape == want.shape
        assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()


def test_parameters_go_on_the_computers_device():
    computer = TSTFT(dict(BANK), frame_length_ms=25, device="cpu")
    mod = ttorch.PyTorchSTFTFrameComputer.from_stft_frame_computer(computer)
    assert {p.device for p in mod.parameters()} == {torch.device("cpu")}
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    # no device named and no GPU: the computer raises, as every entry point
    with pytest.raises(RuntimeError, match="CUDA"):
        ttorch.PyTorchSTFTFrameComputer.from_stft_frame_computer(
            TSTFT(dict(BANK), frame_length_ms=25))


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_gradients_match_jax(signal, kind):
    jmod, tmod = (_stft() if kind == "stft" else _si())
    jmod, tmod = jmod.double(), tmod.double()
    x = torch.as_tensor(signal[:1000])
    for mod in (jmod, tmod):
        mod(x).mean().backward()
    for (name, jp), tp in zip(jmod.named_parameters(), tmod.parameters()):
        assert tp.grad is not None and torch.isfinite(tp.grad).all(), name
        diff = (jp.grad - tp.grad).abs().max().item()
        assert diff <= TOL * max(1.0, jp.grad.abs().max().item()), (name, diff)


@pytest.mark.parametrize("n", [0, 3, 150])
def test_empty_and_short_signals(n):
    for jmod, tmod in (_stft(), _si()):
        x = torch.zeros(n, dtype=torch.float64)
        _close(jmod.double()(x), tmod.double()(x))


@pytest.mark.parametrize("jit_mode", ["none", "script", "trace"])
def test_pre_modules_match_jax(signal, jit_mode):
    x = torch.as_tensor(signal)
    example = torch.randn(100, dtype=torch.float64)
    jpe = jtorch.PyTorchPreemphasize.from_preemphasize(jpre.Preemphasize(0.95))
    tpe = ttorch.PyTorchPreemphasize.from_preemphasize(tpre.Preemphasize(0.95))
    assert tpe.coeff == 0.95 and repr(tpe) == repr(jpe)
    _close(_jitted(jpe, jit_mode, example)(x), _jitted(tpe, jit_mode, example)(x))
    want = tpre.Preemphasize(0.95).apply(signal)
    assert np.abs(tpe(x).numpy() - want).max() <= TOL
    tdi = ttorch.PyTorchDither.from_dither(tpre.Dither(0.5))
    tdi.eval()  # dither fires in training mode only
    assert torch.equal(_jitted(tdi, jit_mode, example)(x), x)


def test_dither_matches_jax_draws():
    jdi = jtorch.PyTorchDither.from_dither(jpre.Dither(0.5))
    tdi = ttorch.PyTorchDither.from_dither(tpre.Dither(0.5))
    sig = torch.zeros(100000)
    torch.manual_seed(0)
    a = jdi(sig)
    torch.manual_seed(0)
    b = tdi(sig)
    assert torch.equal(a, b) and abs(b.std().item() - 0.5) < 0.01
    assert torch.equal(ttorch.pytorch_dither(sig, 0.0), sig)


@pytest.mark.parametrize("axis", [0, -1])
def test_postprocessor_wrapper_matches_jax(axis):
    feats = np.random.RandomState(31).randn(40, 13)
    jmod = jtorch.PyTorchPostProcessorWrapper.from_postprocessor(jpost.Deltas(2), axis=axis)
    tmod = ttorch.PyTorchPostProcessorWrapper.from_postprocessor(tpost.Deltas(2), axis=axis)
    x = torch.as_tensor(feats, dtype=torch.float32)
    a, b = jmod(x), tmod(x)
    assert b.dtype == torch.float32 and b.shape == a.shape
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-6


def test_check_helpers_match_jax():
    for helper, args in (
        ("check_in", ("mode", "a", ("a", "b"))),
        ("check_in", ("mode", "c", ("a", "b"))),
        ("check_positive", ("n", 3)),
        ("check_positive", ("n", 0)),
        ("check_positive", ("n", 0, True)),
        ("check_positive", ("n", -1, True)),
    ):
        outcomes = []
        for mod in (jtorch, ttorch):
            try:
                outcomes.append(getattr(mod, helper)(*args))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (helper, args)
    assert sorted(ttorch.__all__) == sorted(jtorch.__all__)
    assert ttorch.PyTorchSTFTFrameComputer is ttorch.PyTorchShortTimeFourierTransformFrameComputer
    assert ttorch.PyTorchSIFrameComputer is ttorch.PyTorchShortIntegrationFrameComputer


def test_package_imports_the_layer_lazily():
    code = ("import sys, speech_tpu_torch; assert 'speech_tpu_torch.torch' not in sys.modules; "
            "assert 'speech_tpu_torch.vis' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr
