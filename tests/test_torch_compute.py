"""speech_tpu_torch's STFTFrameComputer against speech_tpu's on the same
signals and the same (converted) params."""

import numpy as np
import pytest
import torch

from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu_torch import compute as TC
from speech_tpu_torch.alias import alias_factory_subclass_from_arg
from speech_tpu_torch.compute import STFTFrameComputer, params_from_jax

BANK = {"name": "fbank", "num_filts": 10, "sampling_rate": 16000}

CONFIGS = {
    "causal": dict(frame_style="causal"),
    "centered": dict(frame_style="centered"),
    "kaldi": dict(frame_style="centered", kaldi_shift=True, use_power=True),
}


def _pair(bank=BANK, **kw):
    """A JAX computer and the port's computer on its converted params."""
    kw = {"frame_length_ms": 25, "frame_shift_ms": 10, "include_energy": True, **kw}
    jc = JaxSTFT(dict(bank), **kw)
    tc = STFTFrameComputer(dict(bank), device="cpu", **kw)
    tc.load_params(
        params_from_jax(
            {k: (v if k == "i8k_offsets" else np.asarray(v)) for k, v in jc.params.items()}
        )
    )
    return jc, tc


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-4)])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_compute_full_matches_jax(cfg, dtype, tol):
    jc, tc = _pair(dtype=dtype, **CONFIGS[cfg])
    rng = np.random.RandomState(31)
    for n in (5000, 401, 250, 150):  # long, about a frame, shorter than one
        sig = rng.randn(n).astype(dtype)
        want = jc.compute_full(sig)
        got = tc.compute_full(sig)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max(initial=0.0) <= tol


@pytest.mark.parametrize(
    "precision,fft_mode,tol",
    [
        ("highest", None, 1e-10),
        ("highest", "fft", 1e-10),
        ("highest", "pallas", 1e-4),  # pallas computes in float32 (f32 kernel)
    ],
)
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_compute_batch_matches_jax(cfg, precision, fft_mode, tol):
    """All-full and ragged batches (with a zero-length row), float64."""
    jc, tc = _pair(dtype="float64", precision=precision, fft_mode=fft_mode, **CONFIGS[cfg])
    rng = np.random.RandomState(32)
    sigs = rng.randn(4, 3000)
    for lengths in (np.full(4, 3000), np.array([3000, 2999, 300, 0])):
        fj, cj = jc.compute_batch(sigs, lengths)
        ft, ct = tc.compute_batch(sigs, lengths)
        assert isinstance(ft, torch.Tensor) and isinstance(ct, torch.Tensor)
        assert ct.dtype == torch.int32
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert ft.shape == np.asarray(fj).shape
        for i, n in enumerate(ct.tolist()):
            err = np.abs(ft[i, :n].numpy() - np.asarray(fj)[i, :n]).max(initial=0.0)
            assert err <= tol


@pytest.mark.parametrize("precision,tol", [("highest", 1e-4), ("double", 2e-6)])
def test_compute_batch_float32_tiers_match_jax(precision, tol):
    jc, tc = _pair(bank={"name": "fbank", "num_filts": 40, "sampling_rate": 16000},
                   dtype="float32", precision=precision)
    sigs = np.random.RandomState(33).randn(3, 4000).astype(np.float32)
    lengths = np.array([4000, 3500, 1200])
    fj, cj = jc.compute_batch(sigs, lengths)
    ft, ct = tc.compute_batch(sigs, lengths)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    for i, n in enumerate(ct.tolist()):
        assert np.abs(ft[i, :n].numpy() - np.asarray(fj)[i, :n]).max() <= tol


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_compute_batch_int16_ingress(cfg):
    """Compact int16 batches upcast on the device and match the float path
    bitwise, and the JAX computer on the same int16 input."""
    jc, tc = _pair(dtype="float64", **CONFIGS[cfg])
    batch_i = (np.random.RandomState(34).randn(3, 2048) * 1000).astype(np.int16)
    for lengths in (np.array([2048, 1500, 800]), np.full(3, 2048)):
        f_i, c_i = tc.compute_batch(batch_i, lengths)
        f_f, c_f = tc.compute_batch(batch_i.astype(np.float64), lengths)
        f_j, c_j = jc.compute_batch(batch_i, lengths)
        assert np.array_equal(c_i.numpy(), c_f.numpy())
        assert np.array_equal(c_i.numpy(), np.asarray(c_j))
        for i, n in enumerate(c_i.tolist()):
            assert torch.equal(f_i[i, :n], f_f[i, :n])
            assert np.abs(f_i[i, :n].numpy() - np.asarray(f_j)[i, :n]).max() <= 1e-10


def test_compute_batch_tensor_lengths_match_host_lengths():
    _, tc = _pair(dtype="float64")
    sigs = np.random.RandomState(35).randn(3, 2048)
    f_host, c_host = tc.compute_batch(sigs, np.full(3, 2048))
    f_dev, c_dev = tc.compute_batch(torch.tensor(sigs), torch.full((3,), 2048))
    assert torch.equal(c_host, c_dev)
    assert torch.equal(f_host, f_dev)
    with pytest.raises(ValueError):
        tc.compute_batch(sigs, np.array([2048, 2049, 0]))


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_streaming_equals_batch_under_random_chunkings(cfg):
    jc, tc = _pair(dtype="float64", **CONFIGS[cfg])
    rng = np.random.RandomState(36)
    sig = rng.randn(4321)
    full = tc.compute_full(sig)
    assert np.abs(full - jc.compute_full(sig)).max() <= 1e-10
    for _ in range(3):
        cuts = np.sort(rng.choice(np.arange(1, len(sig)), size=7, replace=False))
        chunks = np.split(sig, cuts)
        got = np.concatenate(
            [tc.compute_chunk(c) for c in chunks] + [tc.finalize()]
        )
        assert got.shape == full.shape
        assert np.abs(got - full).max() <= 1e-10
    assert not tc.started
    stream = TC.frame_by_frame_calculation(tc, sig, chunk_size=100)
    assert np.abs(stream - full).max() <= 1e-10


def test_streaming_matches_jax_streaming():
    jc, tc = _pair(dtype="float32", frame_style="centered", precision="double")
    sig = np.random.RandomState(37).randn(3000).astype(np.float32)
    for c in (sig[:700], sig[700:1900], sig[1900:]):
        assert np.abs(tc.compute_chunk(c) - jc.compute_chunk(c)).max(initial=0.0) <= 2e-6
    assert np.abs(tc.finalize() - jc.finalize()).max(initial=0.0) <= 2e-6


def test_constructor_errors_match_jax():
    for kw in (
        dict(precision="bogus"),
        dict(precision="double", dtype="float64"),
        dict(precision="accurate", dtype="float64"),
        dict(frame_style="sideways"),
    ):
        with pytest.raises(ValueError):
            JaxSTFT(dict(BANK), **kw)
        with pytest.raises(ValueError):
            STFTFrameComputer(dict(BANK), device="cpu", **kw)
    with pytest.raises(ValueError):
        STFTFrameComputer(dict(BANK), fft_mode="bogus", device="cpu")
    c = alias_factory_subclass_from_arg(
        TC.FrameComputer,
        {"name": "stft", "bank": dict(BANK), "precision": "accurate", "device": "cpu"},
    )
    assert isinstance(c, STFTFrameComputer) and c._precision == "accurate"
    c.compute_chunk(np.zeros(10))
    with pytest.raises(ValueError):  # a stream is in progress
        c.compute_full(np.zeros(10))
    c.finalize()


def test_entry_points_without_gpu_raise(monkeypatch):
    """No device given and no GPU: every entry point raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = STFTFrameComputer(dict(BANK), frame_length_ms=25)
    sig = np.zeros(2000)
    for call in (
        lambda: c.compute_full(sig),
        lambda: c.compute_batch(sig[None], [2000]),
        lambda: c.compute_chunk(sig),
        lambda: c.params,
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not c.started
    with pytest.raises(RuntimeError):
        TC.resolve_device(None)
    assert TC.resolve_device("cpu") == torch.device("cpu")
