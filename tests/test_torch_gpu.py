"""The CUDA kernels of speech_tpu_torch against their plain versions, on a
GPU.  Every test here is marked ``cuda`` and skips without one.

This file imports no jax, so it also runs where only PyTorch is installed;
on a GPU machine, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops import framing as TF
from speech_tpu_torch.ops import stft as TS
from speech_tpu_torch.ops import stft_kernels as K

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
TOL_FLOAT = 1e-4  # f32 reduction order (tests/test_pallas.py:55)
TOL_INT8 = 2e-6  # exact digit tiers (tests/test_pallas.py:175)
RTOL_LINEAR = 1e-5  # linear features carry the scale: f32 relative rounding

COMBOS = [
    (e, p, lg) for e in (False, True) for p in (False, True) for lg in (False, True)
]
COMBO_IDS = [
    f"{'energy' if e else 'noenergy'}-{'power' if p else 'mag'}-{'log' if lg else 'lin'}"
    for e, p, lg in COMBOS
]
# (frame_length_ms, frame_shift_ms, pad_to_nearest_power_of_two):
# the main config, K = 390 (digit planes padded to 400 rows), dft 384
# (nb = 192, the lane-split case of tests/test_pallas.py:345) and a frame
# shift of 164 samples (not a multiple of 8)
SHAPES = [(25, 10, True), (24.375, 10, True), (24, 10, False), (25, 10.25, True)]
SHAPE_IDS = ["main", "k390", "dft384", "shift164"]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, tol, use_log):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    rtol = 0.0 if use_log else RTOL_LINEAR
    assert torch.allclose(got, want, rtol=rtol, atol=tol), (got - want).abs().max().item()


def _setup(dev, shape, seed, **kw):
    fl_ms, fs_ms, pow2 = shape
    tc = STFTFrameComputer(
        dict(BANK), frame_length_ms=fl_ms, frame_shift_ms=fs_ms,
        pad_to_nearest_power_of_two=pow2, device=dev, **kw,
    )
    n = 9000
    x = torch.tensor(np.random.RandomState(seed).randn(3, n).astype(np.float32), device=dev)
    padded = TF.pad_signal_full(x, tc.frame_length, tc._pad_left)
    mf = TF.frame_count_np(n, tc.frame_length, tc.frame_shift)
    return tc, padded, mf


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_float_kernels_match_plain(shape, include_energy, use_power, use_log):
    dev = _device()
    tc, padded, mf = _setup(dev, shape, 80, use_power=use_power)
    spec = dict(use_log=use_log, use_power=use_power, include_energy=include_energy, log_floor=1e-5)
    kw = dict(num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift, **spec)
    _close(
        K.stft_feats_rows(padded, tc.params, **kw),
        K.stft_feats_rows_plain(padded, tc.params, **kw),
        TOL_FLOAT, use_log,
    )
    frames = TF.frame_padded(padded, mf, tc.frame_length, tc.frame_shift).contiguous()
    _close(
        K.stft_feats_frames(frames, tc.params, **spec),
        K.stft_feats_frames_plain(frames, tc.params, **spec),
        TOL_FLOAT, use_log,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_int8_kernel_matches_plain(shape, precision, include_energy, use_power, use_log):
    dev = _device()
    tc, padded, mf = _setup(dev, shape, 81, use_power=use_power, precision=precision)
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=tc.dft_size, use_log=use_log, use_power=use_power,
        include_energy=include_energy, log_floor=1e-5,
    )
    _close(
        K.stft_feats_int8(padded, tc.params, **kw),
        K.stft_feats_int8_plain(padded, tc.params, **kw),
        TOL_INT8, use_log,
    )


# (n_x, cutoff) of the base-256 digit kernel's tiers: 'double' the
# defaults (4, 4), 13 pairs; 'accurate' (4, 3), 10 pairs
DOUBLE_TIERS = {"double": {}, "accurate": dict(n_x=4, cutoff=3)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DOUBLE_TIERS))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_double_kernel_matches_plain(shape, precision, include_energy, use_power, use_log):
    dev = _device()
    tc, padded, mf = _setup(dev, shape, 83, use_power=use_power, precision=precision)
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=tc.dft_size, use_log=use_log, use_power=use_power,
        include_energy=include_energy, log_floor=1e-5, **DOUBLE_TIERS[precision],
    )
    K.reset_launch_counts()
    got = K.stft_feats_double(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_double"] == 1
    _close(got, K.stft_feats_double_plain(padded, tc.params, **kw), TOL_INT8, use_log)


@pytest.mark.cuda
def test_double_long_frames_take_digit_path_on_gpu():
    """40 ms frames (640 samples > 512): no exact base-256 sums, so the op
    runs the plain digit path on the card and launches nothing."""
    dev = _device()
    tc, padded, mf = _setup(dev, (40, 10, True), 84, precision="double")
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=tc.dft_size, use_log=True, use_power=False, include_energy=True,
        log_floor=1e-5,
    )
    K.reset_launch_counts()
    got = K.stft_feats_double(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_double"] == 0
    frames = TF.frame_padded(padded, mf, tc.frame_length, tc.frame_shift)
    want = TS.stft_feats_from_frames(
        frames, tc.params, dft_size=tc.dft_size, use_log=True, use_power=False,
        include_energy=True, log_floor=1e-5, fft_mode="matmul", precision="double",
    )
    _close(got, want, TOL_INT8, True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "precision,fft_mode,kernel,tol",
    [
        ("double", None, "stft_feats_int8", TOL_INT8),
        ("highest", "pallas", "stft_feats_rows", TOL_FLOAT),
    ],
)
def test_compute_batch_on_gpu_matches_cpu(precision, fft_mode, kernel, tol):
    """Ragged and int16 batches through the computer on the card (its
    kernel) against the same computer on the CPU (the plain version)."""
    dev = _device()
    kw = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True,
              precision=precision, fft_mode=fft_mode)
    gpu = STFTFrameComputer(dict(BANK), device=dev, **kw)
    cpu = STFTFrameComputer(dict(BANK), device="cpu", **kw)
    rng = np.random.RandomState(82)
    pcm = np.round(rng.randn(4, 8000) * 3000).clip(-32768, 32767).astype(np.int16)
    lens = np.array([8000, 5000, 200, 0])
    for sigs in (pcm.astype(np.float32) / 32768.0, pcm):
        K.reset_launch_counts()
        got, got_n = gpu.compute_batch(sigs, lens)
        assert K.launch_counts()[kernel] == 1
        want, want_n = cpu.compute_batch(sigs, lens)
        assert torch.equal(got_n.cpu(), want_n)
        for row, n in enumerate(want_n.tolist()):
            err = (got[row, :n].cpu() - want[row, :n]).abs().max().item() if n else 0.0
            assert err <= tol, (row, err)
