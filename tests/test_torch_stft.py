"""speech_tpu_torch.ops.stft.stft_feats_from_frames against the JAX
pipeline on the same frames and the same (converted) params."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.ops import stft as JS
from speech_tpu_torch.compute import params_from_jax
from speech_tpu_torch.ops import stft as TS

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}

# mode -> (computer kwargs, fft_mode, tolerance for log features)
MODES = {
    "matmul64": (dict(dtype="float64"), "matmul", 1e-10),
    "fft64": (dict(dtype="float64"), "fft", 1e-10),
    "odd64": (  # dft 401: no Nyquist split
        dict(dtype="float64", frame_length_ms=25.0625, pad_to_nearest_power_of_two=False),
        "matmul",
        1e-10,
    ),
    "highest32": (dict(dtype="float32"), "matmul", 1e-4),  # tests/test_pallas.py:55
    "double32": (dict(dtype="float32", precision="double"), "matmul", 2e-6),  # :175
    "accurate32": (dict(dtype="float32", precision="accurate"), "matmul", 2e-6),
}


def _setup(mode, use_power):
    kw, fft_mode, tol = MODES[mode]
    kw = {"frame_length_ms": 25, "frame_shift_ms": 10, **kw}
    jc = JaxSTFT(dict(BANK), use_power=use_power, **kw)
    jparams = jc.params
    tparams = params_from_jax(
        {k: (v if k == "i8k_offsets" else np.asarray(v)) for k, v in jparams.items()}
    )
    rng = np.random.RandomState(17)
    frames = rng.randn(2, 12, jc.frame_length)
    frames[0, 3] *= 1e-3  # a quiet frame
    frames[1, 5] = 0.0  # a silent frame: the log floor
    np_dtype = np.float64 if kw["dtype"] == "float64" else np.float32
    return jc, jparams, tparams, frames.astype(np_dtype), fft_mode, tol


@pytest.mark.parametrize("use_log", [False, True], ids=["lin", "log"])
@pytest.mark.parametrize("use_power", [False, True], ids=["mag", "power"])
@pytest.mark.parametrize("include_energy", [False, True], ids=["", "energy"])
@pytest.mark.parametrize("mode", list(MODES))
def test_stft_feats_from_frames_matches_jax(mode, include_energy, use_power, use_log):
    jc, jparams, tparams, frames, fft_mode, tol = _setup(mode, use_power)
    spec = dict(
        dft_size=jc.dft_size,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=1e-5,
        fft_mode=fft_mode,
        precision=jc._precision,
    )
    want = np.asarray(JS.stft_feats_from_frames(jnp.asarray(frames), jparams, **spec))
    got = TS.stft_feats_from_frames(torch.tensor(frames), tparams, **spec)
    assert got.dtype == (torch.float64 if frames.dtype == np.float64 else torch.float32)
    assert got.shape == want.shape
    if not use_log and mode != "matmul64" and mode != "fft64" and mode != "odd64":
        tol = 5e-5  # linear features carry the scale (tests/test_pallas.py:540)
    err = np.abs(got.numpy() - want).max()
    assert err <= tol, err


def test_digitize_frames_exact_and_half_to_even():
    """The frame digitisation reproduces the JAX planes bit for bit,
    including values that sit exactly halfway between two digits."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 64).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 1.0, -2.5]) / 64.0
    x[0, 8] = 1.0  # the peak sets the scale to 2
    x[1] = (np.round(x[1] * 32768) / 32768).astype(np.float32)  # int16 audio
    x[2] = 0.0
    want_planes, want_scale = JS._digitize_frames(jnp.asarray(x))
    got_planes, got_scale = TS._digitize_frames(torch.tensor(x))
    assert np.array_equal(got_planes.numpy(), np.asarray(want_planes))
    assert np.array_equal(got_scale.numpy(), np.asarray(want_scale))


@pytest.mark.parametrize("mode", ["highest32", "double32"])
def test_feature_call_leaves_callers_tf32_settings(mode):
    """The features run in IEEE float32, and the caller's TF32 settings
    are the same after the call as before it."""
    jc, _, tparams, frames, fft_mode, _ = _setup(mode, use_power=True)
    spec = dict(
        dft_size=jc.dft_size,
        use_log=True,
        use_power=True,
        include_energy=True,
        log_floor=1e-5,
        fft_mode=fft_mode,
        precision=jc._precision,
    )
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        with TS.ieee_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        TS.stft_feats_from_frames(torch.tensor(frames), tparams, **spec)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_ieee_float32_is_safe_across_threads():
    """Two threads each hold an ``ieee_float32`` block, overlapping (a
    barrier inside both): the flags stay IEEE in both until the last block
    exits, whichever exits first, and are the caller's again after."""
    import threading

    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    seen, errors = [], []
    inside = threading.Barrier(2)
    first_out = threading.Event()

    def flags():
        return (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)

    def worker(leaves_first):
        try:
            with TS.ieee_float32():
                inside.wait(timeout=30)
                if leaves_first:
                    seen.append(("first, inside", flags()))
                else:
                    first_out.wait(timeout=30)  # the other block has exited
                    seen.append(("last, after the other's exit", flags()))
            if leaves_first:
                first_out.set()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
            first_out.set()

    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=worker, args=(k,)) for k in (True, False)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert dict(seen) == {"first, inside": ("highest", False),
                              "last, after the other's exit": ("highest", False)}
        assert flags() == ("high", True)
        with TS.ieee_float32():  # nested blocks on one thread
            with TS.ieee_float32():
                pass
            assert flags() == ("highest", False)
        assert flags() == ("high", True)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_float32_modes_do_not_overlap_across_threads():
    """A TF32 block (resampling at 'high') that starts in one thread while
    another thread holds an ``ieee_float32`` block waits for it to exit:
    the IEEE block keeps IEEE flags throughout, the TF32 block then runs
    with TF32 matmuls and the caller's cuDNN setting, and the caller's
    settings come back after both.  A block of the other mode nested in a
    thread's own block raises."""
    import threading
    import time

    from speech_tpu_torch.ops import resample

    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    seen, errors = {}, []
    ieee_in, tf32_start, tf32_in = threading.Event(), threading.Event(), threading.Event()

    def flags():
        return (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)

    def ieee_worker():
        try:
            with TS.ieee_float32():
                ieee_in.set()
                tf32_start.wait(timeout=30)
                time.sleep(0.2)  # the TF32 block is waiting by now
                seen["ieee, the other waiting"] = (flags(), tf32_in.is_set())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
            ieee_in.set()

    def tf32_worker():
        try:
            ieee_in.wait(timeout=30)
            tf32_start.set()
            with resample._products("high"):
                tf32_in.set()
                seen["tf32"] = flags()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        threads = [threading.Thread(target=f) for f in (ieee_worker, tf32_worker)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert seen == {"ieee, the other waiting": (("highest", False, True), False),
                        "tf32": ("high", True, False)}
        assert flags() == ("highest", True, False)
        with TS.ieee_float32():
            with pytest.raises(RuntimeError, match="inside this thread"):
                with resample._products("high"):
                    pass
            assert flags() == ("highest", False, True)
        assert flags() == ("highest", True, False)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.backends.cudnn.deterministic = saved[2]
