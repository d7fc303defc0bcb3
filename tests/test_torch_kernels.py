"""The kernels' plain versions (speech_tpu_torch.ops.stft_kernels) against
the Pallas kernels run in interpret mode, and the computer's kernel routes.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py
holds them against their plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.ops import framing as JF
from speech_tpu.ops import pallas_stft as JP
from speech_tpu_torch.compute import STFTFrameComputer, params_from_jax
from speech_tpu_torch.ops import framing as TF
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


def _pair(**kw):
    """A JAX computer and the port's computer on its converted params."""
    kw = {"frame_length_ms": 25, "frame_shift_ms": 10, "dtype": "float32", **kw}
    jc = JaxSTFT(dict(BANK), **kw)
    tc = STFTFrameComputer(dict(BANK), device="cpu", **kw)
    tc.load_params(
        params_from_jax(
            {k: (v if k == "i8k_offsets" else np.asarray(v)) for k, v in jc.params.items()}
        )
    )
    return jc, tc


def _padded(jc, lengths, buf=3000, seed=70):
    rng = np.random.RandomState(seed)
    sigs = rng.randn(len(lengths), buf).astype(np.float32)
    fl, fs = jc.frame_length, jc.frame_shift
    padded = jax.vmap(lambda s, n: JF.pad_signal(s, n, fl, fs, jc._pad_left))(
        jnp.asarray(sigs), jnp.asarray(lengths, dtype=jnp.int32)
    )
    return np.asarray(padded), JF.frame_count_np(buf, fl, fs)


def _close(got, want, tol, use_log):
    assert got.shape == want.shape
    rtol = 0.0 if use_log else RTOL_LINEAR
    err = np.abs(got - want).max()
    assert np.allclose(got, want, rtol=rtol, atol=tol), err


@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_rows_plain_matches_pallas(include_energy, use_power, use_log):
    jc, tc = _pair(use_power=use_power, include_energy=include_energy)
    padded, mf = _padded(jc, [3000, 2000])
    kw = dict(
        num_frames=mf,
        frame_length=jc.frame_length,
        frame_shift=jc.frame_shift,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=1e-5,
    )
    want = np.asarray(
        JP.stft_feats_pallas(jnp.asarray(padded), jc.params, block_frames=8, interpret=True, **kw)
    )
    got = K.stft_feats_rows_plain(torch.tensor(padded), tc.params, **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL_FLOAT, use_log)


@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_frames_plain_matches_pallas(include_energy, use_power, use_log):
    jc, tc = _pair(use_power=use_power, include_energy=include_energy)
    padded, mf = _padded(jc, [3000, 1000], seed=71)
    frames = np.ascontiguousarray(
        TF.frame_padded(torch.tensor(padded), mf, jc.frame_length, jc.frame_shift).numpy()
    )
    kw = dict(
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=1e-5,
    )
    want = np.asarray(
        JP.stft_feats_pallas_from_frames(
            jnp.asarray(frames), jc.params, block_frames=8, interpret=True, **kw
        )
    )
    got = K.stft_feats_frames_plain(torch.tensor(frames), tc.params, **kw)
    _close(got.numpy(), want, TOL_FLOAT, use_log)


@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_int8_plain_matches_pallas(include_energy, use_power, use_log):
    jc, tc = _pair(
        use_power=use_power, include_energy=include_energy, precision="double"
    )
    padded, mf = _padded(jc, [3000, 2500], seed=72)
    kw = dict(
        num_frames=mf,
        frame_length=jc.frame_length,
        frame_shift=jc.frame_shift,
        dft_size=jc.dft_size,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=1e-5,
    )
    want = np.asarray(
        JP.stft_feats_pallas_int8(jnp.asarray(padded), jc.params, block_frames=8, interpret=True, **kw)
    )
    got = K.stft_feats_int8_plain(torch.tensor(padded), tc.params, **kw)
    _close(got.numpy(), want, TOL_INT8, use_log)


@pytest.mark.parametrize("precision", ["double", "accurate"])
def test_int8_plain_on_quantised_audio(precision):
    """int16-derived samples put exact halfway points in the digit
    rounding: the plain version must round half to even like jnp.round."""
    jc, tc = _pair(include_energy=True, precision=precision)
    rng = np.random.RandomState(73)
    sig = np.round(rng.randn(1, 3000) * 3000).clip(-32768, 32767) / 32768.0
    padded = np.asarray(
        JF.pad_signal_full(jnp.asarray(sig[0], jnp.float32), jc.frame_length, jc._pad_left)
    )[None]
    mf = JF.frame_count_np(3000, jc.frame_length, jc.frame_shift)
    kw = dict(
        num_frames=mf,
        frame_length=jc.frame_length,
        frame_shift=jc.frame_shift,
        dft_size=jc.dft_size,
        use_log=True,
        use_power=False,
        include_energy=True,
        log_floor=1e-5,
    )
    want = np.asarray(
        JP.stft_feats_pallas_int8(jnp.asarray(padded), jc.params, block_frames=8, interpret=True, **kw)
    )
    got = K.stft_feats_int8(torch.tensor(padded), tc.params, **kw)
    assert np.abs(got.numpy() - want).max() <= TOL_INT8


def test_cpu_wrappers_run_plain_versions_without_launching():
    jc, tc = _pair(include_energy=True, precision="double")
    padded, mf = _padded(jc, [3000], seed=74)
    x = torch.tensor(padded)
    K.reset_launch_counts()
    kw = dict(
        num_frames=mf,
        frame_length=jc.frame_length,
        frame_shift=jc.frame_shift,
        use_log=True,
        use_power=False,
        include_energy=True,
        log_floor=1e-5,
    )
    assert torch.equal(
        K.stft_feats_int8(x, tc.params, dft_size=jc.dft_size, **kw),
        K.stft_feats_int8_plain(x, tc.params, dft_size=jc.dft_size, **kw),
    )
    assert torch.equal(
        K.stft_feats_rows(x, tc.params, **kw), K.stft_feats_rows_plain(x, tc.params, **kw)
    )
    frames = TF.frame_padded(x, mf, jc.frame_length, jc.frame_shift).contiguous()
    spec = {k: kw[k] for k in ("use_log", "use_power", "include_energy", "log_floor")}
    assert torch.equal(
        K.stft_feats_frames(frames, tc.params, **spec),
        K.stft_feats_frames_plain(frames, tc.params, **spec),
    )
    assert K.launch_counts() == {
        "stft_feats_rows": 0,
        "stft_feats_frames": 0,
        "stft_feats_int8": 0,
    }


def test_wrappers_reject_what_the_kernels_do_not_take():
    jc, tc = _pair(include_energy=True)
    kw = dict(use_log=True, use_power=False, include_energy=True, log_floor=1e-5)
    rows_kw = dict(num_frames=4, frame_length=400, frame_shift=160, **kw)
    with pytest.raises(ValueError):
        K.stft_feats_rows(torch.zeros(2, 3, 1000), tc.params, **rows_kw)
    with pytest.raises(ValueError):
        K.stft_feats_rows(torch.zeros(2, 1000), tc.params, precision="double", **rows_kw)
    with pytest.raises(ValueError):
        K.stft_feats_frames(torch.zeros(2, 400), tc.params, **kw)
    with pytest.raises(ValueError):  # no int8 layout on a float tier
        K.stft_feats_int8(torch.zeros(2, 1000), tc.params, dft_size=512, **rows_kw)


def test_pack_groups_layout_decodes_to_gmats():
    """The dp4a layout the int8 kernel reads: four k-rows to an int32,
    lowest row in the lowest byte, member blocks padded to K16 rows."""
    _, tc = _pair(frame_length_ms=24.375, precision="double")  # K = 390
    params = tc.params
    gmats, offsets = params["i8k_gmats"], params["i8k_offsets"]
    K_ = tc.frame_length
    assert K_ == 390
    g4, (n_groups, members, xs, row4, svals) = K._pack_groups(gmats, offsets, K_)
    assert g4.dtype == torch.int32 and n_groups == len(offsets)
    k16 = 400
    as_bytes = g4.numpy().view(np.int8).reshape(g4.shape[0], g4.shape[1], 4)
    for g, (s, xids, off, span) in enumerate(offsets):
        assert svals[g] == s and members[g] == len(xids)
        assert list(xs[5 * g : 5 * g + len(xids)]) == list(xids)
        for m in range(len(xids)):
            r0 = row4[g] + m * k16 // 4
            block = as_bytes[r0 : r0 + k16 // 4].transpose(0, 2, 1).reshape(k16, -1)
            want = gmats[off + m * K_ : off + (m + 1) * K_].numpy()
            assert np.array_equal(block[:K_], want)
            assert not block[K_:].any()


def test_packed_groups_built_once_per_gmats():
    """The int8 wrapper packs a gmats tensor once and reuses the layout
    until the tensor changes in place."""
    _, tc = _pair(precision="double")
    gmats, offsets = tc.params["i8k_gmats"], tc.params["i8k_offsets"]
    first = K._packed_groups(gmats, offsets, tc.frame_length)
    assert K._packed_groups(gmats, offsets, tc.frame_length) is first
    gmats.add_(0)  # bumps the version: the packing is stale
    again = K._packed_groups(gmats, offsets, tc.frame_length)
    assert again is not first and torch.equal(again[0], first[0])
    slot = id(gmats)
    del tc, gmats
    assert slot not in K._PACKED


def test_dft384_lane_split_runs_int8_route():
    """dft 384 (nb 192, not 128-aligned) takes the int8 route and matches
    the Pallas computer (tests/test_pallas.py:345)."""
    kw = dict(
        frame_length_ms=24,
        pad_to_nearest_power_of_two=False,
        include_energy=True,
        precision="double",
        fft_mode="pallas",
    )
    jc, tc = _pair(**kw)
    assert tc.dft_size == 384 and tc._use_kernel(torch.device("cpu")) == "int8"
    sig = np.random.RandomState(13).randn(2, 6000).astype(np.float32)
    lens = np.full((2,), 6000, np.int32)
    fj, cj = jc.compute_batch(sig, lens)
    ft, ct = tc.compute_batch(sig, lens)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.abs(ft.numpy() - np.asarray(fj)).max() <= TOL_INT8


def test_dft398_routes_to_plain_digit_path():
    """dft 398 (398 % 4 == 2) has no int8 layout: the digit tiers take
    the plain digit path even with fft_mode='pallas' (test_pallas.py:198)."""
    kw = dict(
        frame_length_ms=24.875,
        pad_to_nearest_power_of_two=False,
        precision="double",
        fft_mode="pallas",
    )
    jc, tc = _pair(**kw)
    assert tc.dft_size == 398
    assert tc._use_kernel(torch.device("cpu")) is None
    assert tc._use_kernel(torch.device("cuda")) is None
    assert "i8k_gmats" not in tc.params
    sig = np.random.RandomState(9).randn(6000).astype(np.float32)
    assert np.abs(tc.compute_full(sig) - jc.compute_full(sig)).max() <= TOL_INT8


def test_accurate_adversary_bound_held():
    """The tonal adversary of tests/test_pallas.py:253: 'accurate' within
    2e-5 and 'double' within 1e-5 of float64, 'double' no worse."""
    rate = 16000
    n = rate
    t = np.arange(n) / rate
    rng = np.random.RandomState(20260818)
    sig = (
        12000 * np.sin(2 * np.pi * 1000.0 * t)
        - 10800 * np.sin(2 * np.pi * 1001.0 * t)
        + rng.randn(n) * 32
    )
    sig = np.clip(np.round(sig), -32767, 32767) / 32768.0
    kw = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True)
    want = JaxSTFT(dict(BANK), dtype="float64", **kw).compute_full(sig)
    errs = {}
    for precision, bound in (("accurate", 2e-5), ("double", 1e-5)):
        _, tc = _pair(precision=precision, fft_mode="pallas", include_energy=True)
        got = tc.compute_full(sig.astype(np.float32))
        errs[precision] = np.abs(got - want).max()
        assert errs[precision] <= bound, (precision, errs[precision])
    assert errs["double"] <= errs["accurate"]

