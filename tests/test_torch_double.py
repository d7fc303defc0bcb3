"""The base-256 digit kernel's host layout and plain version
(speech_tpu_torch.ops.stft / stft_kernels) against the JAX package:
``digit_kernel_matrices`` and ``padded_need`` equal to the originals,
``stft_feats_double_plain`` against ``stft_feats_pallas_double`` in
interpret mode, and the op's two gates to the plain digit path.

The CUDA kernel itself runs only on a GPU (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.ops import framing as JF
from speech_tpu.ops import pallas_stft as JP
from speech_tpu.ops import stft as jstft
import speech_tpu.filters as jfilters

from speech_tpu_torch.compute import STFTFrameComputer, params_from_jax
from speech_tpu_torch.ops import framing as TF
from speech_tpu_torch.ops import stft as tstft
from speech_tpu_torch.ops import stft_kernels as K

from test_torch_host import BANK_IDS, BANKS, _banks, _equal

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
TOL_DIGIT = 2e-6  # the digit tiers' exactness class (tests/test_pallas.py:467)
RTOL_LINEAR = 1e-5  # linear features carry the scale: f32 relative rounding
# (n_x, cutoff) as the JAX computer's tiers pass them: 'double' takes the
# defaults (4, 4): 13 pairs; 'accurate' (4, 3): 10 pairs
TIERS = {"double": (None, None), "accurate": (jstft._PAK_X_DIGITS, jstft._PAK_CUTOFF)}

COMBOS = [
    (e, p, lg) for e in (False, True) for p in (False, True) for lg in (False, True)
]
COMBO_IDS = [
    f"{'energy' if e else 'noenergy'}-{'power' if p else 'mag'}-{'log' if lg else 'lin'}"
    for e, p, lg in COMBOS
]


def _close(got, want, use_log):
    assert got.shape == want.shape
    rtol = 0.0 if use_log else RTOL_LINEAR
    assert np.allclose(got, want, rtol=rtol, atol=TOL_DIGIT), np.abs(got - want).max()


@pytest.mark.parametrize("dft", [256, 384, 512])
@pytest.mark.parametrize("cfg", BANKS[:2], ids=BANK_IDS[:2])
def test_digit_kernel_matrices_array_equal(cfg, dft):
    """The base-256 layout equals the JAX package's for the banks of
    tests/data/fbank.json and fbank.yaml, for both tiers' plane counts."""
    jb, tb = _banks(cfg)
    K_ = min(400, dft)
    window = jfilters.HannWindow().get_impulse_response(K_)
    C, S = jstft.windowed_dft_matrices(window, dft)
    for use_power in (False, True):
        W = jstft.fold_bank_to_weights(jb, dft, use_power)
        for ndig in {jstft._PDK_M_DIGITS, jstft._PAK_M_DIGITS, 3}:
            want = jstft.digit_kernel_matrices(C, S, W, ndig=ndig)
            got = tstft.digit_kernel_matrices(C, S, W, ndig=ndig)
            assert set(want) == set(got)
            for key in want:
                assert _equal(np.asarray(want[key]), np.asarray(got[key])), key


def test_digit_constants_equal():
    names = [
        "_PDK_BASE", "_PDK_X_DIGITS", "_PDK_M_DIGITS", "_PDK_CUTOFF",
        "_PAK_X_DIGITS", "_PAK_M_DIGITS", "_PAK_CUTOFF",
    ]
    for name in names:
        assert getattr(tstft, name) == getattr(jstft, name), name


@pytest.mark.parametrize(
    "num_frames,frame_length,frame_shift,block_frames",
    [(50, 400, 160, 512), (1500, 400, 160, 512), (93, 400, 164, 8), (7, 640, 160, 768),
     (1, 400, 400, 8), (200, 256, 100, 56)],
)
def test_padded_need_equal(num_frames, frame_length, frame_shift, block_frames):
    args = (num_frames, frame_length, frame_shift, block_frames)
    assert K.padded_need(*args) == JP.padded_need(*args)


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


def _padded(jc, n=8000, seed=21):
    """One row of ``n`` samples zero-padded past its frames, as
    tests/test_pallas.py:429-433 builds it."""
    sig = np.random.RandomState(seed).randn(1, n).astype(np.float32)
    mf = JF.frame_count_np(n, jc.frame_length, jc.frame_shift)
    padded = np.zeros((1, (mf + 4) * jc.frame_shift + jc.frame_length), np.float32)
    padded[:, :n] = sig
    return padded, mf


def _spec(jc, mf, include_energy, use_power, use_log):
    return dict(
        num_frames=mf,
        frame_length=jc.frame_length,
        frame_shift=jc.frame_shift,
        dft_size=jc.dft_size,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=1e-5,
    )


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_double_plain_matches_pallas(tier, include_energy, use_power, use_log):
    n_x, cutoff = TIERS[tier]
    jc, tc = _pair(use_power=use_power, include_energy=include_energy, precision=tier)
    padded, mf = _padded(jc)
    kw = _spec(jc, mf, include_energy, use_power, use_log)
    want = np.asarray(
        JP.stft_feats_pallas_double(
            jnp.asarray(padded), jc.params, block_frames=56, interpret=True,
            n_x=n_x, cutoff=cutoff, **kw,
        )
    )
    got = K.stft_feats_double_plain(torch.tensor(padded), tc.params, n_x=n_x, cutoff=cutoff, **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, use_log)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_double_plain_matches_torch_digit_path(tier):
    """The port's B4 plain version against the port's own plain digit
    tier (base 64, grouped), on framed rows: the same exactness class."""
    n_x, cutoff = TIERS[tier]
    _, tc = _pair(include_energy=True, precision=tier)
    padded, mf = _padded(tc, seed=22)
    x = torch.tensor(padded)
    kw = _spec(tc, mf, True, False, True)
    got = K.stft_feats_double_plain(x, tc.params, n_x=n_x, cutoff=cutoff, **kw)
    frames = TF.frame_padded(x, mf, tc.frame_length, tc.frame_shift)
    want = tstft.stft_feats_from_frames(
        frames, tc.params, fft_mode="matmul", precision="double",
        **{k: kw[k] for k in ("dft_size", "use_log", "use_power", "include_energy", "log_floor")},
    )
    assert np.abs(got.numpy() - want.numpy()).max() <= TOL_DIGIT


def test_double_pair_schedules():
    """'double' adds 13 pair terms and 'accurate' 10, smallest weight
    first and within one weight by ascending x plane."""
    _, tc = _pair(precision="double")
    pairs = K._double_pairs(tc.params, None, None)
    assert len(pairs) == 13 and pairs[:3] == [(1, 3), (2, 2), (3, 1)]
    assert pairs == jstft.digit_pair_schedule(4, 4, 4)
    _, ta = _pair(precision="accurate")
    assert len(K._double_pairs(ta.params, 4, 3)) == 10


@pytest.mark.parametrize("gate", ["long_frame", "no_layout"])
def test_double_gates_route_to_digit_path(gate):
    """Frames longer than 512 samples (40 ms at 16 kHz: 640) and params
    without the kernel layout run framing plus the plain digit path, as
    the JAX op does; the result matches JAX."""
    kw = dict(include_energy=True, precision="double")
    if gate == "long_frame":
        kw.update(frame_length_ms=40, frame_shift_ms=10)
    jc, tc = _pair(**kw)
    jparams, tparams = dict(jc.params), dict(tc.params)
    if gate == "no_layout":
        for params in (jparams, tparams):
            for key in [k for k in params if k.startswith("pdk_")]:
                del params[key]
    else:
        assert tc.frame_length == 640 and "pdk_mats" in tparams
    padded, mf = _padded(jc, seed=23)
    spec = _spec(jc, mf, True, False, True)
    want = np.asarray(
        JP.stft_feats_pallas_double(jnp.asarray(padded), jparams, interpret=True, **spec)
    )
    K.reset_launch_counts()
    got = K.stft_feats_double(torch.tensor(padded), tparams, **spec)
    assert K.launch_counts()["stft_feats_double"] == 0
    frames = TF.frame_padded(torch.tensor(padded), mf, tc.frame_length, tc.frame_shift)
    path = tstft.stft_feats_from_frames(
        frames, tparams, fft_mode="matmul", precision="double",
        **{k: spec[k] for k in ("dft_size", "use_log", "use_power", "include_energy", "log_floor")},
    )
    assert torch.equal(got, path)
    assert np.abs(got.numpy() - want).max() <= TOL_DIGIT


def test_double_wrapper_runs_plain_on_cpu_and_checks_layout():
    jc, tc = _pair(include_energy=True, precision="double")
    padded, mf = _padded(jc, seed=24)
    x = torch.tensor(padded)
    spec = _spec(jc, mf, True, False, True)
    K.reset_launch_counts()
    assert torch.equal(
        K.stft_feats_double(x, tc.params, **spec),
        K.stft_feats_double_plain(x, tc.params, **spec),
    )
    assert K.launch_counts()["stft_feats_double"] == 0
    with pytest.raises(ValueError):  # rows must be 2-D
        K.stft_feats_double(x[None], tc.params, **spec)
    with pytest.raises(ValueError):  # the layout's nb must match the DFT size
        K.stft_feats_double(x, tc.params, **{**spec, "dft_size": 1024})


def test_computer_routes_no_tier_to_double_kernel():
    """As in the JAX package, no computer route runs B4: the digit tiers
    take the int8 kernel (B2) or the plain digit path."""
    for precision in ("double", "accurate"):
        _, tc = _pair(precision=precision, fft_mode="pallas")
        assert tc._use_kernel(torch.device("cuda")) == "int8"
        assert "pdk_mats" in tc.params
