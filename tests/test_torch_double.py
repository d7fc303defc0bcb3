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


# --- the bf16 tensor-core layout and arithmetic of the CUDA kernel ----------

# (computer kwargs, K, dft): the main shape; K 390 (rows padded to 416);
# dft 384 (nb 192: three whole chunks); K 512 at dft 1024 (nb 512), built
# by hand since the computer pads 512 samples to a 512-point DFT
DOUBLE_LAYOUTS = [
    (dict(), 400, 512),
    (dict(frame_length_ms=24.375), 390, 512),
    (dict(frame_length_ms=24, pad_to_nearest_power_of_two=False), 384, 384),
    (dict(frame_length_ms=32), 512, 1024),
]
DOUBLE_LAYOUT_IDS = ["main", "k390", "dft384", "k512-dft1024"]


def _pdk_params(kw, dft, precision="double", window="hann"):
    """The port's ``pdk_*`` params on the CPU; at a ``dft`` the computer
    does not pick (K 512, dft 1024) rebuilt from its window and a bank
    folded at that size."""
    kw = {"frame_length_ms": 25, "frame_shift_ms": 10, **kw}
    tc = STFTFrameComputer(
        dict(BANK), device="cpu", precision=precision, window_function=window, **kw
    )
    params = dict(tc.params)
    if tc.dft_size != dft:
        C, S = tstft.windowed_dft_matrices(tc._window, dft)
        W = tstft.fold_bank_to_weights(tc._bank, dft, False)
        pdk = tstft.digit_kernel_matrices(C, S, W)
        params["pdk_cos_scale"] = float(pdk.pop("cos_scale"))
        params.update({"pdk_" + k: torch.tensor(v) for k, v in pdk.items()})
    return tc, params


def _double_dense(packed, steps):
    """The packed bf16 layout back to dense float64 ``(n_m, steps * 16,
    chunks * 128)``: [plane][k][column], columns (real, mixed) by bin."""
    n_m, chunks = packed.shape[:2]
    return packed.permute(0, 2, 4, 6, 1, 3, 5).reshape(n_m, steps * 16, chunks * 128).double()


@pytest.mark.parametrize("kw,K_,dft", DOUBLE_LAYOUTS, ids=DOUBLE_LAYOUT_IDS)
def test_pack_double_layout_decodes_to_pdk_mats(kw, K_, dft):
    """The layout the bf16 kernel reads: (n_m, chunks, steps, 16, 2, 8, 8)
    core matrices, every digit exact in bf16, a chunk's columns the (real,
    mixed) pairs of 64 bins with the Nyquist cosine in bin 0's mixed slot,
    zero past K and past nb; the filter spans bound the nonzero rows of
    w_hi | w_lo."""
    tc, params = _pdk_params(kw, dft)
    mats = params["pdk_mats"]
    nb = dft // 2
    assert tuple(mats.shape) == (4, K_, 2 * nb)
    assert torch.equal(mats.to(torch.bfloat16).to(torch.float32), mats)
    assert mats.abs().max() <= 256
    packed, steps = K._pack_double(mats)
    chunks = -(-nb // 64)
    assert steps == -(-K_ // 32) * 2
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (4, chunks, steps, 16, 2, 8, 8)
    pairs = _double_dense(packed, steps).reshape(4, steps * 16, chunks * 64, 2)
    real, mixed = pairs[..., 0], pairs[..., 1]
    assert not real[:, K_:].any() and not mixed[:, K_:].any()
    assert not real[..., nb:].any() and not mixed[..., nb:].any()
    got = torch.cat([real[:, :K_, :nb], mixed[:, :K_, :nb]], dim=-1)
    assert torch.equal(got, mats.double())
    # bin 0's mixed slot: the digit planes of the Nyquist cosine column
    C, _ = tstft.windowed_dft_matrices(tc._window, dft)
    nyq, _ = tstft.digitize_matrix(C, 4, tstft._PDK_BASE)
    cos_planes, _ = tstft.digitize_matrix(C, 4, tstft._PDK_BASE)
    assert np.array_equal(mixed[:, :K_, 0].numpy(), nyq[:, :, nb])
    assert np.array_equal(real[:, :K_, :nb].numpy(), cos_planes[:, :, :nb])
    w_hi, w_lo = params["pdk_w_hi"], params["pdk_w_lo"]
    spans = K._filter_spans(w_hi, w_lo)
    nz = ((w_hi != 0) | (w_lo != 0)).numpy()
    for c, (first, last) in enumerate(spans.tolist()):
        rows = np.flatnonzero(nz[:, c])
        assert (first, last) == (rows[0], rows[-1] + 1)


def test_packed_double_built_once_per_pdk_mats():
    """The B4 wrapper packs a pdk_mats tensor once and packs again when it
    changes in place."""
    tc, params = _pdk_params({}, 512)
    mats = params["pdk_mats"]
    first = K._packed_double(mats)
    assert K._packed_double(mats) is first
    mats.add_(0)  # bumps the version: the packing is stale
    again = K._packed_double(mats)
    assert again is not first and torch.equal(again[0], first[0])
    slot = id(mats)
    del tc, params, mats
    assert slot not in K._PACKED


def _digits(frames, n_x):
    """The x digit planes and scales of ``frames``, as the kernel computes
    them: each round takes ``d = (256 v + 1.5 * 2^23) - 1.5 * 2^23`` and
    keeps ``256 v - d`` (float32)."""
    m = torch.clamp_min(frames.abs().amax(-1, keepdim=True), 1e-30)
    scale = (((m.contiguous().view(torch.int32) >> 23) + 2) << 23).view(torch.float32)
    v = frames * (1.0 / scale)
    magic = torch.tensor(1.5 * 2.0**23, dtype=torch.float32)
    planes = []
    for _ in range(n_x):
        d = (v * 256 + magic) - magic
        v = v * 256 - d
        planes.append(d)
    return planes, scale


def _emulate_double(padded, params, spec, n_x=None, cutoff=None):
    """The B4 kernel's arithmetic on the CPU from the packed operand: per
    64-bin chunk and pair, the k-steps of 16 in order, each a float64
    product of bf16-exact digits (an exact integer), the pair's sum weighted
    and added into the fp32 accumulator in pair order; then the fp32 tail.
    Returns ``(features, {pair: g})``."""
    frames = TF.frame_padded(padded, spec["num_frames"], spec["frame_length"], spec["frame_shift"])
    K_ = frames.shape[-1]
    pairs = K._double_pairs(params, n_x, cutoff)
    planes, scale = _digits(frames, max(i for i, _ in pairs) + 1)
    packed, steps = K._pack_double(params["pdk_mats"])
    dense = _double_dense(packed, steps)
    chunks = packed.shape[1]
    nb = params["pdk_mask"].shape[0]
    x = [torch.nn.functional.pad(p, (0, steps * 16 - K_)).double() for p in planes]
    assert all(torch.equal(p.to(torch.bfloat16).double(), p) for p in x)
    acc = torch.zeros(*frames.shape[:-1], chunks * 128)
    gs = {}
    for c in range(chunks):
        cols = slice(128 * c, 128 * c + 128)
        part = torch.zeros(*frames.shape[:-1], 128)
        for i, j in pairs:
            g = torch.zeros(*frames.shape[:-1], 128, dtype=torch.float64)
            for u in range(steps):
                ks = slice(16 * u, 16 * u + 16)
                g = g + x[i][..., ks] @ dense[j, ks, cols]
            gs.setdefault((i, j), []).append(g)
            part = part + (g.float() * float(tstft._PDK_BASE) ** -(i + j + 2))
        acc[..., cols] = part
    pairs_ = acc.reshape(*acc.shape[:-1], -1, 2)[..., :nb, :]
    interleaved = torch.cat([pairs_[..., 0], pairs_[..., 1]], dim=-1)
    with tstft.ieee_float32():
        feats = K._digit_tail(interleaved, scale, params, "pdk_", use_power=spec["use_power"])
    if spec["use_log"]:
        feats = tstft.floor_log(feats, spec["log_floor"])
    if spec["include_energy"]:
        energy = tstft.frame_energy(
            frames, use_log=spec["use_log"], use_power=spec["use_power"],
            log_floor=spec["log_floor"],
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats, {p: torch.cat(v, dim=-1) for p, v in gs.items()}


def _plain_pair_sums(padded, params, spec, n_x=None, cutoff=None):
    """``{(i, j): integer pair sums}`` of the plain version's digits, in
    float64 (exact), columns in the chunk layout's (real, mixed) order."""
    frames = TF.frame_padded(padded, spec["num_frames"], spec["frame_length"], spec["frame_shift"])
    pairs = K._double_pairs(params, n_x, cutoff)
    planes, _ = _digits(frames, max(i for i, _ in pairs) + 1)
    mats = params["pdk_mats"].double()
    nb = mats.shape[2] // 2
    out = {}
    for i, j in pairs:
        g = planes[i].double() @ mats[j]
        out[(i, j)] = torch.stack([g[..., :nb], g[..., nb:]], dim=-1).flatten(-2)
    return out


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("kw", [dict(), dict(frame_length_ms=24.375)], ids=["main", "k390"])
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS[::3], ids=COMBO_IDS[::3])
def test_double_kernel_emulation_matches_plain(tier, kw, include_energy, use_power, use_log):
    """The kernel's k-step order over the packed operand gives the plain
    version's pair integers exactly, and features within TOL_DIGIT of
    ``stft_feats_double_plain``."""
    n_x, cutoff = TIERS[tier]
    tc, params = _pdk_params(dict(use_power=use_power, **kw), 512, precision=tier)
    x = torch.tensor(np.random.RandomState(31).randn(2, 3000).astype(np.float32))
    padded = TF.pad_signal_full(x, tc.frame_length, tc._pad_left)
    spec = dict(
        num_frames=TF.frame_count_np(3000, tc.frame_length, tc.frame_shift),
        frame_length=tc.frame_length, frame_shift=tc.frame_shift, dft_size=tc.dft_size,
        use_log=use_log, use_power=use_power, include_energy=include_energy, log_floor=1e-5,
    )
    got, gs = _emulate_double(padded, params, spec, n_x, cutoff)
    want_g = _plain_pair_sums(padded, params, spec, n_x, cutoff)
    nb = params["pdk_mask"].shape[0]
    assert set(gs) == set(want_g)
    for pair, g in gs.items():
        assert torch.equal(g[..., : 2 * nb], want_g[pair]), pair
        assert not g[..., 2 * nb :].any()
    want = K.stft_feats_double_plain(padded, params, n_x=n_x, cutoff=cutoff, **spec)
    _close(got.numpy(), want.numpy(), use_log)


def test_digit_adversary_drives_pair_sums_to_2_23():
    """The adversary rows at K = 512 with the Hamming window: the plain
    version's pair sums reach at least 2^23 (and at most the 2^24 bound of
    K * 128 * 256) on the DC and Nyquist slots, for pairs (0, 0) and (1, 0);
    Hann's plane-0 digits are half as large, so it stays below."""
    rows = K._digit_adversary_rows(3, 9000)
    assert rows.dtype == torch.float32 and tuple(rows.shape) == (3, 9000)
    for window, reaches in (("hamming", True), ("hann", False)):
        tc, params = _pdk_params(dict(frame_length_ms=32), 1024, window=window)
        assert tc.frame_length == 512
        padded = TF.pad_signal_full(rows, tc.frame_length, tc._pad_left)
        spec = dict(
            num_frames=TF.frame_count_np(9000, 512, tc.frame_shift), frame_length=512,
            frame_shift=tc.frame_shift,
        )
        gs = _plain_pair_sums(padded, params, spec)
        peak = max(g.abs().max().item() for g in gs.values())
        assert peak <= 2**24
        assert (peak >= 2**23) == reaches, (window, peak)
        if reaches:
            for pair in ((0, 0), (1, 0)):
                dc, nyq = gs[pair][..., 0], gs[pair][..., 1]  # bin 0's real and mixed
                assert dc[0].abs().max() >= 2**23 and nyq[1].abs().max() >= 2**23, pair
