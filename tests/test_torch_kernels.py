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
TOL_DEFAULT = 1.5e-2  # the reduced float tier ('default'; pallas_stft.py:23-27)

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


@pytest.fixture
def pinned_numerics():
    """Fix the global state that sets the float tier's CPU arithmetic for
    the test, and give the earlier settings back after: torch on one thread (one
    reduction order), float32 products in IEEE fp32 (matmul precision and
    oneDNN), JAX with x64 on (as tests/conftest.py sets it) and no default
    matmul precision."""
    mkldnn = torch.backends.mkldnn.matmul
    saved = (
        torch.get_num_threads(),
        torch.get_float32_matmul_precision(),
        mkldnn.fp32_precision,
        jax.config.jax_enable_x64,
        jax.config.jax_default_matmul_precision,
    )
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    mkldnn.fp32_precision = "ieee"
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", None)
    try:
        yield
    finally:
        torch.set_num_threads(saved[0])
        torch.set_float32_matmul_precision(saved[1])
        mkldnn.fp32_precision = saved[2]
        jax.config.update("jax_enable_x64", saved[3])
        jax.config.update("jax_default_matmul_precision", saved[4])


def _close(got, want, tol, use_log):
    assert got.shape == want.shape
    rtol = 0.0 if use_log else RTOL_LINEAR
    err = np.abs(got - want).max()
    assert np.allclose(got, want, rtol=rtol, atol=tol), err


@pytest.mark.usefixtures("pinned_numerics")
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


@pytest.mark.usefixtures("pinned_numerics")
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
    assert torch.equal(
        K.stft_feats_double(x, tc.params, dft_size=jc.dft_size, **kw),
        K.stft_feats_double_plain(x, tc.params, dft_size=jc.dft_size, **kw),
    )
    flat = x.reshape(-1).contiguous()
    offsets = torch.tensor([0, 100], dtype=torch.int64)
    counts = torch.tensor([50, 3000], dtype=torch.int64)
    assert torch.equal(
        K.layout_rows(flat, offsets, counts, 4096),
        K.layout_rows_plain(flat, offsets, counts, 4096),
    )
    assert K.launch_counts() == {
        "stft_feats_rows": 0,
        "stft_feats_frames": 0,
        "stft_feats_int8": 0,
        "stft_feats_double": 0,
        "layout_rows": 0,
        "viterbi_path": 0,
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


@pytest.mark.parametrize(
    "kw,K_,dft",
    [
        (dict(frame_length_ms=24.375), 390, 512),  # rows padded to 416
        # nb = 196: the last 64-bin chunk holds 4 bins, the rest zero
        (dict(frame_length_ms=24.5, pad_to_nearest_power_of_two=False), 392, 392),
        (dict(frame_length_ms=24, pad_to_nearest_power_of_two=False), 384, 384),  # 3 whole chunks
        (dict(frame_length_ms=50), 800, 1024),  # 25 k-steps a member
    ],
    ids=["k390", "dft392", "dft384", "k800"],
)
def test_pack_groups_layout_decodes_to_gmats(kw, K_, dft):
    """The tensor-core layout the int8 kernel reads: (chunks, steps, 16, 2,
    8, 16) core matrices, a chunk's columns the (real, mixed) pairs of 64
    bins, k-steps of 32 rows through the members in group order, zero past
    K, past nb and in the padding k-steps."""
    _, tc = _pair(precision="double", **kw)
    gmats, offsets = tc.params["i8k_gmats"], tc.params["i8k_offsets"]
    assert (tc.frame_length, tc.dft_size) == (K_, dft)
    nb = dft // 2
    packed, steps, (n_groups, members, xs, svals) = K._pack_groups(gmats, offsets, K_)
    chunks, nk = -(-nb // 64), -(-K_ // 32)
    n_members = sum(len(xids) for _, xids, _, _ in offsets)
    assert steps == -(-n_members * nk // 4) * 4
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (chunks, steps, 16, 2, 8, 16)
    # the group table: ascending weight, x planes in five slots a group
    assert n_groups == len(offsets)
    for g, (s, xids, _, _) in enumerate(offsets):
        assert svals[g] == s and members[g] == len(xids)
        assert list(xs[5 * g : 5 * g + len(xids)]) == list(xids)
    # decode: rows (steps * 32) by interleaved columns (chunks * 128)
    # [chunk, step, column group, k half, column, k] -> [step, k half, k,
    # chunk, column group, column]
    dense = packed.numpy().transpose(1, 3, 5, 0, 2, 4).reshape(steps * 32, chunks * 128)
    pairs = dense.reshape(steps * 32, chunks * 64, 2)
    real, mixed = pairs[..., 0], pairs[..., 1]
    assert not real[:, nb:].any() and not mixed[:, nb:].any()
    assert not dense[n_members * nk * 32 :].any()  # the padding k-steps
    rows = np.concatenate([real[:, :nb], mixed[:, :nb]], axis=1)
    rows = rows[: n_members * nk * 32].reshape(n_members, nk * 32, 2 * nb)
    assert not rows[:, K_:].any()
    want = gmats.numpy().reshape(n_members, K_, 2 * nb)
    assert np.array_equal(rows[:, :K_], want)


def test_filter_spans_bound_the_nonzero_weights():
    """Each filter's span covers exactly its rows with a nonzero w_hi or
    w_lo weight, so the kernel's filter sums skip only exact zeros."""
    _, tc = _pair(precision="double")
    w_hi, w_lo = tc.params["i8k_w_hi"], tc.params["i8k_w_lo"]
    spans = K._filter_spans(w_hi, w_lo)
    assert spans.dtype == torch.int32 and tuple(spans.shape) == (w_hi.shape[1], 2)
    nz = ((w_hi != 0) | (w_lo != 0)).numpy()
    for c, (first, last) in enumerate(spans.tolist()):
        rows = np.flatnonzero(nz[:, c])
        assert (first, last) == (rows[0], rows[-1] + 1)
    empty = K._filter_spans(torch.zeros(5, 2), torch.zeros(5, 2))
    assert empty.tolist() == [[5, 0], [5, 0]]


def test_packed_groups_built_once_per_gmats():
    """The int8 wrapper packs a gmats tensor once and reuses the layout
    until the tensor changes in place."""
    _, tc = _pair(precision="double")
    gmats, offsets = tc.params["i8k_gmats"], tc.params["i8k_offsets"]
    first = K._packed_groups(gmats, offsets, tc.frame_length)
    assert K._packed_groups(gmats, offsets, tc.frame_length) is first
    gmats.add_(0)  # bumps the version: the packing is stale
    again = K._packed_groups(gmats, offsets, tc.frame_length)
    assert again is not first and torch.equal(again[0], first[0]) and again[1] == first[1]
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


# --- B1 / B3: the TF32 layout and its tiers --------------------------------

# (computer kwargs, K, dft, nb): dft 512 (the Nyquist cosine in the DC slot),
# dft 384 (3 whole chunks) and an odd dft 401 (no Nyquist bin: 201 bins, the
# DC slot empty, the last chunk 9 bins)
FLOAT_LAYOUTS = [
    (dict(frame_length_ms=25), 400, 512, 256),
    (dict(frame_length_ms=24, pad_to_nearest_power_of_two=False), 384, 384, 192),
    (dict(frame_length_ms=25.1, pad_to_nearest_power_of_two=False), 401, 401, 201),
]


def _float_dense(packed, steps):
    """The packed float layout back to dense ``(2, steps * 8, chunks *
    128)``: [hi, lo][k][column], columns (cos, mixed) by bin."""
    chunks = packed.shape[0]
    return packed.permute(2, 1, 4, 6, 0, 3, 5).reshape(2, steps * 8, chunks * 128)


@pytest.mark.parametrize(
    "kw,K_,dft,nb", FLOAT_LAYOUTS, ids=[f"dft{d}" for _, _, d, _ in FLOAT_LAYOUTS]
)
def test_pack_float_layout_decodes_to_dft(kw, K_, dft, nb):
    """The TF32 layout the float kernel reads: (chunks, steps, 2, 16, 2, 8,
    4) core matrices of hi and lo, hi + lo within the split's bound of the
    fp32 matrices, the Nyquist cosine in the DC slot (even dft only), zero
    past K and past nb; and the filter spans bound the nonzero weights."""
    tc = STFTFrameComputer(dict(BANK), device="cpu", **kw)
    assert (tc.frame_length, tc.dft_size) == (K_, dft)
    cos, sin, w = tc.params["dft_cos"], tc.params["dft_sin"], tc.params["weights"]
    half = dft // 2 + 1
    packed, got_nb, steps = K._pack_float(cos, sin)
    chunks = -(-nb // 64)
    assert got_nb == nb and steps == -(-K_ // 16) * 2
    assert packed.dtype == torch.float32
    assert tuple(packed.shape) == (chunks, steps, 2, 16, 2, 8, 4)
    hi, lo = _float_dense(packed, steps)
    for part in (hi, lo):  # TF32: the 13 low mantissa bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    pairs = (hi.double() + lo.double()).reshape(steps * 8, chunks * 64, 2)
    real, mixed = pairs[..., 0], pairs[..., 1]
    assert not real[K_:].any() and not mixed[K_:].any()
    assert not real[:, nb:].any() and not mixed[:, nb:].any()
    dc = cos[:, nb:] if dft % 2 == 0 else torch.zeros(K_, 1)
    assert (nb == half - 1) == (dft % 2 == 0)
    want = torch.cat([cos[:, :nb], dc, sin[:, 1:nb]], dim=1).double()
    got = torch.cat([real[:K_, :nb], mixed[:K_, :nb]], dim=1)
    # |x - hi - lo| <= 2^-11 |x - hi| <= 2^-22 |x|
    assert ((got - want).abs() <= 2.0**-22 * want.abs()).all()
    if dft % 2:
        assert not mixed[:, 0].any()
    spans = K._filter_spans(w)
    for c, (first, last) in enumerate(spans.tolist()):
        rows = np.flatnonzero(w[:, c].numpy())
        assert (first, last) == (rows[0], rows[-1] + 1)


def _emulate_float(frames, params, passes, *, use_log, use_power, include_energy, log_floor):
    """The float kernel's arithmetic on the CPU: the packed DFT operand,
    the frames split by the kernel's rounding, ``passes`` products (3:
    lo*hi + hi*lo + hi*hi; 1: hi*hi) summed exactly and rounded to fp32
    once, then the fp32 tail with the Nyquist bin from the DC slot."""
    cos, sin, w = params["dft_cos"], params["dft_sin"], params["weights"]
    packed, nb, steps = K._pack_float(cos, sin)
    b_hi, b_lo = _float_dense(packed, steps).double()
    x = torch.nn.functional.pad(frames, (0, steps * 8 - frames.shape[-1]))
    a_hi = K._tf32(x)
    a_lo = K._tf32(x - a_hi)
    acc = a_hi.double() @ b_hi
    if passes == 3:
        acc = a_lo.double() @ b_hi + a_hi.double() @ b_lo + acc
    pairs = acc.float().reshape(*acc.shape[:-1], -1, 2)[..., :nb, :]
    re, mixed = pairs[..., 0], pairs[..., 1]
    im = torch.cat([torch.zeros_like(mixed[..., :1]), mixed[..., 1:]], dim=-1)
    power = re * re + im * im
    spec = power if use_power else torch.sqrt(power)
    nyq = mixed[..., :1] * mixed[..., :1] if use_power else mixed[..., :1].abs()
    feats = spec @ w[:nb]
    if nb < w.shape[0]:
        feats = feats + nyq * w[nb]
    if use_log:
        feats = torch.log(torch.clamp_min(feats, log_floor))
    if include_energy:
        energy = torch.sum(frames * frames, dim=-1) / frames.shape[-1]
        if not use_power:
            energy = torch.sqrt(energy)
        if use_log:
            energy = torch.log(torch.clamp_min(energy, log_floor))
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("frame_length_ms", [25, 24.375], ids=["main", "k390"])
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_float_tier_emulation_within_tolerance(
    precision, frame_length_ms, include_energy, use_power, use_log
):
    """The float kernel's tiers emulated on the CPU from the packed
    operands: 3 passes within the fp32 tier's TOL_FLOAT / RTOL_LINEAR of
    the plain IEEE version, 1 pass (TF32) within TOL_DEFAULT."""
    tc = STFTFrameComputer(
        dict(BANK), device="cpu", frame_length_ms=frame_length_ms, use_power=use_power
    )
    x = torch.tensor(np.random.RandomState(75).randn(2, 4000).astype(np.float32))
    padded = TF.pad_signal_full(x, tc.frame_length, tc._pad_left)
    mf = TF.frame_count_np(4000, tc.frame_length, tc.frame_shift)
    spec = dict(use_log=use_log, use_power=use_power, include_energy=include_energy, log_floor=1e-5)
    want = K.stft_feats_rows_plain(
        padded, tc.params, num_frames=mf, frame_length=tc.frame_length,
        frame_shift=tc.frame_shift, **spec,
    )
    frames = TF.frame_padded(padded, mf, tc.frame_length, tc.frame_shift)
    got = _emulate_float(frames, tc.params, K._float_passes(precision), **spec)
    if precision == "highest":
        _close(got.numpy(), want.numpy(), TOL_FLOAT, use_log)
    else:
        rtol = 0.0 if use_log else TOL_DEFAULT
        assert np.allclose(got.numpy(), want.numpy(), rtol=rtol, atol=TOL_DEFAULT)


def test_float_tiers_pick_passes():
    """'highest' (and None) and 'high' run three split passes, 'default'
    one TF32 pass; a digit tier is no float tier."""
    assert [K._float_passes(p) for p in (None, "highest", "high", "default")] == [3, 3, 3, 1]
    with pytest.raises(ValueError):
        K._float_passes("double")


def test_packed_float_built_once_per_dft_cos():
    """The float wrappers pack a dft_cos tensor once and pack again when it
    or its dft_sin changes in place."""
    tc = STFTFrameComputer(dict(BANK), device="cpu")
    cos, sin = tc.params["dft_cos"], tc.params["dft_sin"]
    first = K._packed_float(cos, sin)
    assert K._packed_float(cos, sin) is first
    sin.add_(0)
    again = K._packed_float(cos, sin)
    assert again is not first and torch.equal(again[0], first[0])
    slot = id(cos)
    del tc, cos, sin
    assert slot not in K._PACKED

