"""The CUDA kernels of speech_tpu_torch against their plain versions, and
the other device paths against the CPU, on a GPU.  Every test here is
marked ``cuda`` and skips without one.

This file imports no jax, so it also runs where only PyTorch is installed;
on a GPU machine, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops import framing as TF
from speech_tpu_torch.ops import stft as TS
from speech_tpu_torch.ops import stft_kernels as K

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
TOL_FLOAT = 1e-4  # f32 reduction order (tests/test_pallas.py:55)
# float32 gradients vs float64, relative to each tensor's largest: the
# float tier's 1e-4; TF32 keeps about three decimal digits
TOL_GRAD = 1e-4
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


def _close(got, want, tol, use_log, rtol_linear=RTOL_LINEAR):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    rtol = 0.0 if use_log else rtol_linear
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


# the float kernel also takes an odd dft (401: no Nyquist bin) and 150 and
# 300 ms frames (K = 2400 and 4800: the frames route stages slabs of K)
FLOAT_SHAPES = SHAPES + [(25.1, 10, False), (150, 10, True), (300, 10, True)]
FLOAT_SHAPE_IDS = SHAPE_IDS + ["dft401", "k2400", "k4800"]
# precision -> (tolerance, relative tolerance on linear features)
FLOAT_TIERS = {"highest": (TOL_FLOAT, RTOL_LINEAR), "default": (TOL_DEFAULT, TOL_DEFAULT)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(FLOAT_TIERS))
@pytest.mark.parametrize("shape", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_float_kernels_match_plain(shape, include_energy, use_power, use_log, precision):
    dev = _device()
    tol, rtol = FLOAT_TIERS[precision]
    tc, padded, mf = _setup(dev, shape, 80, use_power=use_power)
    spec = dict(use_log=use_log, use_power=use_power, include_energy=include_energy, log_floor=1e-5)
    kw = dict(num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift, **spec)
    K.reset_launch_counts()
    _close(
        K.stft_feats_rows(padded, tc.params, precision=precision, **kw),
        K.stft_feats_rows_plain(padded, tc.params, **kw),
        tol, use_log, rtol,
    )
    frames = TF.frame_padded(padded, mf, tc.frame_length, tc.frame_shift).contiguous()
    _close(
        K.stft_feats_frames(frames, tc.params, precision=precision, **spec),
        K.stft_feats_frames_plain(frames, tc.params, **spec),
        tol, use_log, rtol,
    )
    counts = K.launch_counts()
    assert (counts["stft_feats_rows"], counts["stft_feats_frames"]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "precision,frame_length_ms",
    [("highest", 25), ("default", 25), ("highest", 150)],
    ids=["highest", "default", "highest-k2400"],
)
def test_float_kernel_repeats_bitwise(precision, frame_length_ms):
    """No atomics and a fixed order of every sum: 100 calls on one ragged
    int16 batch through the float kernel give the same bits, within the
    tier's tolerance of float64.  Not of the CPU's float32 plain path: on
    these rows it read 1.78e-4 from float64 in one full run of this file
    (9.95e-7 in others; the card read 7.41e-7 in both), so it cannot hold
    the card to 1e-4."""
    dev = _device()
    rows = _int8_rows("silence-int16", 24000)
    lens = np.array([24000, 19000, 24000])
    kw = dict(frame_length_ms=frame_length_ms, frame_shift_ms=10, use_log=True, use_power=False)
    gpu = STFTFrameComputer(dict(BANK), device=dev, precision=precision, fft_mode="pallas", **kw)
    want, want_n = STFTFrameComputer(dict(BANK), device="cpu", dtype="float64", **kw).compute_batch(
        rows.astype(np.float64), lens
    )
    K.reset_launch_counts()
    first, _ = gpu.compute_batch(rows, lens)
    assert K.launch_counts()["stft_feats_rows"] == 1
    for row, m in enumerate(want_n.tolist()):
        _close(first[row, :m].cpu().double(), want[row, :m], FLOAT_TIERS[precision][0], True)
    differ = sum(not torch.equal(gpu.compute_batch(rows, lens)[0], first) for _ in range(100))
    assert differ == 0, f"{differ} of 100 calls differ from the first"


def _int8_rows(kind, n):
    """Three rows of ``n`` samples: 'noise' is unit noise; 'silence-int16'
    is full-scale int16 noise (clipped at -32768 and 32767) with a silent
    stretch of several frames in every row and a wholly silent last row."""
    rng = np.random.RandomState(81)
    if kind == "noise":
        return rng.randn(3, n).astype(np.float32)
    pcm = np.round(rng.randn(3, n) * 20000).clip(-32768, 32767).astype(np.int16)
    pcm[:, n // 4 : n // 4 + 2000] = 0
    pcm[2] = 0
    return pcm


# the int8 kernel also takes K = 392 with dft 392 (nb = 196, so its last
# 64-bin chunk holds 4 bins) and 50 ms frames (K = 800: 32-frame tiles on
# mma.sync, as 64 frames of digit planes do not fit in shared memory)
INT8_SHAPES = SHAPES + [(24.5, 10, False), (50, 10, True)]
INT8_SHAPE_IDS = SHAPE_IDS + ["dft392", "k800"]
# (kind, samples): 9000 samples are one partial 64-frame tile a row; 24000
# are two full tiles and a partial one (150 frames)
INT8_SIGNALS = [("noise", 9000), ("noise", 24000), ("silence-int16", 24000)]
INT8_SIGNAL_IDS = ["short", "long", "silence-int16"]


@pytest.mark.cuda
@pytest.mark.parametrize("signal", INT8_SIGNALS, ids=INT8_SIGNAL_IDS)
@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=INT8_SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_int8_kernel_matches_plain(shape, precision, signal, include_energy, use_power, use_log):
    dev = _device()
    fl_ms, fs_ms, pow2 = shape
    kind, n = signal
    spec = dict(use_log=use_log, use_power=use_power, include_energy=include_energy)
    tc = STFTFrameComputer(
        dict(BANK), frame_length_ms=fl_ms, frame_shift_ms=fs_ms,
        pad_to_nearest_power_of_two=pow2, device=dev, precision=precision, **spec,
    )
    rows = _int8_rows(kind, n)
    x = torch.tensor(rows.astype(np.float32) / (32768.0 if kind != "noise" else 1.0), device=dev)
    padded = TF.pad_signal_full(x, tc.frame_length, tc._pad_left)
    mf = TF.frame_count_np(n, tc.frame_length, tc.frame_shift)
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=tc.dft_size, log_floor=1e-5, **spec,
    )
    K.reset_launch_counts()
    got = K.stft_feats_int8(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_int8"] == 1
    _close(got, K.stft_feats_int8_plain(padded, tc.params, **kw), TOL_INT8, use_log)
    if kind == "noise":
        return
    # the same int16 rows through the computer: the card against the CPU
    cpu = STFTFrameComputer(
        dict(BANK), frame_length_ms=fl_ms, frame_shift_ms=fs_ms,
        pad_to_nearest_power_of_two=pow2, device="cpu", precision=precision, **spec,
    )
    lens = np.array([n, n - 5000, n])
    got, got_n = tc.compute_batch(rows, lens)
    want, want_n = cpu.compute_batch(rows, lens)
    assert torch.equal(got_n.cpu(), want_n)
    for row, m in enumerate(want_n.tolist()):
        _close(got[row, :m].cpu(), want[row, :m], TOL_INT8, use_log)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize(
    "shape",
    [(125, 10, True), (150, 10, True), (300, 10, True), (25, 25, True)],
    ids=["k2000", "k2400", "k4800", "shift400"],
)
def test_int8_kernel_long_frames_and_shifts(shape, precision):
    """125 ms frames (K = 2000, dft 2048): only 16-frame tiles fit; 150 and
    300 ms frames (K = 2400 and 4800): not even those, so 64-frame tiles
    hold the digit planes in slabs of K; a 25 ms shift: a block's samples
    do not fit in shared memory, so the kernel reads them from device
    memory."""
    dev = _device()
    tc, padded, mf = _setup(dev, shape, 85, precision=precision)
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=tc.dft_size, use_log=True, use_power=False, include_energy=True,
        log_floor=1e-5,
    )
    K.reset_launch_counts()
    got = K.stft_feats_int8(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_int8"] == 1
    _close(got, K.stft_feats_int8_plain(padded, tc.params, **kw), TOL_INT8, True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "precision,frame_length_ms,num_filts",
    [("double", 25, 40), ("accurate", 25, 40), ("double", 150, 40), ("double", 25, 1489)],
    ids=["double", "accurate", "double-k2400", "double-1489"],
)
def test_int8_kernel_repeats_bitwise(precision, frame_length_ms, num_filts):
    """No atomics and a fixed order of every sum: 100 calls on one ragged
    int16 batch give the same bits, within TOL_INT8 of the CPU (150 ms
    frames: the planes in slabs of K; 1,489 filters: two filter groups,
    through ``compute_batch``)."""
    dev = _device()
    rows = _int8_rows("silence-int16", 24000)
    lens = np.array([24000, 19000, 24000])
    kw = dict(frame_length_ms=frame_length_ms, frame_shift_ms=10, precision=precision,
              use_log=False, use_power=False)
    bank = dict(BANK, num_filts=num_filts)
    gpu = STFTFrameComputer(dict(bank), device=dev, **kw)
    want, want_n = STFTFrameComputer(dict(bank), device="cpu", **kw).compute_batch(rows, lens)
    first, _ = gpu.compute_batch(rows, lens)
    for row, m in enumerate(want_n.tolist()):
        _close(first[row, :m].cpu(), want[row, :m], TOL_INT8, False)
    differ = sum(not torch.equal(gpu.compute_batch(rows, lens)[0], first) for _ in range(100))
    assert differ == 0, f"{differ} of 100 calls differ from the first"


# (n_x, cutoff) of the base-256 digit kernel's tiers: 'double' the
# defaults (4, 4), 13 pairs; 'accurate' (4, 3), 10 pairs
DOUBLE_TIERS = {"double": {}, "accurate": dict(n_x=4, cutoff=3)}


# the shapes of the other kernels, and the digit adversary
# (K._digit_adversary_rows: pair sums past 2^23) at K 512 with the Hamming
# window and dft 1024 (nb 512), params built by hand since the computer
# pads 512 samples to a 512-point DFT
ADVERSARY = "k512-dft1024-adversary"
DOUBLE_SHAPES = SHAPES + [ADVERSARY]
DOUBLE_SHAPE_IDS = SHAPE_IDS + [ADVERSARY]


def _double_case(dev, shape, seed, *, use_power, precision):
    """``(params, padded, kwargs of the B4 call)`` of one shape."""
    if shape != ADVERSARY:
        tc, padded, mf = _setup(dev, shape, seed, use_power=use_power, precision=precision)
        params, dft = tc.params, tc.dft_size
    else:
        tc = STFTFrameComputer(
            dict(BANK), frame_length_ms=32, frame_shift_ms=10, window_function="hamming",
            device=dev, use_power=use_power, precision=precision,
        )
        dft = 1024
        C, S = TS.windowed_dft_matrices(tc._window, dft)
        W = TS.fold_bank_to_weights(tc._bank, dft, use_power)
        pdk = TS.digit_kernel_matrices(C, S, W, ndig=tc.params["pdk_mats"].shape[0])
        params = {"pdk_cos_scale": float(pdk.pop("cos_scale"))}
        params.update({"pdk_" + k: torch.tensor(v, device=dev) for k, v in pdk.items()})
        n = 9000
        padded = TF.pad_signal_full(K._digit_adversary_rows(3, n).to(dev), 512, tc._pad_left)
        mf = TF.frame_count_np(n, 512, tc.frame_shift)
    kw = dict(
        num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        dft_size=dft, use_power=use_power, **DOUBLE_TIERS[precision],
    )
    return params, padded, kw


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DOUBLE_TIERS))
@pytest.mark.parametrize("shape", DOUBLE_SHAPES, ids=DOUBLE_SHAPE_IDS)
@pytest.mark.parametrize("include_energy,use_power,use_log", COMBOS, ids=COMBO_IDS)
def test_double_kernel_matches_plain(shape, precision, include_energy, use_power, use_log):
    dev = _device()
    params, padded, kw = _double_case(dev, shape, 83, use_power=use_power, precision=precision)
    kw.update(use_log=use_log, include_energy=include_energy, log_floor=1e-5)
    K.reset_launch_counts()
    got = K.stft_feats_double(padded, params, **kw)
    assert K.launch_counts()["stft_feats_double"] == 1
    _close(got, K.stft_feats_double_plain(padded, params, **kw), TOL_INT8, use_log)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DOUBLE_TIERS))
@pytest.mark.parametrize(
    "shape",
    [(25, 25, True), (25, 10.0625, True), (32, 16, True), (25, 16, True)],
    ids=["unstaged-shift400", "odd-shift161", "unstaged-k512-shift256", "unstaged-k400-shift256"],
)
def test_double_kernel_sample_paths(shape, precision):
    """The kernel's other two ways to its samples: a 25 ms shift (400
    samples), where a block's 128 frames of samples do not fit in shared
    memory and are read from device memory; and an odd shift (161 samples),
    where the staged sample pairs are not 8-byte aligned and load one by
    one.  A 16 ms shift (256 samples) at K 512 and K 400 leaves room for the
    samples beside a ring of 2 stages but not of 3, the least depth the
    ring runs at, so they too are read from device memory."""
    dev = _device()
    params, padded, kw = _double_case(dev, shape, 87, use_power=False, precision=precision)
    kw.update(use_log=True, include_energy=True, log_floor=1e-5)
    K.reset_launch_counts()
    got = K.stft_feats_double(padded, params, **kw)
    assert K.launch_counts()["stft_feats_double"] == 1
    _close(got, K.stft_feats_double_plain(padded, params, **kw), TOL_INT8, True)


def _bank_case(dev, num_filts, seed, frame_length_ms=25, **kw):
    """``(computer, padded rows, kwargs of a kernel call)`` for a bank of
    ``num_filts`` filters at the main shape (16 kHz, 25 ms, 10 ms, dft
    512) or at ``frame_length_ms``."""
    tc = STFTFrameComputer(
        dict(BANK, num_filts=num_filts), frame_length_ms=frame_length_ms, frame_shift_ms=10,
        device=dev, **kw,
    )
    n = 9000
    x = torch.tensor(np.random.RandomState(seed).randn(3, n).astype(np.float32), device=dev)
    padded = TF.pad_signal_full(x, tc.frame_length, tc._pad_left)
    call = dict(
        num_frames=TF.frame_count_np(n, tc.frame_length, tc.frame_shift),
        frame_length=tc.frame_length, frame_shift=tc.frame_shift,
        use_power=False, use_log=True, include_energy=True, log_floor=1e-5,
    )
    return tc, padded, call


def _one_group_limit(plan_of):
    """The most filters ``plan_of(n)`` keeps in one group."""
    lo, hi = 1, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if plan_of(mid)["groups"] == 1:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("num_filts", [161, 162, 370, 512])
def test_double_kernel_filter_limit(num_filts):
    """B4 keeps two fp32 sums of its 128 frames a filter in shared memory
    beside a ring of at least 3 stages, so past 161 filters (the samples
    then read from device memory, the ring at its least depth) it splits
    the bank into filter groups, one grid slice each, every group walking
    only the 64-bin chunks its filters touch.  Every bank matches the plain
    version; the main path's 40 filters stay one group with staged
    samples."""
    dev = _device()
    tc, padded, kw = _bank_case(dev, num_filts, 88, precision="double")
    kw["dft_size"] = tc.dft_size
    plan = functools.partial(
        K.double_launch_plan, dev, frame_shift=tc.frame_shift, frame_length=tc.frame_length
    )
    assert _one_group_limit(lambda c: plan(n_filts=c)) == 161
    assert plan(n_filts=40) == dict(groups=1, group_filters=40, stages=8, span=1)
    groups = plan(n_filts=num_filts)["groups"]
    assert (groups == 1) == (num_filts <= 161), groups
    K.reset_launch_counts()
    got = K.stft_feats_double(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_double"] == 1
    _close(got, K.stft_feats_double_plain(padded, tc.params, **kw), TOL_INT8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DOUBLE_TIERS))
def test_double_kernel_filter_groups_all_columns(precision):
    """370 filters in groups, power features without log or energy: every
    column (the Nyquist-weighted top filter in the last group, the lowest
    in the first) matches the plain version."""
    dev = _device()
    tc, padded, kw = _bank_case(dev, 370, 89, precision="double", use_power=True)
    kw.update(dft_size=tc.dft_size, use_power=True, use_log=False, include_energy=False,
              **DOUBLE_TIERS[precision])
    got = K.stft_feats_double(padded, tc.params, **kw)
    _close(got, K.stft_feats_double_plain(padded, tc.params, **kw), TOL_INT8, False)


@pytest.mark.cuda
def test_float_kernel_filter_limit():
    """B1/B3 keep one fp32 sum of 128 frames a filter in shared memory;
    the one-group limit at K 400 is measured here (and in ROADMAP.md), and
    banks past it split into filter groups: the limit, one filter more,
    370 and 512 filters all hold within TOL_FLOAT of float64 through both
    routes.  The reference is float64, not the fp32 plain version: on such
    banks of narrow filters the fp32 plain version is itself up to 9.4e-5
    from float64 on log features (tools/torch_float_fold.py), so two fp32
    roundings would be compared.  The main path's 40 filters stay one group
    with staged samples."""
    dev = _device()
    plan = functools.partial(K.float_launch_plan, dev, frame_shift=160, frame_length=400)
    limit = _one_group_limit(lambda c: plan(n_filts=c))
    assert 200 <= limit < 370, limit
    assert plan(n_filts=40)["groups"] == 1 and plan(n_filts=40)["span"] == 1
    for num_filts in (limit, limit + 1, 370, 512):
        assert (plan(n_filts=num_filts)["groups"] == 1) == (num_filts <= limit)
        tc, padded, kw = _bank_case(dev, num_filts, 90)
        c64 = STFTFrameComputer(
            dict(BANK, num_filts=num_filts), frame_length_ms=25, frame_shift_ms=10,
            device=dev, dtype="float64",
        )
        frames = TF.frame_padded(
            padded, kw["num_frames"], tc.frame_length, tc.frame_shift
        ).contiguous()
        spec = {k: kw[k] for k in ("use_power", "use_log", "include_energy", "log_floor")}
        want = TS.stft_feats_from_frames(
            frames.double(), c64.params, dft_size=c64.dft_size, **spec
        ).float()
        K.reset_launch_counts()
        _close(K.stft_feats_rows(padded, tc.params, precision="highest", **kw), want,
               TOL_FLOAT, True)
        _close(K.stft_feats_frames(frames, tc.params, precision="highest", **spec), want,
               TOL_FLOAT, True)
        counts = K.launch_counts()
        assert (counts["stft_feats_rows"], counts["stft_feats_frames"]) == (1, 1), num_filts


# the most filters one B2 group takes at K 400 / dft 512: 16-frame tiles, a
# ring of two stages and one k-step of planes beside two fp32 sums of 16
# frames a filter fill the H100's 232,448 bytes
# (csrc/int8_kernels.cu:int8_smem_bytes)
INT8_FILTER_LIMIT = 1488


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize(
    "num_filts", [INT8_FILTER_LIMIT, INT8_FILTER_LIMIT + 1, 2 * INT8_FILTER_LIMIT + 2],
    ids=["limit", "one-more", "twice"],
)
def test_int8_kernel_filter_limit(num_filts, precision):
    """B2's one-group limit at K 400 is measured here (and in ROADMAP.md);
    the limit, one filter more (two groups) and twice that (three) all
    match the plain version in one launch.  The main path's 40 filters stay
    one group of 64-frame tiles with whole planes and staged samples."""
    dev = _device()
    plan = functools.partial(K.int8_launch_plan, dev, frame_shift=160, frame_length=400)
    assert _one_group_limit(lambda c: plan(n_filts=c)) == INT8_FILTER_LIMIT
    assert plan(n_filts=40) == dict(groups=1, group_filters=40, stages=3, span=1, tile=64,
                                    slab=13)
    groups = plan(n_filts=num_filts)["groups"]
    assert groups == -(-num_filts // INT8_FILTER_LIMIT), (num_filts, groups)
    tc, padded, kw = _bank_case(dev, num_filts, 91, precision=precision)
    kw["dft_size"] = tc.dft_size
    K.reset_launch_counts()
    got = K.stft_feats_int8(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_int8"] == 1
    _close(got, K.stft_feats_int8_plain(padded, tc.params, **kw), TOL_INT8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["double", "accurate"])
def test_int8_filter_groups_match_one_group_bitwise(precision):
    """A bank of 1,489 filters runs as two groups; its first 1,488 columns
    alone (the same weights) run as one.  Every column the two launches
    share, the energy column too, has the same bits."""
    dev = _device()
    tc, padded, kw = _bank_case(dev, INT8_FILTER_LIMIT + 1, 92, precision=precision)
    kw["dft_size"] = tc.dft_size
    plan = functools.partial(K.int8_launch_plan, dev, frame_shift=160, frame_length=400)
    assert plan(n_filts=INT8_FILTER_LIMIT + 1)["groups"] == 2
    assert plan(n_filts=INT8_FILTER_LIMIT)["groups"] == 1
    one = dict(tc.params)
    for key in ("i8k_w_hi", "i8k_w_lo", "i8k_w_nyq"):
        one[key] = tc.params[key][:, :INT8_FILTER_LIMIT].contiguous()
    grouped = K.stft_feats_int8(padded, tc.params, **kw)
    single = K.stft_feats_int8(padded, one, **kw)
    torch.cuda.synchronize()
    assert torch.equal(grouped[..., : INT8_FILTER_LIMIT + 1], single)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["double", "accurate"])
def test_int8_filter_groups_with_slabs(precision):
    """150 ms frames (K 2400, dft 4096) and 1,489 filters: two groups of
    16-frame tiles, each holding its digit planes in slabs of K, against
    the plain version."""
    dev = _device()
    p = K.int8_launch_plan(dev, frame_shift=160, frame_length=2400, n_filts=INT8_FILTER_LIMIT + 1)
    assert p["groups"] == 2 and p["slab"] < 75, p
    tc, padded, kw = _bank_case(dev, INT8_FILTER_LIMIT + 1, 93, frame_length_ms=150,
                                precision=precision)
    kw["dft_size"] = tc.dft_size
    K.reset_launch_counts()
    got = K.stft_feats_int8(padded, tc.params, **kw)
    assert K.launch_counts()["stft_feats_int8"] == 1
    _close(got, K.stft_feats_int8_plain(padded, tc.params, **kw), TOL_INT8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DOUBLE_TIERS))
@pytest.mark.parametrize("shape", [SHAPES[0], ADVERSARY], ids=["main", ADVERSARY])
def test_double_kernel_repeats_bitwise(precision, shape):
    """No atomics and a fixed order of every sum: 100 calls of B4 give the
    same bits, within TOL_INT8 of the plain version."""
    dev = _device()
    params, padded, kw = _double_case(dev, shape, 86, use_power=False, precision=precision)
    kw.update(use_log=True, include_energy=True, log_floor=1e-5)
    first = K.stft_feats_double(padded, params, **kw)
    _close(first, K.stft_feats_double_plain(padded, params, **kw), TOL_INT8, True)
    differ = sum(
        not torch.equal(K.stft_feats_double(padded, params, **kw), first) for _ in range(100)
    )
    assert differ == 0, f"{differ} of 100 calls differ from the first"


@functools.lru_cache(maxsize=None)
def _wgmma_probe():
    """The verdict of tools/torch_wgmma_probe.py on this card, once."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "torch_wgmma_probe.py")
    spec = importlib.util.spec_from_file_location("torch_wgmma_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.probe()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wgmma_ss", "wgmma_rs", "mma_sync"])
def test_tensor_cores_sum_integer_digits_exactly(path):
    """B4 rests on the bf16 tensor cores summing integer products in fp32
    exactly while every partial sum stays at or below 2^24: the probe's
    patterns (sums up to 2^24, cancellation, large then +-1 terms, random
    and real digits) give the int64 sums bit for bit on every path."""
    _device()
    verdict = _wgmma_probe()
    rows = verdict["results"][path]
    assert max(peak for _, _, _, peak in rows.values()) == 2**24
    bad = {key: r for key, r in rows.items() if r[1]}
    assert not bad, bad


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
        ("default", "pallas", "stft_feats_rows", TOL_DEFAULT),
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


# --- the signal ops (plain torch ops) on the card against the CPU -----------

TOL_SIGNAL = 1e-5  # float32 on the card vs float64 (tests/test_resample.py:44)


def _tones(batch, seconds, rate=16000, seed=0):
    """Tones of 100 + 9b Hz with 0.05 noise, the signals of bench.py's pitch
    throughput."""
    t = np.arange(int(seconds * rate)) / rate
    noise = np.random.RandomState(seed).randn(batch, t.size)
    f0 = 100.0 + 9.0 * np.arange(batch)[:, None]
    return np.sin(2 * np.pi * f0 * t) + 0.05 * noise


@pytest.mark.cuda
def test_pitch_on_gpu_matches_cpu():
    """float32 pitch on the card against the float64 port on the CPU: f0
    within rtol 1e-3 on at least 99% of the frames the CPU calls voiced
    (nccf > 0.5), the POV column within 1e-3, equal valid counts (ragged
    rows too)."""
    from speech_tpu_torch.ops import pitch as TP

    dev = _device()
    x = _tones(6, 2.0)
    lengths = np.array([32000, 32000, 20000, 32000, 9000, 32000])
    x *= np.arange(x.shape[1]) < lengths[:, None]
    track = TP.kaldi_pitch(torch.tensor(x, dtype=torch.float32, device=dev), 16000,
                           lengths=lengths)
    feats, counts = TP.pitch_feats(torch.tensor(x, dtype=torch.float32, device=dev), 16000,
                                   lengths=lengths, return_valid=True)
    want = TP.kaldi_pitch(x, 16000, lengths=lengths, device="cpu")
    want_feats, want_counts = TP.pitch_feats(x, 16000, lengths=lengths, return_valid=True,
                                             device="cpu")
    assert torch.equal(counts.cpu(), want_counts)
    voiced = (want.nccf > 0.5) & want.valid
    close = torch.isclose(track.f0.cpu().double(), want.f0, rtol=1e-3, atol=0)[voiced]
    assert close.float().mean().item() >= 0.99, close.float().mean().item()
    assert (feats[..., 0].cpu().double() - want_feats[..., 0]).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("up,down", [(1, 2), (3, 2), (441, 160)])
def test_resample_on_gpu_matches_cpu(up, down):
    from speech_tpu_torch.ops import resample as TR

    dev = _device()
    x = np.random.RandomState(up + down).randn(4, 16000) * 0.3
    got = TR.resample(torch.tensor(x, dtype=torch.float32, device=dev), up, down)
    want = TR.resample(x, up, down, device="cpu")
    assert got.device.type == "cuda" and got.shape == want.shape
    assert (got.cpu().double() - want).abs().max().item() <= TOL_SIGNAL


@pytest.mark.cuda
def test_augment_on_gpu_matches_cpu():
    """speed perturbation, reverberation and noise mixing at given offsets
    on the card against the float64 CPU; SpecAugment and random gain from
    a generator on the card keep their contracts."""
    from speech_tpu_torch.ops import augment as TA

    dev = _device()
    rng = np.random.RandomState(17)
    x = rng.randn(4, 16000) * 0.3
    x32 = torch.tensor(x, dtype=torch.float32, device=dev)
    for factor in (0.9, 1.1):
        got = TA.speed_perturb(x32, factor)
        want = TA.speed_perturb(x, factor, device="cpu")
        assert (got.cpu().double() - want).abs().max().item() <= TOL_SIGNAL
    rir = rng.randn(4800) * np.exp(-np.arange(4800) / 800.0) * 0.05
    rir[100] = 1.0
    got = TA.reverberate(x32, rir)
    want = TA.reverberate(x, rir, device="cpu")
    assert (got.cpu().double() - want).abs().max().item() <= TOL_SIGNAL
    noise = rng.randn(20000)
    offsets = torch.tensor([0, 5, 19999, 12345])
    got = TA._mix_noise_at(x32, torch.tensor(noise, device=dev), offsets.to(dev), 10.0, None)
    want = TA._mix_noise_at(torch.tensor(x), torch.tensor(noise), offsets, 10.0, None)
    assert (got.cpu().double() - want).abs().max().item() <= TOL_SIGNAL
    gen = torch.Generator(device=dev).manual_seed(5)
    feats = torch.randn(4, 200, 40, device=dev)
    masked = TA.spec_augment(gen, feats)
    changed = masked != feats
    assert changed.any() and bool((masked[changed] == 0).all())
    gained = TA.random_gain(torch.Generator(device=dev).manual_seed(6), x32)
    db = 20 * torch.log10((gained[:, 0] / x32[:, 0]).abs())
    assert bool((db.abs() <= 6.0 + 1e-4).all())


@pytest.mark.cuda
def test_feats_to_signal_on_gpu_matches_cpu():
    from speech_tpu_torch.ops import invert as TI

    """Four Griffin-Lim iterations on the card against float64 on the CPU,
    on features of noise (as chip_smoke.py inverts); float32 Griffin-Lim
    amplifies rounding more on a tone's narrow-band features."""
    dev = _device()
    bank = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
    gpu = STFTFrameComputer(dict(bank), frame_length_ms=25, frame_shift_ms=10, device=dev)
    cpu = STFTFrameComputer(dict(bank), frame_length_ms=25, frame_shift_ms=10, device="cpu",
                            dtype="float64")
    x = np.random.RandomState(18).randn(2, 16000) * 0.1
    feats, _ = cpu.compute_batch(x, np.full(2, x.shape[1]))
    got = TI.feats_to_signal(feats.to(dev, torch.float32), gpu, n_iters=4)
    want = TI.feats_to_signal(feats, cpu, n_iters=4)
    assert got.device.type == "cuda"
    assert (got.cpu().double() - want).abs().max().item() <= 1e-4


def _stream_pair(kind, dev):
    """A streamer on the card in float32 and its float64 twin on the CPU."""
    from speech_tpu_torch import post as TP
    from speech_tpu_torch.compute import SIFrameComputer
    from speech_tpu_torch.streaming import StreamingPitch, StreamingSI, StreamingSTFT
    from speech_tpu_torch.streaming_post import StreamingPipeline

    def make(device, dtype):
        if kind == "pitch":
            return StreamingPitch(16000, 1600, lookahead_frames=5, dtype=dtype, device=device)
        if kind == "si":
            bank = {"name": "gammatone", "scaling_function": "mel", "num_filts": 40,
                    "sampling_rate": 16000}
            return StreamingSI(SIFrameComputer(bank, include_energy=True, dtype=dtype,
                                               device=device), 1600)
        comp = STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, dtype=dtype, device=device)
        if kind == "stft":
            return StreamingSTFT(comp, 1600)
        return StreamingPipeline(comp, [TP.Deltas(2), TP.SlidingCMVN(center=False, min_window=10),
                                        TP.Stack(3)], chunk_size=1600)

    return make(dev, "float32"), make("cpu", "float64")


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
@pytest.mark.parametrize("kind", ["stft", "si", "pitch", "pipeline"])
def test_stream_ticks_queue_no_sync(kind):
    """Three sessions on the stream axis, four ticks of 100 ms chunks with
    their own valid lengths, each tick on the card under
    set_sync_debug_mode("error"); every session's rows against the same
    stream in float64 on the CPU (pitch: f0 within rtol 1e-3)."""
    dev = _device()
    card, host = _stream_pair(kind, dev)
    rng = np.random.RandomState(19)
    t = np.arange(4 * 1600) / 16000
    x = np.stack([np.sin(2 * np.pi * f * t) + 0.1 * rng.randn(t.size) for f in (120, 190, 260)])
    valids = np.array([[1600, 1600, 1600], [1600, 700, 0], [1600, 1600, 1600], [900, 1600, 1600]])
    rows = {"card": [[], [], []], "host": [[], [], []]}
    states = {"card": card.init_state(streams=3), "host": host.init_state(streams=3)}
    for i, v in enumerate(valids):
        chunk = x[:, i * 1600 : (i + 1) * 1600]
        on_card = torch.tensor(chunk, dtype=torch.float32, device=dev)
        v_card = torch.tensor(v, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            states["card"], out, n = card._process_impl(states["card"], on_card, v_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        states["host"], hout, hn = host._process_impl(states["host"], chunk, torch.tensor(v))
        for s in range(3):
            rows["card"][s].append(out[s, : int(n[s])].cpu().double())
            rows["host"][s].append(hout[s, : int(hn[s])])
    for side, stream in (("card", card), ("host", host)):
        out, n = stream._finalize_impl(states[side])
        for s in range(3):
            rows[side][s].append(out[s, : int(n[s])].cpu().double())
    for s in range(3):
        got, want = torch.cat(rows["card"][s]), torch.cat(rows["host"][s])
        assert got.shape == want.shape and got.shape[0] > 0
        if kind == "pitch":
            assert torch.allclose(got[:, 0], want[:, 0], rtol=1e-3, atol=0)
        else:
            assert (got - want).abs().max().item() <= TOL_FLOAT



@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
def test_fbank_pitch_stream_at_256_sessions_matches_cpu_float64():
    """The benchmark's fbank40-pitch-kaldi-online streamer with 256 sessions
    on the stream axis, 3.5 s of 100 ms chunks, every tick under
    set_sync_debug_mode("error"); three voiced sessions (slots 0, 97 and
    255) against the same stream in float64 on the CPU: the filter-bank
    columns within TOL_FLOAT, the pitch columns' log pitch on all but a
    near-tie's rows within 1e-4 of float64, and the row counts exact."""
    import json

    from bench_port.kinds.corpus_pitch import synth
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer
    from speech_tpu_torch.streaming import StreamingAppendPitch

    dev = _device()
    with open("bench_port/configs/fbank40-pitch-kaldi-online.json") as f:
        config = json.load(f)
    with open("bench_port/mixes/stream-pitch-replay.json") as f:
        audio = json.load(f)["audio"]

    def make(device, dtype):
        comp = alias_factory_subclass_from_arg(
            FrameComputer, {**config["computer"], "device": device, "dtype": dtype})
        return StreamingAppendPitch(comp, config["pitch"], 1600)

    card, host = make(dev, "float32"), make("cpu", "float64")
    S, n = 256, 56000
    sigs = synth([n] * S, 20261019, "gpu-test", audio, 16000, "cpu")
    x = torch.tensor(np.stack(sigs).astype(np.float32))
    state = card.init_state(streams=S)
    rows = [[] for _ in range(S)]
    for c in range(n // 1600):
        chunk = x[:, c * 1600:(c + 1) * 1600].to(dev)
        v = torch.full((S,), 1600, dtype=torch.int64, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, out, nv = card._process_impl(state, chunk, v)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out, nv = out.cpu().double(), nv.cpu()
        for s in (0, 97, 255):
            rows[s].append(out[s, : int(nv[s])])
    out, nv = card._finalize_impl(state)
    out, nv = out.cpu().double(), nv.cpu()
    for s in (0, 97, 255):
        got = torch.cat(rows[s] + [out[s, : int(nv[s])]])
        want = torch.as_tensor(host.transform(sigs[s]))
        assert got.shape == want.shape and got.shape[0] == 350
        assert (got[:, :40] - want[:, :40]).abs().max().item() <= TOL_FLOAT
        d = (got[:, 41] - want[:, 41]).abs()
        assert (d > np.log1p(0.005)).double().mean().item() <= 0.02
        assert d.median().item() <= 1e-4
    stats = card.stats
    assert stats["pitch_frames_tracked"] == S * 346 and stats["pitch_frames_emitted"] == S * 346


# --- multi-device (world size 1 on NCCL) and the exported frontend ----------


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
def test_sharded_extractor_nccl_world1_runs_b2(tmp_path):
    """ShardedExtractor on a one-card NCCL mesh at 'double': bitwise the
    computer's compute_batch on the same rows, one B2 launch a batch, and
    its dispatch queues no host synchronisation."""
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.parallel import multihost

    dev = _device()
    multihost.initialize(store=dist.FileStore(str(tmp_path / "store"), 1),
                         num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = par.make_mesh(("data",))
        comp = STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, precision="double", device=dev)
        ex = par.ShardedExtractor(comp, mesh)
        rng = np.random.RandomState(91)
        x = rng.randn(8, 32000).astype(np.float32)
        full = np.full(8, 32000)
        K.reset_launch_counts()
        feats, counts = ex.extract_batch(x, full)
        assert K.launch_counts()["stft_feats_int8"] == 1
        want, want_n = comp.compute_batch(x, full)
        assert torch.equal(feats.full_tensor(), want)
        assert torch.equal(counts.full_tensor(), want_n)
        sigs = [rng.randn(n).astype(np.float32) for n in (16000, 9000, 31000, 400)]
        ex._collect(*ex._dispatch(sigs))  # warm the packed layouts
        torch.cuda.synchronize()
        K.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = ex._dispatch(sigs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert K.launch_counts()["stft_feats_int8"] == 1
        for sig, got in zip(sigs, ex._collect(*pending)):
            w, n = comp.compute_batch(sig[None], [sig.size])
            assert np.array_equal(got, w[0, : int(n[0])].cpu().numpy())
    finally:
        dist.destroy_process_group()


# --- packed batches: the layout kernel ---------------------------------------


def _bits(t):
    """The tensor's raw bits, so that NaN and -0.0 compare as bits."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _layout_signals(rng, dtype, lengths):
    if np.dtype(dtype).kind == "i":
        return [rng.randint(-32768, 32768, size=n).astype(dtype) for n in lengths]
    sigs = [(rng.randn(n) * 1000).astype(dtype) for n in lengths]
    sigs[0][:4] = [-0.0, np.nan, np.inf, -np.inf]  # copied as they are
    return sigs


# (signal dtype, buffer dtype): the three element sizes, and the host's cast
LAYOUT_DTYPES = [(np.int16, torch.int16), (np.float32, torch.float32),
                 (np.float64, torch.float64), (np.float32, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("sig_dtype,buf_dtype", LAYOUT_DTYPES,
                         ids=[f"{np.dtype(a).name}-{str(b)[6:]}" for a, b in LAYOUT_DTYPES])
def test_layout_kernel_matches_host_padding(sig_dtype, buf_dtype):
    """The packed rows laid out by the kernel are the host-padded rows bit
    for bit: ragged rows, ``min_batch`` rows past the batch, mesh blocks
    with ``start > 0``; a long batch before short ones, so that stale
    pinned or device memory would show."""
    from speech_tpu_torch import parallel as par

    dev = _device()
    ex = par.ShardedExtractor(STFTFrameComputer(dict(BANK), frame_length_ms=25,
                                                frame_shift_ms=10, device=dev))
    assert ex._packs
    rng = np.random.RandomState(41)
    K.reset_launch_counts()
    launches = 0
    for lengths in ([300000, 160000, 9001, 77777, 32000], [20000, 3, 400, 16001], [999, 2]):
        sigs = _layout_signals(rng, sig_dtype, lengths)
        lens, max_len, _ = ex._host_batch(sigs, 8)
        for start, per in ((0, 8), (2, 3), (4, 4), (6, 2)):
            want = ex._pad_rows(sigs, lens, max_len, buf_dtype, start, per)
            rows, dlens = ex._lay_out(*ex._pack_rows(sigs, lens, buf_dtype, start, per),
                                      max_len)
            launches += 1
            assert rows.device.type == "cuda" and rows.shape == want.shape
            assert torch.equal(_bits(rows.cpu()), _bits(want)), (lengths, start)
            assert dlens.cpu().tolist() == lens[start: start + per].tolist()
    assert K.launch_counts()["layout_rows"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32, torch.float64])
def test_layout_kernel_unaligned_rows_and_odd_widths(dtype):
    """The kernel against its plain version off the packed path's
    alignment: offsets not on 16 bytes (element loads), widths that are no
    multiple of 16 bytes and a packed buffer that does not start on 16
    bytes (element stores), counts past the width or the buffer (clamped),
    and more rows than a grid's y dimension."""
    dev = _device()
    rng = np.random.RandomState(42)
    host = torch.from_numpy(rng.randint(-30000, 30000, 50001)).to(dtype)
    offsets = torch.tensor([0, 1, 7, 8, 1000, 49990, 60000, 5], dtype=torch.int64)
    counts = torch.tensor([5000, 4999, 3, 0, 12345, 100, 10, 70000], dtype=torch.int64)
    packed = host.to(dev)
    for p, h in ((packed, host), (packed[1:], host[1:])):
        for max_len in (8192, 8191, 6000, 1):
            want = K.layout_rows_plain(h, offsets, counts, max_len)
            got = K.layout_rows(p, offsets.to(dev), counts.to(dev), max_len)
            assert torch.equal(_bits(got.cpu()), _bits(want)), max_len
    many = torch.arange(70000, dtype=torch.int64)
    got = K.layout_rows(packed, many.to(dev), (many % 5).to(dev), 8)
    want = K.layout_rows_plain(host, many, many % 5, 8)
    assert torch.equal(_bits(got.cpu()), _bits(want))


def _route_computer(route, dev):
    from speech_tpu_torch.compute import SIFrameComputer

    if route == "si":
        bank = {"name": "gammatone", "scaling_function": "mel", "num_filts": 40,
                "sampling_rate": 16000}
        return SIFrameComputer(bank, frame_shift_ms=10, include_energy=True, device=dev)
    if route == "float64":
        return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, dtype="float64", device=dev)
    return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                             precision="double", device=dev)


# (route, signal dtype, batch, seconds): B2 at 'double' on the corpus cell's
# shapes (64 rows of 2-20 s int16 PCM, pow2 buckets), SI (which needs zero
# padding) on float32, a float64 computer fed float32 (the host's cast)
EXTRACT_ROUTES = [("double", np.int16, 64, (2, 20)), ("si", np.float32, 8, (1, 5)),
                  ("float64", np.float32, 8, (1, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("route,sig_dtype,batch,seconds", EXTRACT_ROUTES,
                         ids=[r[0] for r in EXTRACT_ROUTES])
def test_extract_iter_packed_matches_host_padding(route, sig_dtype, batch, seconds):
    """``extract_iter`` on the card through the packed path gives the
    features of the host-padding path bit for bit, one layout launch a
    batch, and the host never pads."""
    from speech_tpu_torch import parallel as par

    dev = _device()
    comp = _route_computer(route, dev)
    rng = np.random.RandomState(43)
    batches = []
    for k in (batch, batch // 2, batch - 1):  # a full batch, then shorter ones
        n = rng.randint(seconds[0] * 16000, seconds[1] * 16000, size=k)
        batches.append([(s * 0.3).astype(sig_dtype) if sig_dtype != np.int16 else s
                        for s in _layout_signals(rng, np.int16, n)])
    host = par.ShardedExtractor(comp)
    host._packs = False
    packed = par.ShardedExtractor(comp)
    assert packed._packs
    K.reset_launch_counts()
    want = list(host.extract_iter(batches, min_batch=batch))
    assert K.launch_counts()["layout_rows"] == 0  # the host padded
    packed._pad_rows = None  # a call would raise
    got = list(packed.extract_iter(batches, min_batch=batch))
    assert K.launch_counts()["layout_rows"] == len(batches)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            assert a.shape == b.shape and np.array_equal(a, b)
    assert packed.stats == host.stats


# Kaldi pitch as an ESPnet1 recipe runs it (lag_resolution 0.005: 418 lags)
PITCH = {"lag_resolution": 0.005}


def _voiced(rng, n, rate=16000):
    """int16 pulse trains gliding within 80-300 Hz over noise."""
    t = np.arange(n) / rate
    f0 = 80.0 * (300.0 / 80.0) ** (0.5 + 0.5 * np.sin(2 * np.pi * t / rng.uniform(0.5, 2.0)))
    pulses = np.diff(np.floor(np.cumsum(f0) / rate), prepend=0.0)
    x = np.convolve(pulses, np.exp(-np.arange(80) / 12.0))[:n] + 0.05 * rng.randn(n)
    return np.round(x / np.abs(x).max() * 8000).astype(np.int16)


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
@pytest.mark.filterwarnings("ignore:Warning. Profiler clears events")
def test_extract_iter_pitch_on_card_matches_cpu():
    """``extract_iter`` with pitch on the card against the CPU device in
    float64: B1's 80 columns within its 'highest' error, and the three
    pitch columns as the corpus pitch cell holds them (a lag more than a
    grid step off on at most 0.1% of the rows; the 99th percentiles of
    the columns' errors on the others: POV 2e-5, log pitch 1e-3, delta
    1e-6; a float32 lag one step off the float64 one on a near-tie moves a
    few rows by up to a step, which the percentiles leave out).  The POV's
    is four times the cell's limit: these pulse trains voice almost fully,
    and near an NCCF of 1 the POV's slope is a hundred times its slope at
    0.5 (the CPU's float32 reads 4.4e-6 here).  The
    dispatch queues no host synchronisation, a batch copies its samples to
    the card once, as without pitch, and the tracker's host lengths once
    (they bound its Viterbi), and the timer has a ``"pitch"`` stage."""
    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.profiling import StageTimer

    dev = _device()

    def computer(device, **kw):
        return STFTFrameComputer({**BANK, "num_filts": 80}, frame_length_ms=25,
                                 frame_shift_ms=10, device=device, **kw)

    rng = np.random.RandomState(44)
    batches = [[_voiced(rng, n) for n in rng.randint(2 * 16000, 6 * 16000, size=k)]
               for k in (8, 5)]
    card = par.ShardedExtractor(computer(dev, precision="highest", fft_mode="pallas"),
                                pitch=PITCH)
    plain = par.ShardedExtractor(computer(dev, precision="highest", fft_mode="pallas"))
    cpu = par.ShardedExtractor(computer("cpu", dtype="float64"), pitch=PITCH)
    list(card.extract_iter(batches, min_batch=8))  # host tables to the card once
    list(plain.extract_iter(batches, min_batch=8))
    torch.cuda.synchronize()

    def h2d(ex):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            list(ex.extract_iter(batches, min_batch=8))
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if "HtoD" in e.name)

    # the packed samples and their table; with pitch, the tracker's lengths
    assert h2d(card) == h2d(plain) + len(batches) <= 3 * len(batches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = card._dispatch(batches[0], 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    card._collect(*pending)
    timer = StageTimer()
    before = card.stats["pitch_valid_frames"]
    got = list(card.extract_iter(batches, min_batch=8, timer=timer))
    assert timer.totals["pitch"] > 0
    want = list(cpu.extract_iter(batches, min_batch=8))
    step = np.log1p(PITCH["lag_resolution"])
    errs, off, frames = [], 0, 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and a.shape[1] == 83
            assert np.abs(a[:, :80] - b[:, :80]).max() <= 5e-4
            d = np.abs(a[:, 80:] - b[:, 80:])
            agree = d[:, 1] <= step
            off += int((~agree).sum())
            frames += agree.size
            errs.append(d[agree])
    p99 = np.percentile(np.concatenate(errs), 99, axis=0)
    assert off <= 1e-3 * frames and (p99 <= [2e-5, 1e-3, 1e-6]).all(), (off, p99)
    assert card.stats["pitch_valid_frames"] - before == cpu.stats["pitch_valid_frames"] > 0


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
@pytest.mark.filterwarnings("ignore:Warning. Profiler clears events")
def test_pitch_viterbi_stops_at_the_longest_row_on_card(monkeypatch):
    """At the pitch cell's shapes (64 rows of 2-20 s of int16 PCM in the
    524,288-sample bucket, 418 lags), on the Viterbi's two loops (the
    kernel's plain version, taken here by making ``viterbi_on_kernel``
    refuse): host lengths end the Viterbi at the batch's longest tracked
    row and give the track of lengths on the card (the loops over every
    frame) bit for bit; the extractor's ``"extract.pitch"`` range holds at
    most 9 kernels a step past the first plus 400; and after one warm-up
    batch ``_with_pitch`` queues no host synchronisation."""
    from torch.autograd import DeviceType

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.ops import pitch as TP

    dev = _device()
    monkeypatch.setattr(TP, "viterbi_on_kernel", lambda *a: False)
    rng = np.random.RandomState(45)
    lens = rng.randint(2 * 16000, 20 * 16000, size=64).astype(np.int64)
    comp = STFTFrameComputer({**BANK, "num_filts": 80}, frame_length_ms=25,
                             frame_shift_ms=10, precision="highest", device=dev)
    ex = par.ShardedExtractor(comp, pitch=PITCH)
    max_len = ex.bucket_len(int(lens.max()))
    assert max_len == 524288
    padded = np.zeros((lens.size, max_len), np.int16)
    for i, n in enumerate(lens):
        padded[i, :n] = _voiced(rng, int(n))
    rows = torch.tensor(padded, device=dev)
    T, counts = TP.pitch_frame_counts(max_len, lens, 16000, **PITCH)
    bound = int(counts.max())
    assert bound < 0.7 * T

    x = rows.to(torch.float32)
    bounded = TP.kaldi_pitch(x, 16000, lengths=lens, **PITCH)
    whole = TP.kaldi_pitch(x, 16000, lengths=torch.tensor(lens, device=dev), **PITCH)
    for name, a, b in zip(TP.PitchTrack._fields, bounded, whole):
        assert a.shape == b.shape == (lens.size, T) and torch.equal(a, b), name
    del x, bounded, whole

    feats = torch.zeros((lens.size, (max_len - comp.frame_length) // 160 + 1, 80), device=dev)
    host = torch.from_numpy(lens)
    want = ex._with_pitch(feats, rows, torch.tensor(lens, device=dev))
    ex._with_pitch(feats, rows, host)  # the warm-up batch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ex._with_pitch(feats, rows, host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ex._with_pitch(feats, rows, host)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e.time_range for e in on_card if e.name == "extract.pitch"]
    assert len(ranges) == 1
    kernels = [e for e in on_card if not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset"))
               and ranges[0].start <= e.time_range.start
               and e.time_range.end <= ranges[0].end]
    assert 9 * (bound - 1) < len(kernels) <= 9 * (bound - 1) + 400, (len(kernels), bound)


# --- the pitch tracker's Viterbi kernel against its loops, on the card ---------


def _loops(monkeypatch, nc, tmat, counts=None, steps=None):
    """``_viterbi``'s two loops on the card (``viterbi_on_kernel`` made to
    refuse for the call)."""
    from speech_tpu_torch.ops import pitch as TP

    with monkeypatch.context() as m:
        m.setattr(TP, "viterbi_on_kernel", lambda *a: False)
        return TP._viterbi(nc, tmat, counts, steps)


def _pitch_table(L, penalty=0.1):
    """The tracker's ``(L, L)`` transition costs at 4 kHz: the lag grid's
    first ``L`` lags (418 at resolution 0.005, 210 at 0.01)."""
    from speech_tpu_torch.ops import pitch as TP

    resolution = 0.005 if L > 210 else 0.01
    trans = TP._lag_tables(4000.0, 50.0, 400.0, penalty, resolution)[4]
    if L > trans.shape[0]:  # past the grid: the same law on a longer one
        lags = np.log(12.5 * 1.003 ** np.arange(L))
        trans = penalty * (lags[:, None] - lags[None, :]) ** 2
    return torch.tensor(trans[:L, :L], dtype=torch.float32, device="cuda")


def _viterbi_scores(kind, T, rows, L, seed):
    """``(T, rows, L)`` float32 scores, from the rows' ``(rows, T, L)``
    block as ``_choose_lags`` hands them over: ``random`` in [-1, 1];
    ``constant`` rows (every lag of a frame the same score, so that every
    cost ties); ``pairs`` (each lag repeats its left neighbour's score);
    ``quarters`` (multiples of 1/4, ties everywhere)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, size=(rows, T, L)).astype(np.float32)
    if kind == "constant":
        x[:] = x[..., :1]
    elif kind == "pairs":
        x[..., 1::2] = x[..., 0:L - 1:2]
    elif kind == "quarters":
        x = np.round(x * 4) / 4
    return torch.movedim(torch.tensor(x, device="cuda"), 1, 0)


# (kind, frames, rows, lags, penalty, counts, steps): counts "none" (no
# counts), "full" (every row to steps), "ragged" (0 .. steps, frozen rows);
# steps None runs every frame
VITERBI_CASES = {
    "random": ("random", 300, 64, 418, 0.1, "none", None),
    "random-ragged-bounded": ("random", 300, 64, 418, 0.1, "ragged", 200),
    "random-ragged-whole": ("random", 300, 64, 418, 0.1, "ragged", None),
    "constant-rows": ("constant", 120, 9, 418, 0.1, "ragged", 100),
    "repeated-columns": ("pairs", 200, 16, 418, 0.1, "ragged", None),
    "penalty-0": ("quarters", 150, 12, 418, 0.0, "ragged", 140),
    "penalty-0-random": ("random", 150, 12, 418, 0.0, "none", None),
    "one-step": ("random", 40, 8, 418, 0.1, "ragged", 1),
    "one-frame": ("random", 1, 8, 418, 0.1, "none", None),
    "one-row": ("random", 300, 1, 418, 0.1, "full", 250),
    "lags-210": ("random", 300, 64, 210, 0.1, "ragged", 280),
    "lags-333": ("quarters", 200, 13, 333, 0.1, "ragged", None),
    "lags-1": ("random", 30, 5, 1, 0.1, "ragged", None),
    "lags-7": ("quarters", 60, 5, 7, 0.1, "ragged", None),
    "rows-5": ("random", 200, 5, 418, 0.1, "ragged", 190),
    "lags-1024": ("random", 40, 3, 1024, 0.1, "ragged", None),
    "lags-2048": ("quarters", 12, 2, 2048, 0.1, "ragged", None),
}


def _viterbi_inputs(case, seed=0):
    kind, T, rows, L, penalty, counts, steps = VITERBI_CASES[case]
    nc = _viterbi_scores(kind, T, rows, L, seed)
    tmat = _pitch_table(L, penalty)
    c = None
    if counts == "full":
        c = torch.full((rows,), steps or T, dtype=torch.int64, device="cuda")
    elif counts == "ragged":
        hi = steps or T
        c = torch.tensor(np.random.RandomState(seed + 1).randint(0, hi + 1, size=rows),
                         dtype=torch.int64, device="cuda")
        c[0] = hi  # the longest row reaches the bound
    return nc, tmat, c, steps


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VITERBI_CASES))
def test_viterbi_kernel_path_is_the_loops_bit_for_bit(case, monkeypatch):
    """One launch of ``viterbi_path`` (through ``_viterbi``) gives the
    int64 path of the loops on the same card, element for element: random
    scores, planted exact ties (constant rows, repeated columns, scores on
    a quarter grid, a penalty of 0), frozen rows through ``counts`` with
    ``steps`` below ``T`` and at it, no counts, one step, one frame, one
    row, 418, 210, 333, 7 and 1 lags, rows that fill no cluster, and 1,024
    and 2,048 lags (the table read from L2)."""
    from speech_tpu_torch.ops import pitch as TP

    _device()
    nc, tmat, counts, steps = _viterbi_inputs(case)
    K.reset_launch_counts()
    got = TP._viterbi(nc, tmat, counts, steps)
    assert K.launch_counts()["viterbi_path"] == 1
    want = _loops(monkeypatch, nc, tmat, counts, steps)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int64
    assert got.shape == want.shape == nc.shape[:2]
    bad = (got != want).nonzero()
    assert bad.shape[0] == 0, (bad.shape[0], bad[:5].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("rows_per_cluster", [1, 2, 3])
def test_viterbi_kernel_every_launch_shape(cluster, rows_per_cluster, monkeypatch):
    """Every cluster size and every rows-a-cluster the launcher takes
    gives the loops' path, on 7 rows (a cluster left part empty) of 97
    lags (one or two column groups a block; the last blocks of 7 and 8
    with fewer columns, or none) with ties and frozen rows; the automatic
    plan at the pitch cell's shape keeps the table in shared memory, and
    1,024 lags read it from device memory, a row a cluster; the limit is
    ``VITERBI_MAX_LAGS``."""
    dev = _device()
    nc = _viterbi_scores("quarters", 80, 7, 97, 5)
    tmat = _pitch_table(97)
    counts = torch.tensor([70, 0, 1, 2, 69, 70, 33], dtype=torch.int64, device=dev)
    plan = {"cluster": cluster, "rows_per_cluster": rows_per_cluster}
    got = K.viterbi_path(nc, tmat, counts, 70, _plan=plan)
    want = _loops(monkeypatch, nc, tmat, counts, 70)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    auto = K.viterbi_launch_plan(dev, 64, 418)
    assert auto["table_in_smem"] == 1 and auto["max_lags"] == K.VITERBI_MAX_LAGS
    assert auto["rows_per_cluster"] <= 3
    far = K.viterbi_launch_plan(dev, 64, 1024)
    assert far["table_in_smem"] == 0 and far["rows_per_cluster"] == 1


def _cell_batch(seed):
    """64 voiced int16 utterances of 2-20 s: the pitch cell's batches."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2 * 16000, 20 * 16000, size=64)
    return [_voiced(rng, int(n)) for n in lens]


@pytest.mark.cuda
def test_extract_iter_pitch_kernel_columns_are_the_loops(monkeypatch):
    """A batch at the pitch cell's shapes (64 rows of 2-20 s in the
    524,288-sample bucket, 418 lags) through ``ShardedExtractor(pitch=)``:
    the rows with the kernel equal those of the loops bit for bit, and
    ``pitch_kernel_steps`` counts every one of the ``pitch_steps``."""
    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.ops import pitch as TP

    dev = _device()
    comp = STFTFrameComputer({**BANK, "num_filts": 80}, frame_length_ms=25,
                             frame_shift_ms=10, precision="highest", device=dev)
    batch = _cell_batch(46)
    kernel = par.ShardedExtractor(comp, pitch=PITCH)
    K.reset_launch_counts()
    got = list(kernel.extract_iter([batch], min_batch=64))[0]
    assert K.launch_counts()["viterbi_path"] == 1
    assert kernel.stats["pitch_kernel_steps"] == kernel.stats["pitch_steps"] > 0
    with monkeypatch.context() as m:
        m.setattr(TP, "viterbi_on_kernel", lambda *a: False)
        loops = par.ShardedExtractor(comp, pitch=PITCH)
        want = list(loops.extract_iter([batch], min_batch=64))[0]
    assert loops.stats["pitch_kernel_steps"] == 0
    assert loops.stats["pitch_steps"] == kernel.stats["pitch_steps"]
    assert len(got) == len(want) == 64
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.shape[1] == 83 and np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Warning. Profiler clears events")
def test_extract_pitch_range_holds_under_600_kernels():
    """At the pitch cell's shapes the ``"extract.pitch"`` range of one
    batch holds fewer than 600 kernels, the Viterbi's one among them."""
    from torch.autograd import DeviceType

    from speech_tpu_torch import parallel as par

    dev = _device()
    comp = STFTFrameComputer({**BANK, "num_filts": 80}, frame_length_ms=25,
                             frame_shift_ms=10, precision="highest", device=dev)
    ex = par.ShardedExtractor(comp, pitch=PITCH)
    batch = _cell_batch(47)
    lens = np.array([x.size for x in batch], dtype=np.int64)
    max_len = ex.bucket_len(int(lens.max()))
    padded = np.zeros((lens.size, max_len), np.int16)
    for i, x in enumerate(batch):
        padded[i, :x.size] = x
    rows = torch.tensor(padded, device=dev)
    feats = torch.zeros((lens.size, (max_len - comp.frame_length) // 160 + 1, 80), device=dev)
    host = torch.from_numpy(lens)
    ex._with_pitch(feats, rows, host)  # the warm-up batch
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ex._with_pitch(feats, rows, host)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e.time_range for e in on_card if e.name == "extract.pitch"]
    assert len(ranges) == 1
    kernels = [e for e in on_card if not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset"))
               and ranges[0].start <= e.time_range.start
               and e.time_range.end <= ranges[0].end]
    assert len(kernels) < 600, len(kernels)
    assert sum(1 for e in kernels if "viterbi_kernel" in e.name) == 1


@pytest.mark.cuda
def test_export_computer_double_runs_b2_with_trained_params():
    """After a training step of the frontend on the card, its exported 'double'
    computer launches B2 once, on the trained parameters: its features
    follow the trained frontend (not a packed layout of the old weights),
    equal bit for bit those of an export from a fresh frontend with the
    same parameters, and leave the original computer's unchanged."""
    from speech_tpu_torch.nn import STFTFrontend, params_from_jax

    dev = _device()

    def computer():
        return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, precision="double", device=dev)

    original = computer()
    x = torch.tensor(np.random.RandomState(92).randn(4, 16000).astype(np.float32), device=dev)
    lens = np.full(4, 16000)
    before, _ = original.compute_batch(x, lens)  # packs the old weights
    frontend = STFTFrontend(original)
    # one Adam step moves every parameter by about lr: raising the
    # features keeps them off the log floor
    opt = torch.optim.Adam(frontend.parameters(), lr=0.05)
    (-frontend(x)).mean().backward()
    opt.step()
    K.reset_launch_counts()
    got, _ = frontend.export_computer().compute_batch(x, lens)
    assert K.launch_counts()["stft_feats_int8"] == 1
    with torch.no_grad():
        trained = frontend(x)
    assert (got - trained).abs().max().item() <= TOL_FLOAT
    assert (got - before).abs().max().item() > 100 * TOL_FLOAT
    fresh = STFTFrontend(computer())
    params_from_jax(fresh, {k: v.detach().cpu().numpy() for k, v in frontend.named_parameters()})
    again, _ = fresh.export_computer().compute_batch(x, lens)
    assert torch.equal(got, again)
    after, _ = original.compute_batch(x, lens)
    assert torch.equal(after, before)


# --- the model families and serving --------------------------------------------


def _model_pair(kind, dev):
    """A model of ``kind`` on the card in float32 and its float64 twin on
    the CPU holding the same parameters."""
    from speech_tpu_torch import models, nn

    def make(device, dtype):
        comp = STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, dtype=dtype, device=device)
        fe = nn.STFTFrontend(comp, dtype=dtype)
        gen = torch.Generator().manual_seed(11)
        if kind == "kws":
            return models.KWSModel(fe, num_classes=4, channels=(16, 16), generator=gen)
        if kind == "speaker":
            return models.SpeakerModel(fe, num_speakers=4, embed_dim=16, channels=(16, 16, 16),
                                       generator=gen)
        return models.CTCModel(fe, vocab_size=5, model_dim=32, num_layers=1, num_heads=2,
                               ffn_dim=64, generator=gen)

    card, host = make(dev, "float32"), make("cpu", "float64")
    with torch.no_grad():
        for (name, p), (_, q) in zip(card.named_parameters(), host.named_parameters()):
            if p.dim() > 1 and not name.startswith("frontend"):
                p.normal_(0.0, 0.3)  # the zero heads too
            q.copy_(p.double().cpu())
    return card, host


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kws", "speaker", "ctc"])
def test_models_on_the_card_track_float64(kind):
    """The model families' float32 forward (IEEE products: no TF32) and
    loss on the card against the same parameters in float64 on the CPU."""
    dev = _device()
    card, host = _model_pair(kind, dev)
    rng = np.random.RandomState(23)
    x = (rng.randn(3, 16000) * 0.1).astype(np.float32)
    lengths = np.array([16000, 12000, 7000])
    labels = np.array([[1, 2, 3], [4, 1, 0], [2, 0, 0]]) if kind == "ctc" else np.array([0, 3, 1])
    batch = [x, lengths, labels] + ([np.array([3, 2, 1])] if kind == "ctc" else [])
    with torch.no_grad():
        got, want = card(x, lengths), host(x.astype(np.float64), lengths)
        if kind == "ctc":
            for i, c in enumerate(got[1].cpu()):
                assert torch.allclose(got[0][i, :c].cpu().double(), want[0][i, :c], atol=TOL_FLOAT)
        else:
            assert torch.allclose(got.cpu().double(), want, atol=TOL_FLOAT), (
                got.cpu().double() - want).abs().max().item()
        g_loss, h_loss = card.loss(*batch)[0].item(), host.loss(*batch)[0].item()
    assert abs(g_loss - h_loss) <= TOL_FLOAT * max(1.0, abs(h_loss)), (g_loss, h_loss)


class _KeepGrads(torch.optim.Optimizer):
    """An optimizer whose step only keeps a copy of the gradients."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]


def _grad_err(got, want):
    """The largest gradient difference, each tensor's relative to its
    largest float64 gradient."""
    return max(((g.cpu().double() - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


@contextlib.contextmanager
def _relu_pattern(masks, replay=False):
    """``torch.relu`` that appends each call's ``z > 0`` to ``masks``, or
    with ``replay`` applies the recorded ones in their order.

    ReLU's derivative jumps at 0: a pre-activation within rounding of 0
    takes one branch in float32 and the other in float64, and moves its
    column's gradient by up to about 1e-3 of the largest. Replaying the
    card's pattern in the float64 twin leaves the arithmetic alone to
    compare."""
    relu, pattern = torch.relu, iter(list(masks))

    def record(z):
        masks.append((z > 0).cpu())
        return relu(z)

    def apply(z):
        return z * next(pattern).to(device=z.device, dtype=z.dtype)

    torch.relu = apply if replay else record
    try:
        yield
    finally:
        torch.relu = relu


def _train_batch(kind):
    rng = np.random.RandomState(37)
    x = (rng.randn(3, 16000) * 0.1).astype(np.float32)
    lengths = np.array([16000, 12000, 7000])
    labels = np.array([[1, 2, 3], [4, 1, 0], [2, 0, 0]]) if kind == "ctc" else np.array([0, 3, 1])
    return [x, lengths, labels] + ([np.array([3, 2, 1])] if kind == "ctc" else [])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kws", "speaker", "ctc"])
def test_train_step_gradients_on_the_card_track_float64(kind):
    """``make_train_step``'s float32 gradients on the card (the backward's
    convolutions and products in IEEE float32) against the float64
    gradients of the same parameters on the CPU, with the card forward's
    ReLU pattern, within TOL_GRAD of each tensor's largest; the same
    backward with TF32 allowed (PyTorch's default for cuDNN) misses that
    tolerance, so the check can see it."""
    from speech_tpu_torch import models

    dev = _device()
    card, host = _model_pair(kind, dev)
    batch = _train_batch(kind)
    keep = _KeepGrads(card.parameters())
    masks = []
    with _relu_pattern(masks):
        models.make_train_step(card, keep)(*batch)
    with _relu_pattern(masks, replay=True):
        host.loss(*batch)[0].backward()
    want = [p.grad for p in host.parameters()]
    err = _grad_err(keep.grads, want)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        card.loss(*batch)[0].backward()  # outside ieee_float32: TF32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    control = _grad_err([p.grad for p in card.parameters()], want)
    assert err <= TOL_GRAD < control, (err, control)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kws", "speaker", "ctc"])
def test_train_step_is_deterministic_on_the_card(kind):
    """Two models in the same state take an Adam ``make_train_step`` on the
    same batch to bitwise equal parameters: the IEEE backward keeps to
    cuDNN's deterministic algorithms (a resumed run can equal an
    uninterrupted one)."""
    import copy

    from speech_tpu_torch import models

    card, _ = _model_pair(kind, _device())
    twin = copy.deepcopy(card)
    for m in (card, twin):
        models.make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3))(*_train_batch(kind))
    for (name, a), b in zip(card.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a prototype")
def test_kws_pool_tick_queues_no_sync():
    """StreamingKWS sessions in a StreamPool: each tick's device work is
    queued under set_sync_debug_mode("error"), and each session's close row
    equals the model on its whole signal."""
    from speech_tpu_torch.models import StreamingKWS
    from speech_tpu_torch.serve import StreamPool

    dev = _device()
    card, _ = _model_pair("kws", dev)
    pool = StreamPool(StreamingKWS(card, window_frames=128, chunk_size=1600), slots=4)
    rng = np.random.RandomState(29)
    sigs = [(rng.randn(n) * 0.1).astype(np.float32) for n in (16000, 11000, 4800)]
    handles = [pool.open() for _ in sigs]
    for h, s in zip(handles, sigs):
        pool.feed(h, s)
    while any(len(pool._sessions[h].pending) for h in handles):
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = pool._queue_tick(max_chunks=2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pool._finish_tick(pending)
    closed = dict(pool.close_many(handles))
    with torch.no_grad():
        for h, s in zip(handles, sigs):
            want = card(s[None], [s.size])[0].cpu().numpy()
            np.testing.assert_allclose(closed[h][-1], want, rtol=0, atol=TOL_FLOAT)


@pytest.mark.cuda
def test_feature_server_launches_b2_once_a_micro_batch():
    """FeatureServer at 'double' on the card: one int8 digit kernel launch
    per micro-batch, and every result within the digit tolerance of the
    utterance alone on the plain digit route."""
    from speech_tpu_torch.serve import FeatureServer

    dev = _device()

    def comp(**kw):
        return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, precision="double", device=dev, **kw)

    rng = np.random.RandomState(31)
    utts = [(rng.randn(rng.randint(16000, 80000)) * 0.1).astype(np.float32) for _ in range(20)]
    plain = comp(fft_mode="matmul")
    with FeatureServer(comp(), max_batch=8, max_wait_ms=5.0) as server:
        server.warmup([80000])
        K.reset_launch_counts()
        outs = server.extract_many(utts)
        launches = K.launch_counts()["stft_feats_int8"]
        stats = dict(server.stats)
    assert stats["failed"] == 0 and launches == stats["batches"] >= 3
    for u, got in zip(utts, outs):
        want = plain.compute_batch(u[None], [u.size])[0][0].cpu().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8)


@pytest.mark.cuda
def test_servers_on_a_world_1_nccl_group_relay_through_b2(tmp_path):
    """Both servers on a one-card NCCL mesh take the relay path (header,
    scatter to the front itself, run, gather): FeatureServer at 'double'
    launches B2 once a micro-batch, each result within the digit
    tolerance of the utterance alone on the plain digit route; a
    StreamServer's sessions match compute_full within the float tier."""
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.parallel import multihost
    from speech_tpu_torch.serve import FeatureServer, StreamServer

    dev = _device()

    def comp(**kw):
        return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                                 include_energy=True, device=dev, **kw)

    rng = np.random.RandomState(32)
    utts = [(rng.randn(rng.randint(16000, 80000)) * 0.1).astype(np.float32) for _ in range(20)]
    plain = comp(precision="double", fft_mode="matmul")
    multihost.initialize(store=dist.FileStore(str(tmp_path / "store"), 1),
                         num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = par.make_mesh(("data",))
        with FeatureServer(comp(precision="double"), mesh=mesh, max_batch=8,
                           max_wait_ms=5.0) as server:
            assert server._relay is not None and server._relay.front
            server.warmup([80000])
            K.reset_launch_counts()
            outs = server.extract_many(utts)
            launches = K.launch_counts()["stft_feats_int8"]
            stats = dict(server.stats)
        assert stats["failed"] == 0 and launches == stats["batches"] >= 3
        for u, got in zip(utts, outs):
            want = plain.compute_batch(u[None], [u.size])[0][0].cpu().numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8)
        stream_comp = comp()
        with StreamServer(stream_comp, slots=4, chunk_size=1600, mesh=mesh) as streams:
            hs = [streams.open_session() for _ in range(2)]
            for h, u in zip(hs, utts):
                for i in range(0, u.size, 5000):
                    streams.feed(h, u[i: i + 5000])
                streams.close_session(h)
            for h, u in zip(hs, utts):
                got = np.concatenate(list(streams.iter_results(h)))
                np.testing.assert_allclose(got, stream_comp.compute_full(u), rtol=0, atol=TOL_FLOAT)
    finally:
        dist.destroy_process_group()
