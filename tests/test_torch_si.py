"""speech_tpu_torch's short integration (ops/si.py and
ShortIntegrationFrameComputer) against speech_tpu's on the same signals:
the host builders bit for bit, the pipeline in every convolution mode and
precision tier, and the computer's batch, int16, streaming and guard
paths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_tpu import config as jconfig
from speech_tpu.compute import SIFrameComputer as JaxSI
from speech_tpu.filters import HannWindow as JaxHann
from speech_tpu.alias import alias_factory_subclass_from_arg as j_factory
from speech_tpu.filters import LinearFilterBank as JaxBank
from speech_tpu.ops import si as JS
from speech_tpu.ops import stft as JST

from speech_tpu_torch import config as tconfig
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as t_factory
from speech_tpu_torch.compute import (
    FrameComputer,
    SIFrameComputer,
    frame_by_frame_calculation,
    params_from_jax,
)
from speech_tpu_torch.filters import HannWindow
from speech_tpu_torch.filters import LinearFilterBank
from speech_tpu_torch.ops import si as TS
from speech_tpu_torch.ops import stft as TST

TOL_F64 = 1e-8  # the reference's own (tests/test_si.py:65)
TOL_F32 = 1e-4  # float32 sums in other orders
TOL_DIGIT = 2e-6  # the digit tiers, port vs JAX (tests/test_si.py:329)
TOL_DIGIT_F64 = 1e-5  # the digit tiers vs float64 (tests/test_si.py:297)

BANKS = {
    "fbank": {"name": "fbank", "num_filts": 6, "sampling_rate": 8000},
    "gammatone": {
        "name": "gammatone", "scaling_function": "mel", "num_filts": 6,
        "sampling_rate": 8000,
    },
    "gabor": {
        "name": "gabor", "scaling_function": "mel", "num_filts": 6,
        "sampling_rate": 8000,
    },
}


def _kernels(bank, frame_style, include_energy=True):
    """The JAX and the port's host kernels of one bank, 10 ms shift."""
    jb = j_factory(JaxBank, dict(BANKS[bank]))
    tb = t_factory(LinearFilterBank, dict(BANKS[bank]))
    shift = 80
    jw = JaxHann().get_impulse_response(2 * shift)
    tw = HannWindow().get_impulse_response(2 * shift)
    return (
        JS.build_si_kernel(jb, shift, frame_style, jw, include_energy),
        TS.build_si_kernel(tb, shift, frame_style, tw, include_energy),
    )


@pytest.mark.parametrize("frame_style", ["causal", "centered"])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_build_si_kernel_equal(bank, frame_style):
    want, got = _kernels(bank, frame_style)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("bank", ["fbank", "gabor"])
def test_toeplitz_conv_blocks_equal(bank):
    want, got = _kernels(bank, "causal")
    for part in (np.real, np.imag):
        firs = np.ascontiguousarray(part(want["firs"]))
        for V in (TS.CONV_BLOCK, 16):
            a = JS.toeplitz_conv_blocks(firs, V)
            b = TS.toeplitz_conv_blocks(firs, V)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_si_constants_and_digitize_equal():
    """The SI digit constants, the memory limit and the margin digitiser
    of the 'accurate' band planes are the JAX package's."""
    assert TS.CONV_BLOCK == JS.CONV_BLOCK
    assert tconfig.SI_DIGIT_PARAM_BYTE_LIMIT == jconfig.SI_DIGIT_PARAM_BYTE_LIMIT
    for name in ("_SI_X_DIGITS", "_SI_PAIR_CUTOFF", "_SAK_BASE", "_SAK_X_DIGITS",
                 "_SAK_M_DIGITS", "_SAK_CUTOFF", "_SAK_KCHUNK"):
        assert getattr(TST, name) == getattr(JST, name), name
    want, _ = _kernels("fbank", "causal")
    band = JS.toeplitz_conv_blocks(np.ascontiguousarray(want["firs"].real))
    for args in ((JST._SAK_M_DIGITS, JST._SAK_BASE), (JST._M_DIGITS, JST._DIGIT_BASE)):
        a, sa = JST.digitize_matrix(band, *args, margin=True)
        b, sb = TST.digitize_matrix(band, *args, margin=True)
        assert np.array_equal(a, b) and sa == sb


# conv mode -> (buffer length, fft_size): 'fft-single' keeps fft_size below
# 4 * next_pow2(2T), 'fft-blocked' at or above it (overlap-save)
def _case(mode, T, n):
    if mode == "fft-single":
        size = TS._next_pow2(n + T)
        assert size < 4 * TS._next_pow2(2 * T)
        return "fft", size
    if mode == "fft-blocked":
        size = max(TS._next_pow2(n + T), 4 * TS._next_pow2(2 * T))
        return "fft", size
    return mode, TS._next_pow2(n + T)


def _params(kernel, mode, dtype):
    """``(jax params, torch params)`` of a host kernel for a conv mode."""
    firs = kernel["firs"]
    p = {"firs_re": firs.real.astype(dtype), "window": kernel["window"].astype(dtype)}
    if not kernel["is_real"]:
        p["firs_im"] = firs.imag.astype(dtype)
    if mode == "matmul":
        p["conv_re_blocks"] = TS.toeplitz_conv_blocks(np.ascontiguousarray(firs.real)).astype(dtype)
        if not kernel["is_real"]:
            p["conv_im_blocks"] = TS.toeplitz_conv_blocks(
                np.ascontiguousarray(firs.imag)).astype(dtype)
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.tensor(v) for k, v in p.items()}


MODES = ["direct", "matmul", "fft-single", "fft-blocked"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("frame_style", ["causal", "centered"])
@pytest.mark.parametrize("use_power", [False, True], ids=["mag", "power"])
@pytest.mark.parametrize("bank", ["fbank", "gabor"], ids=["real", "complex"])
@pytest.mark.parametrize("mode", MODES)
def test_si_feats_from_signal_matches_jax(mode, bank, use_power, frame_style, dtype):
    """Two signals of different lengths in one batch through the port
    against the JAX function on each alone."""
    jk, tk = _kernels(bank, frame_style)
    T = tk["max_support"]
    n = 120 if (mode == "fft-single" and bank == "gabor") else 1500
    conv_mode, fft_size = _case(mode, T, n)
    shift = tk["frame_shift"]
    num_frames = (n + shift // 2) // shift
    spec = dict(
        frame_shift=shift, shift_eff=tk["shift_eff"], max_support=T,
        is_real=tk["is_real"], include_energy=True, use_log=True,
        use_power=use_power, log_floor=1e-5, fft_size=fft_size,
        energy_offset=tk["shift_eff"] - tk["translation"], conv_mode=conv_mode,
    )
    jp, tp = _params(tk, conv_mode, dtype)
    rng = np.random.RandomState(60)
    lens = [n, n * 2 // 3]
    sigs = rng.randn(2, n).astype(dtype)
    sigs[1, lens[1]:] = 0
    got = TS.si_feats_from_signal(
        torch.tensor(sigs), torch.tensor(lens), num_frames, tp, **spec
    )
    assert got.dtype == getattr(torch, dtype)
    tol = TOL_F64 if dtype == "float64" else TOL_F32
    for row in range(2):
        want = np.asarray(JS.si_feats_from_signal(
            jnp.asarray(sigs[row]), lens[row], num_frames, jp, **spec))
        assert got[row].shape == want.shape
        assert np.abs(got[row].numpy() - want).max() <= tol
    # one signal as (L,): the JAX function's own layout
    one = TS.si_feats_from_signal(torch.tensor(sigs[0]), n, num_frames, tp, **spec)
    assert (one - got[0]).abs().max().item() <= tol


def _pair(bank, **kw):
    return JaxSI(dict(BANKS[bank]), **kw), SIFrameComputer(dict(BANKS[bank]), device="cpu", **kw)


@pytest.mark.parametrize(
    "conv_mode", ["direct", "matmul", "fft"],
)
@pytest.mark.parametrize("bank", ["fbank", "gammatone"], ids=["real", "complex"])
@pytest.mark.parametrize("dtype,tol", [("float64", TOL_F64), ("float32", TOL_F32)])
def test_compute_full_matches_jax(bank, conv_mode, dtype, tol):
    jc, tc = _pair(bank, conv_mode=conv_mode, include_energy=True, dtype=dtype)
    rng = np.random.RandomState(61)
    for n in (3000, 250, 40, 0):
        sig = rng.randn(n).astype(dtype)
        want = jc.compute_full(sig)
        got = tc.compute_full(sig)
        assert got.dtype == want.dtype and got.shape == want.shape, n
        assert np.abs(got - want).max(initial=0.0) <= tol, n


@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize("bank", ["fbank4", "gammatone"])
def test_digit_tiers_match_jax_and_float64(bank, precision):
    """The exact digit tiers: within 2e-6 of the JAX tier and 1e-5 of a
    float64 run.  fbank with 4 filters has a 1075-tap support: 10 shifted
    blocks, so 'accurate' runs its products in chunks of 8 and 2."""
    cfg = (dict(BANKS["fbank"], num_filts=4) if bank == "fbank4" else dict(BANKS[bank]))
    kw = dict(include_energy=True)
    jc = JaxSI(dict(cfg), precision=precision, **kw)
    tc = SIFrameComputer(dict(cfg), device="cpu", precision=precision, **kw)
    t64 = SIFrameComputer(dict(cfg), device="cpu", dtype="float64", conv_mode="matmul", **kw)
    if bank == "fbank4":
        assert tc.max_support > 8 * TS.CONV_BLOCK
    rng = np.random.RandomState(62)
    env = 0.05 + np.abs(np.sin(2 * np.pi * 3 * np.arange(4000) / 8000))
    sig = (rng.randn(4000) * env).astype(np.float32)
    sig[100] = 8.0  # a loud transient before quieter content
    got = tc.compute_full(sig)
    want = jc.compute_full(sig)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_DIGIT
    ref64 = t64.compute_full(sig.astype(np.float64))
    assert np.abs(got.astype(np.float64) - ref64).max() <= TOL_DIGIT_F64


@pytest.mark.parametrize("precision,dtype,tol", [
    ("highest", "float64", TOL_F64), ("highest", "float32", TOL_F32),
    ("double", "float32", TOL_DIGIT),
])
def test_compute_batch_matches_jax(precision, dtype, tol):
    """All-full and ragged batches (with a zero-length row)."""
    jc, tc = _pair("gammatone", include_energy=True, dtype=dtype, precision=precision)
    rng = np.random.RandomState(63)
    sigs = rng.randn(4, 2400).astype(dtype)
    for lengths in (np.full(4, 2400), np.array([2400, 1700, 300, 0])):
        sigs = sigs * (np.arange(2400)[None] < lengths[:, None])  # zero padding
        fj, cj = jc.compute_batch(sigs, lengths)
        ft, ct = tc.compute_batch(sigs, lengths)
        assert isinstance(ft, torch.Tensor) and ct.dtype == torch.int32
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert ft.shape == np.asarray(fj).shape
        for i, n in enumerate(ct.tolist()):
            err = np.abs(ft[i, :n].numpy() - np.asarray(fj)[i, :n]).max(initial=0.0)
            assert err <= tol, (i, err)


def test_compute_batch_int16_ingress():
    """int16 batches match the float path bit for bit, and JAX's int16
    path."""
    jc, tc = _pair("fbank", include_energy=True, dtype="float64")
    rng = np.random.RandomState(64)
    buf_i = (rng.randn(3, 2048) * 1000).astype(np.int16)
    buf_i[1, 1500:] = 0
    for lengths in (np.array([2048, 1500, 2048]), np.full(3, 2048)):
        f_i, c_i = tc.compute_batch(buf_i, lengths)
        f_f, c_f = tc.compute_batch(buf_i.astype(np.float64), lengths)
        f_j, _ = jc.compute_batch(buf_i, lengths)
        assert torch.equal(c_i, c_f)
        for i, n in enumerate(c_i.tolist()):
            assert torch.equal(f_i[i, :n], f_f[i, :n])
            assert np.abs(f_i[i, :n].numpy() - np.asarray(f_j)[i, :n]).max() <= TOL_F64


@pytest.mark.parametrize("bank", ["fbank", "gabor"])
def test_streaming_matches_batch_and_jax(bank):
    jc, tc = _pair(bank, include_energy=True, dtype="float64")
    sig = np.random.RandomState(65).randn(3210)
    want = tc.compute_full(sig)
    assert np.abs(want - jc.compute_full(sig)).max() <= TOL_F64
    for chunk_size in (7, 100, 1024, 10000):
        got = frame_by_frame_calculation(tc, sig, chunk_size=chunk_size)
        assert got.shape == want.shape, chunk_size
        assert np.abs(got - want).max() <= TOL_F64, chunk_size
    # the JAX computer's stream gives the same frames
    jstream = np.concatenate(
        [jc.compute_chunk(sig[:1000]), jc.compute_chunk(sig[1000:]), jc.finalize()]
    )
    tstream = np.concatenate(
        [tc.compute_chunk(sig[:1000]), tc.compute_chunk(sig[1000:]), tc.finalize()]
    )
    assert np.abs(tstream - jstream).max() <= TOL_F64


def test_streaming_rules():
    tc = SIFrameComputer(dict(BANKS["fbank"]), device="cpu", dtype="float64")
    assert tc.compute_full(np.zeros(0)).shape == (0, tc.num_coeffs)
    tc.compute_chunk(np.zeros(0))
    assert tc.finalize().shape == (0, tc.num_coeffs)
    with pytest.raises(ValueError, match="float type"):
        tc.compute_chunk(np.zeros(10, np.int16))
    tc.compute_chunk(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="share a type"):
        tc.compute_chunk(np.zeros(10, np.float64))
    with pytest.raises(ValueError, match="Already started"):
        tc.compute_full(np.zeros(10))
    tc.finalize()


def test_constructor_guards_match_jax():
    """The digit tiers' checks and the memory guard raise as the JAX
    computer's do, with the same message; the limit is the port's own
    config value (0 turns the guard off)."""
    bank = {"name": "fbank", "num_filts": 4, "sampling_rate": 8000}
    for kw in (dict(dtype="float64", precision="double"), dict(conv_mode="fft", precision="double"),
               dict(dtype="float64", precision="accurate"),
               dict(conv_mode="direct", precision="accurate"),
               dict(conv_mode="bogus"), dict(precision="bogus")):
        with pytest.raises(ValueError) as want:
            JaxSI(dict(bank), **kw)
        with pytest.raises(ValueError) as got:
            SIFrameComputer(dict(bank), device="cpu", **kw)
        assert str(got.value) == str(want.value)
    big = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
    for precision in ("double", "accurate"):
        with pytest.raises(ValueError) as want:
            JaxSI(dict(big), precision=precision)
        with pytest.raises(ValueError, match="GiB of digit parameter planes") as got:
            SIFrameComputer(dict(big), device="cpu", precision=precision)
        assert str(got.value) == str(want.value)
    old = tconfig.SI_DIGIT_PARAM_BYTE_LIMIT
    try:
        tconfig.SI_DIGIT_PARAM_BYTE_LIMIT = 0
        SIFrameComputer(dict(big), device="cpu", precision="double")
    finally:
        tconfig.SI_DIGIT_PARAM_BYTE_LIMIT = old


def test_alias_and_properties():
    tc = t_factory(FrameComputer, {"name": "si", "bank": dict(BANKS["gabor"]), "device": "cpu"})
    jc = JaxSI(dict(BANKS["gabor"]))
    assert isinstance(tc, SIFrameComputer)
    for name in ("frame_style", "frame_length", "frame_shift", "max_support", "num_coeffs",
                 "sampling_rate"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert np.array_equal(tc.frame_counts_np([0, 50, 3000]), jc.frame_counts_np([0, 50, 3000]))


@pytest.mark.parametrize("precision,bank", [
    ("highest", "gabor"), ("double", "gammatone"), ("accurate", "fbank"),
])
def test_params_from_jax(precision, bank):
    """The JAX computer's params and band matrices (or their digit planes
    and scales) carried over by params_from_jax give the port's own
    features."""
    kw = dict(include_energy=True, precision=precision, conv_mode="matmul")
    jc, tc = _pair(bank, **kw)
    spec = jc._spec(1024)
    jparams = {k: np.asarray(v) for k, v in jc._params_for(spec).items()}
    loaded = SIFrameComputer(dict(BANKS[bank]), device="cpu", **kw)
    loaded.load_params(params_from_jax(jparams))
    assert set(jparams) == loaded.param_keys() == tc.param_keys()
    sig = np.random.RandomState(66).randn(1500).astype(np.float32)
    got = loaded.compute_full(sig)
    assert np.array_equal(got, tc.compute_full(sig))
    with pytest.raises(ValueError, match="params lack"):
        loaded.load_params({"window": torch.zeros(160)})
