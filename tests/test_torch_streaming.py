"""speech_tpu_torch.streaming's StreamingSTFT and StreamingSI against
speech_tpu.streaming's on the same chunks, in float64 on the CPU: every
streamed row within 1e-10 of the JAX streamer's (the digit tiers, float32
only, within the 2e-6 of tests/test_torch_si.py), and the port's own
contracts: a valid-0 step leaves the state bitwise equal, and S streams on
the stream axis in one call give the counts and integer leaves of S
single-stream calls and features within 1e-12 of them (within 1e-10 of
JAX's vmap of the same streamer)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu.compute import SIFrameComputer as JaxSI
from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.streaming import StreamingSI as JaxStreamingSI
from speech_tpu.streaming import StreamingSTFT as JaxStreamingSTFT

from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
from speech_tpu_torch.streaming import StreamingSI, StreamingSTFT

TOL = 1e-10
TOL_STREAMS = 1e-12  # the stream axis against single-stream calls
TOL_DIGIT = 2e-6  # the digit tiers, port vs JAX (tests/test_torch_si.py)

BANK = {"name": "fbank", "num_filts": 10, "sampling_rate": 8000}
SI_BANKS = {
    "fbank": {"name": "fbank", "num_filts": 6, "sampling_rate": 8000},
    "gammatone": {"name": "gammatone", "scaling_function": "mel", "num_filts": 5,
                  "sampling_rate": 8000},
    "gabor": {"name": "gabor", "scaling_function": "mel", "num_filts": 4,
              "sampling_rate": 8000},
}


def _np(t):
    return t.detach().cpu().numpy()


def _stft(**kw):
    kw = {"frame_length_ms": 25, "frame_shift_ms": 10, "dtype": "float64", **kw}
    return JaxSTFT(dict(BANK), **kw), STFTFrameComputer(dict(BANK), device="cpu", **kw)


def _si(bank="fbank", **kw):
    kw = {"dtype": "float64", **kw}
    return JaxSI(dict(SI_BANKS[bank]), **kw), SIFrameComputer(dict(SI_BANKS[bank]), device="cpu", **kw)


def _streamers(kind, chunk, **kw):
    if kind == "stft":
        j, t = _stft(**kw)
        return JaxStreamingSTFT(j, chunk), StreamingSTFT(t, chunk)
    bank = kw.pop("bank", "fbank")
    j, t = _si(bank, **kw)
    return JaxStreamingSI(j, chunk), StreamingSI(t, chunk)


def _feed(stream, splits, signal, fill=0.0, chunk=None):
    """Feed ``signal`` in pieces of ``splits`` samples, each in a chunk of
    the stream's size whose tail holds ``fill``; returns the concatenated
    valid rows and the final state."""
    chunk = chunk or stream.chunk_size
    state = stream.init_state()
    outs = []
    off = 0
    for v in splits:
        buf = np.full(chunk, fill)
        buf[:v] = signal[off : off + v]
        off += v
        state, feats, nf = stream.process(state, buf, v)
        outs.append(np.asarray(feats if isinstance(feats, jax.Array) else _np(feats))[: int(nf)])
    feats, nf = stream.finalize(state)
    outs.append(np.asarray(feats if isinstance(feats, jax.Array) else _np(feats))[: int(nf)])
    return np.concatenate(outs), state


def _check(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _leaves(state):
    return [np.asarray(x) if isinstance(x, jax.Array) else _np(x) for x in state]


# --- whole signals through transform (scan) ---------------------------------

# (style, kaldi_shift, chunk, length): every chunk size against ragged,
# short and empty signals; chunks 1 and 7 sit below pad_left (100)
STFT_CASES = [
    ("centered", False, 1, 1000),
    ("centered", False, 7, 4567),
    ("centered", False, 160, 4567),
    ("centered", False, 1600, 4567),
    ("centered", False, 160, 0),
    ("centered", False, 160, 150),  # shorter than one frame (200)
    ("centered", False, 37, 1000),
    ("causal", False, 7, 4567),
    ("causal", False, 160, 3001),
    ("causal", False, 1600, 50),
    ("causal", False, 1600, 0),
    ("centered", True, 160, 4000),
    ("centered", True, 1600, 4567),
]


@pytest.mark.parametrize("style,kaldi,chunk,length", STFT_CASES)
def test_stft_transform_matches_jax(style, kaldi, chunk, length):
    js, ts = _streamers("stft", chunk, frame_style=style, kaldi_shift=kaldi)
    signal = np.random.RandomState(length + chunk).randn(length)
    want = js.transform(signal)
    got = ts.transform(signal)
    _check(got, want)
    assert got.shape[0] == ts.computer.compute_full(signal).shape[0]


SI_CASES = [
    ("fbank", "matmul", False, "centered", 800, 3000),
    ("fbank", "matmul", True, "causal", 800, 2401),
    ("fbank", "fft", True, "centered", 800, 3000),
    ("fbank", "fft", False, "causal", 160, 799),
    ("fbank", "auto", True, "centered", 1600, 0),
    ("gabor", "matmul", True, "centered", 640, 3000),
    ("gabor", "fft", False, "centered", 256, 2000),
    ("gammatone", "direct", True, "causal", 1024, 3000),
]


@pytest.mark.parametrize("bank,mode,energy,style,chunk,length", SI_CASES)
def test_si_transform_matches_jax(bank, mode, energy, style, chunk, length):
    js, ts = _streamers("si", chunk, bank=bank, conv_mode=mode, include_energy=energy,
                        frame_style=style)
    assert ts.conv_mode == js.conv_mode
    signal = np.random.RandomState(length + chunk).randn(length)
    want = js.transform(signal)
    got = ts.transform(signal)
    _check(got, want)
    assert got.shape[0] == ts.computer.compute_full(signal).shape[0]


@pytest.mark.parametrize("precision", ["double", "accurate"])
@pytest.mark.parametrize("bank", ["fbank", "gammatone"])
def test_si_digit_tiers_match_jax(bank, precision):
    """The digit tiers stream through block_conv_parts' digit products:
    the port's stream against JAX's on a loud-transient / quiet-tail
    signal, and against the port's compute_full."""
    kw = dict(dtype="float32", precision=precision, include_energy=True)
    js, ts = _streamers("si", 640, bank=bank, **kw)
    rng = np.random.RandomState(96)
    n = 2500
    signal = rng.randn(n) * (1 + 100 * (rng.rand(n) < 0.01))
    signal[-n // 4 :] *= 1e-3
    signal = signal.astype(np.float32)
    want = js.transform(signal)
    got = ts.transform(signal)
    _check(got, want, TOL_DIGIT)
    _check(got, ts.computer.compute_full(signal), TOL_DIGIT)


# --- chunk by chunk -----------------------------------------------------------

SPLITS = [250, 400, 17, 0, 333, 400, 400, 200]


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_masked_chunks_with_garbage_tails(kind):
    """Arbitrary valid lengths, chunk tails of zeros or of NaN / inf /
    1e30: the JAX stream's rows, and bitwise the same rows whatever the
    tails hold."""
    js, ts = _streamers(kind, 400)
    signal = np.random.RandomState(95).randn(sum(SPLITS))
    want, _ = _feed(js, SPLITS, signal)
    got, _ = _feed(ts, SPLITS, signal)
    _check(got, want)
    for fill in (np.nan, np.inf, 1e30):
        other, _ = _feed(ts, SPLITS, signal, fill)
        assert np.array_equal(other, got), fill


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_finalize_before_any_emission_and_empty_stream(kind):
    js, ts = _streamers(kind, 160)
    signal = np.random.RandomState(84).randn(165)
    want, _ = _feed(js, [160, 5], signal)
    got, _ = _feed(ts, [160, 5], signal)
    _check(got, want)
    feats, nf = ts.finalize(ts.init_state())
    assert int(nf) == 0 and feats.shape[-1] == ts.computer.num_coeffs


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_process_many_and_wide_match_single_steps(kind):
    """k chunks through process_many, and the same samples in one wide
    masked buffer, against k process calls and against JAX's
    process_many."""
    js, ts = _streamers(kind, 800)
    sig = np.random.RandomState(97).randn(800 * 5 + 321)
    k = 6
    pad = np.zeros(k * 800)
    pad[: len(sig)] = sig
    chunks = pad.reshape(k, 800)
    valids = np.clip(len(sig) - np.arange(k) * 800, 0, 800)
    single, _ = _feed(ts, list(valids), sig)
    state, feats, nfs = ts.process_many(ts.init_state(), chunks, valids)
    fin, fin_n = ts.finalize(state)
    outs = [_np(feats[j])[: int(nfs[j])] for j in range(k)] + [_np(fin)[: int(fin_n)]]
    assert np.array_equal(np.concatenate(outs), single)
    jstate, jfeats, jnfs = js.process_many(js.init_state(), jnp.asarray(chunks),
                                           jnp.asarray(valids, jnp.int32))
    np.testing.assert_array_equal(_np(nfs), np.asarray(jnfs))
    for j in range(k):
        _check(_np(feats[j])[: int(nfs[j])], np.asarray(jfeats[j])[: int(jnfs[j])])
    wide = np.zeros(800 * 8)
    wide[: len(sig)] = sig
    state, feats, nf = ts.process_wide(ts.init_state(), wide, len(sig))
    fin, fin_n = ts.finalize(state)
    got = np.concatenate([_np(feats)[: int(nf)], _np(fin)[: int(fin_n)]])
    _check(got, single, TOL_STREAMS)
    with pytest.raises(ValueError):
        ts.process_many(state, np.zeros((2, 999)), np.zeros(2, np.int64))
    with pytest.raises(ValueError):
        ts.process(state, np.zeros(799))


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_valid_zero_step_is_bitwise_noop(kind):
    _, ts = _streamers(kind, 400)
    signal = np.random.RandomState(12).randn(1000)
    state = ts.init_state()
    state, _, _ = ts.process(state, signal[:400])
    state, _, _ = ts.process(state, signal[400:800], 57)
    idle, _, n = ts.process(state, np.full(400, np.inf), 0)
    assert int(n) == 0
    for a, b in zip(_leaves(state), _leaves(idle)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["stft", "si"])
def test_stream_axis_matches_single_streams_and_jax_vmap(kind):
    """Three streams in one call per tick (different valid lengths, one
    idle tick) against three single-stream runs, and against JAX's vmap
    of its _process_impl / _finalize_impl."""
    js, ts = _streamers(kind, 400)
    S, ticks = 3, 5
    rng = np.random.RandomState(88)
    chunks = rng.randn(ticks, S, 400)
    valids = rng.randint(0, 401, size=(ticks, S))
    valids[2, 1] = 0
    state = ts.init_state(streams=S)
    jstate = jax.vmap(lambda _: js.init_state())(jnp.arange(S))
    jproc = jax.jit(jax.vmap(js._process_impl))
    singles = [ts.init_state() for _ in range(S)]
    for t in range(ticks):
        state, feats, nf = ts._process_impl(state, chunks[t], torch.as_tensor(valids[t]))
        jstate, jfeats, jnf = jproc(jstate, jnp.asarray(chunks[t]), jnp.asarray(valids[t]))
        np.testing.assert_array_equal(_np(nf), np.asarray(jnf))
        for s in range(S):
            singles[s], f1, n1 = ts._process_impl(singles[s], chunks[t, s], int(valids[t, s]))
            assert int(n1) == int(nf[s])
            n = int(n1)
            _check(_np(feats[s])[:n], _np(f1)[:n], TOL_STREAMS)
            _check(_np(feats[s])[:n], np.asarray(jfeats[s])[:n])
    for s in range(S):
        for a, b in zip(state, singles[s]):
            if not a.is_floating_point():
                assert torch.equal(a[s], b)
            else:
                np.testing.assert_allclose(_np(a[s]), _np(b), rtol=0, atol=TOL_STREAMS)
    feats, nf = ts._finalize_impl(state)
    jfeats, jnf = jax.vmap(js._finalize_impl)(jstate)
    np.testing.assert_array_equal(_np(nf), np.asarray(jnf))
    for s in range(S):
        f1, n1 = ts._finalize_impl(singles[s])
        n = int(n1)
        assert n == int(nf[s])
        _check(_np(feats[s])[:n], _np(f1)[:n], TOL_STREAMS)
        _check(_np(feats[s])[:n], np.asarray(jfeats[s])[:n])


def test_scan_on_the_stream_axis():
    """scan over (S, L) signals with per-stream lengths gives each stream's
    transform."""
    _, ts = _streamers("stft", 512)
    rng = np.random.RandomState(92)
    signals = rng.randn(2, 3210)
    lengths = np.array([3210, 1999])
    feats, counts, fin, fin_n = ts.scan(signals, torch.as_tensor(lengths))
    for s in range(2):
        rows = [_np(feats[s, i])[: int(counts[s, i])] for i in range(feats.shape[1])]
        rows.append(_np(fin[s])[: int(fin_n[s])])
        _check(np.concatenate(rows), ts.transform(signals[s, : lengths[s]]), TOL_STREAMS)


def test_constructor_rules():
    j, t = _stft()
    with pytest.raises(ValueError):
        StreamingSTFT(t, 0)
    with pytest.raises(ValueError):
        StreamingSTFT(_si()[1], 400)
    with pytest.raises(ValueError):
        StreamingSI(t, 400)
    _, wide_shift = _stft(frame_length_ms=10, frame_shift_ms=20)
    with pytest.raises(ValueError, match="frame_shift"):
        StreamingSTFT(wide_shift, 400)
    state = StreamingSTFT(t, 400).init_state()
    assert state.carry.dtype == torch.float64 and state.carry.device.type == "cpu"
    assert len(state) == len(JaxStreamingSTFT(j, 400).init_state())


def test_streamer_needs_a_device():
    """With no GPU, a computer built without a device cannot stream: the
    port raises rather than run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    computer = STFTFrameComputer(dict(BANK), dtype="float64")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSTFT(computer, 400)
