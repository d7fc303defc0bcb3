"""speech_tpu_torch.streaming.StreamingPitch against
speech_tpu.streaming.StreamingPitch on the same chunks, in float64 on the
CPU: the emitted lag path equal to JAX's on every frame, f0 within rtol
1e-9 and the NCCF within 1e-9; with a lookahead covering the signal, also
the port's offline kaldi_pitch.  Port-only: chunk-size invariance and
arbitrary chunking, a valid-0 step leaves the state bitwise equal, S
sessions on the stream axis against S single sessions (and JAX's vmap),
and a 20 s float32 stream against the float64 one (the cost shift that
the reference's stream lacks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu.ops import pitch as JP
from speech_tpu.streaming import StreamingPitch as JaxStreamingPitch

from speech_tpu_torch.ops import pitch as TP
from speech_tpu_torch.streaming import StreamingPitch

RATE = 16000
RTOL_F0 = 1e-9
TOL = 1e-9
TOL_STREAMS = 1e-12
RTOL_F32 = 1e-3  # float32 against float64 on voiced frames (chip_smoke.py)


def _speechy(seconds, seed=0, f0_base=140.0, f0_swing=60.0, gap=None, rate=RATE):
    """A vibrato tone + noise; optionally a near-silent gap [lo, hi)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0t = f0_base + f0_swing * np.sin(2 * np.pi * 0.7 * t)
    x = np.sin(2 * np.pi * np.cumsum(f0t) / rate) + 0.1 * rng.randn(len(t))
    if gap is not None:
        lo, hi = gap
        x[lo:hi] = 0.01 * rng.randn(hi - lo)
    return x


def _np(t):
    return t.detach().cpu().numpy()


def _encode_path(monkeypatch, module):
    """Make ``module._refine_lags`` also return the Viterbi path: the nccf
    column carries ``nccf + 4 * lag index`` (|nccf| <= 1)."""
    refine = module._refine_lags

    def wrapped(path, nccf_pov, *args):
        f0, nccf = refine(path, nccf_pov, *args)
        return f0, nccf + 4.0 * path

    monkeypatch.setattr(module, "_refine_lags", wrapped)


def _decode(f0, col):
    path = np.round(col / 4.0)
    return f0, col - 4.0 * path, path.astype(np.int64)


# name -> (StreamingPitch arguments, signal)
CONFIGS = {
    "lookahead50": (
        dict(rate=RATE, chunk_size=1600, lookahead_frames=50),
        lambda: _speechy(1.5, seed=1, gap=(RATE // 2, RATE // 2 + 4000)),
    ),
    "full_lookahead": (
        dict(rate=RATE, chunk_size=1600, lookahead_frames=200, ballast_ms=0.25),
        lambda: _speechy(0.8, seed=0),
    ),
    "no_resample_no_lowpass": (
        dict(rate=4000.0, chunk_size=400, lookahead_frames=100, ballast_ms=0.2,
             resample_rate=4000.0, lowpass_cutoff=None),
        lambda: _speechy(1.0, seed=5, f0_base=200.0, f0_swing=10.0, rate=4000),
    ),
}


@pytest.fixture(scope="module")
def tracks():
    """Each configuration streamed once by both packages, the path
    encoded into the nccf column: ``{name: (jax, torch)}`` of ``(f0,
    nccf, path)``."""
    mp = pytest.MonkeyPatch()
    _encode_path(mp, JP)
    _encode_path(mp, TP)
    out = {}
    try:
        for name, (kw, make) in CONFIGS.items():
            x = make()
            j = JaxStreamingPitch(dtype=jnp.float64, **kw)
            t = StreamingPitch(dtype=torch.float64, device="cpu", **kw)
            out[name] = (_decode(*j.transform(x)), _decode(*t.transform(x)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_matches_jax(tracks, name):
    (jf0, jnc, jpath), (tf0, tnc, tpath) = tracks[name]
    assert tf0.shape == jf0.shape
    assert np.array_equal(tpath, jpath)
    np.testing.assert_allclose(tf0, jf0, rtol=RTOL_F0, atol=0)
    np.testing.assert_allclose(tnc, jnc, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["full_lookahead", "no_resample_no_lowpass"])
def test_full_lookahead_equals_offline(tracks, name):
    """A lookahead covering the signal: the stream is the port's offline
    tracker."""
    kw, make = CONFIGS[name]
    kw = dict(kw)
    rate = kw.pop("rate")
    for key in ("chunk_size", "lookahead_frames"):
        kw.pop(key)
    want = TP.kaldi_pitch(make(), rate, device="cpu", **kw)
    _, (f0, nccf, _) = tracks[name]
    np.testing.assert_allclose(f0, _np(want.f0), rtol=RTOL_F0, atol=0)
    np.testing.assert_allclose(nccf, _np(want.nccf), rtol=0, atol=TOL)


def _run(sp, x, sizes):
    """Feed ``x`` in pieces of ``sizes`` (each zero-padded to a multiple
    of the chunk) through process, then finalize: the valid (f0, nccf)."""
    N = sp.chunk_size
    state = sp.init_state()
    f0s, ncs = [], []
    taken = 0
    for v in sizes:
        buf = np.zeros(max(1, -(-v // N)) * N)
        buf[:v] = x[taken : taken + v]
        taken += v
        state, tr = sp.process(state, buf, v)
        n = int(tr.valid.sum())
        f0s.append(_np(tr.f0)[:n])
        ncs.append(_np(tr.nccf)[:n])
    fin = sp.finalize(state)
    n = int(fin.valid.sum())
    f0s.append(_np(fin.f0)[:n])
    ncs.append(_np(fin.nccf)[:n])
    return np.concatenate(f0s), np.concatenate(ncs)


def test_chunk_size_invariance_and_arbitrary_chunking():
    """Chunks of 800 and of 1600, and irregular valid lengths (staging),
    give the same track."""
    x = _speechy(1.2, seed=2)
    kw = dict(lookahead_frames=40, dtype=torch.float64, ballast_ms=0.2, device="cpu")
    a = StreamingPitch(RATE, chunk_size=1600, **kw)
    f0_a, nc_a = a.transform(x)
    f0_b, nc_b = StreamingPitch(RATE, chunk_size=800, **kw).transform(x)
    np.testing.assert_allclose(f0_b, f0_a, rtol=RTOL_F0)
    np.testing.assert_allclose(nc_b, nc_a, atol=TOL)
    rng = np.random.RandomState(11)
    sizes = []
    while sum(sizes) < len(x):
        sizes.append(int(min(rng.randint(1, 3200), len(x) - sum(sizes))))
    f0_c, nc_c = _run(a, x, sizes)
    np.testing.assert_allclose(f0_c, f0_a, rtol=1e-12)
    np.testing.assert_allclose(nc_c, nc_a, atol=1e-12)


def test_valid_zero_step_is_bitwise_noop():
    x = _speechy(0.5, seed=12)
    sp = StreamingPitch(RATE, chunk_size=1600, lookahead_frames=10, dtype=torch.float64,
                        device="cpu")
    state = sp.init_state()
    state, _, _ = sp._process_impl(state, x[:1600], 1600)
    state, _, _ = sp._process_impl(state, x[1600:3200], 900)
    idle, _, ne = sp._process_impl(state, np.full(1600, np.inf), 0)
    assert int(ne) == 0
    for a, b in zip(state, idle):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_stream_axis_matches_single_sessions_and_jax_vmap():
    """Three sessions (different voices, valid lengths, one idle tick) in
    one call per tick, against three single-session runs and against
    JAX's vmap of its _process_impl / _finalize_impl."""
    S, N = 3, 1600
    xs = [_speechy(0.9, seed=6 + s, f0_base=110.0 + 70 * s, f0_swing=20.0) for s in range(S)]
    kw = dict(chunk_size=N, lookahead_frames=10, ballast_ms=0.25)
    sp = StreamingPitch(RATE, dtype=torch.float64, device="cpu", **kw)
    js = JaxStreamingPitch(RATE, dtype=jnp.float64, **kw)
    # two-chunk buffers: one JAX program for every tick
    valids = np.array([[3200, 1000, 3200], [3200, 3000, 0], [1600, 3200, 3200],
                       [700, 3200, 3200], [3200, 3200, 3200]])
    jproc = jax.jit(jax.vmap(js._process_impl))
    state = sp.init_state(streams=S)
    singles = [sp.init_state() for _ in range(S)]
    jstate = jax.vmap(lambda _: js.init_state())(jnp.arange(S))
    off = np.zeros(S, np.int64)
    outs = {"axis": [[] for _ in range(S)], "single": [[] for _ in range(S)],
            "jax": [[] for _ in range(S)]}
    for v in valids:
        bufs = np.zeros((S, 2 * N))
        for s in range(S):
            piece = xs[s][off[s] : off[s] + v[s]]
            bufs[s, : len(piece)] = piece
            v[s] = len(piece)
        off += v
        state, feats, ne = sp._process_impl(state, bufs, torch.as_tensor(v))
        jstate, jfeats, jne = jproc(jstate, jnp.asarray(bufs), jnp.asarray(v))
        np.testing.assert_array_equal(_np(ne), np.asarray(jne))
        for s in range(S):
            singles[s], f1, n1 = sp._process_impl(singles[s], bufs[s], int(v[s]))
            assert int(n1) == int(ne[s])
            outs["axis"][s].append(_np(feats[s])[: int(ne[s])])
            outs["single"][s].append(_np(f1)[: int(n1)])
            outs["jax"][s].append(np.asarray(jfeats[s])[: int(jne[s])])
    for s in range(S):
        for a, b in zip(state, singles[s]):
            if a.is_floating_point():
                np.testing.assert_allclose(_np(a[s]), _np(b), rtol=0, atol=TOL_STREAMS)
            else:
                assert torch.equal(a[s], b)
    feats, ne = sp._finalize_impl(state)
    jfeats, jne = jax.jit(jax.vmap(js._finalize_impl))(jstate)
    np.testing.assert_array_equal(_np(ne), np.asarray(jne))
    for s in range(S):
        f1, n1 = sp._finalize_impl(singles[s])
        outs["axis"][s].append(_np(feats[s])[: int(ne[s])])
        outs["single"][s].append(_np(f1)[: int(n1)])
        outs["jax"][s].append(np.asarray(jfeats[s])[: int(jne[s])])
        axis, single, jx = (np.concatenate(outs[k][s]) for k in ("axis", "single", "jax"))
        assert axis.shape == single.shape == jx.shape and axis.shape[0] > 40
        np.testing.assert_allclose(axis, single, rtol=TOL_STREAMS, atol=0)
        np.testing.assert_allclose(axis[:, 0], jx[:, 0], rtol=RTOL_F0, atol=0)
        np.testing.assert_allclose(axis[:, 1], jx[:, 1], rtol=0, atol=TOL)


def test_float32_long_stream_keeps_the_float64_path():
    """20 s of a vibrato voice in float32 against the same stream in
    float64: f0 within rtol 1e-3 on every voiced frame.  The reference's
    stream carries its Viterbi costs unshifted; they grow by about one a
    frame, and in float32 their rounding passes the 1e-5 cost of a step
    between neighbouring lags."""
    x = _speechy(20.0, seed=21, f0_base=150.0, f0_swing=40.0)
    kw = dict(chunk_size=1600, lookahead_frames=50, device="cpu")
    f0_64, nc_64 = StreamingPitch(RATE, dtype=torch.float64, **kw).transform(x)
    f0_32, _ = StreamingPitch(RATE, dtype=torch.float32, **kw).transform(x.astype(np.float32))
    assert f0_32.shape == f0_64.shape and f0_32.dtype == np.float32
    voiced = nc_64 > 0.5
    assert voiced.mean() > 0.9
    np.testing.assert_allclose(f0_32[voiced], f0_64[voiced], rtol=RTOL_F32, atol=0)


def test_validation_errors():
    with pytest.raises(ValueError, match="multiple"):
        StreamingPitch(RATE, chunk_size=1601, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        StreamingPitch(RATE, chunk_size=0, device="cpu")
    with pytest.raises(ValueError, match="lookahead"):
        StreamingPitch(RATE, chunk_size=1600, lookahead_frames=-1, device="cpu")
    sp = StreamingPitch(RATE, chunk_size=1600, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        sp.process(sp.init_state(), np.zeros(1000))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingPitch(RATE, chunk_size=1600)
