"""speech_tpu_torch.streaming_post against speech_tpu.streaming_post on the
same blocks, in float64 on the CPU: every op, the VAD, the chain, the
factory and the pipelines within 1e-10 of the JAX ops (splice, stack and
the fixed-threshold VAD bitwise).  The JAX op runs once per
configuration, on one chunking; the port's runs on every chunking of
CHUNKINGS against it.  Port-only: a valid-0 step leaves every op's state
bitwise equal, and S streams on the stream axis in one call give the
counts and integer leaves of S single-stream calls and rows within 1e-12
of them (within 1e-10 of JAX's vmap of the same chain)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu import post as jpost
from speech_tpu import streaming_post as JSP
from speech_tpu.compute import SIFrameComputer as JaxSI
from speech_tpu.compute import STFTFrameComputer as JaxSTFT

from speech_tpu_torch import post as tpost
from speech_tpu_torch import streaming_post as TSP
from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
from speech_tpu_torch.ops.vad import energy_vad

TOL = 1e-10
TOL_STREAMS = 1e-12

CHUNKINGS = {
    "ragged": [13, 1, 40, 7, 29, 60, 10],
    "one": [1] * 140,
    "wide": [200],
    "split": [137, 5],
}
# the JAX op's chunking: one block shape, so one compiled step
REF_CHUNKS = [48, 48, 48]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _blocks(feats, chunks):
    """``(block, n_valid)`` pairs: ``feats`` cut by ``chunks`` with the
    rows past the signal zero."""
    i = 0
    for c in chunks:
        block = np.zeros((c, feats.shape[1]))
        n = min(c, max(0, feats.shape[0] - i))
        block[:n] = feats[i : i + n]
        i += n
        yield block, n


def _stream(op, feats, chunks, jax_op=False):
    """Drive ``op`` block by block, then finalize: the valid rows."""
    if jax_op:
        st = op.init_state(feats.shape[1], jnp.float64)
    else:
        st = op.init_state(feats.shape[1], torch.float64)
    step, fin = op._step_impl, op._finalize_impl
    if jax_op:
        step, fin = jax.jit(step), jax.jit(fin)
    outs = []
    for block, n in _blocks(feats, chunks):
        x = jnp.asarray(block) if jax_op else torch.tensor(block)
        st, out, nout = step(st, x, n)
        outs.append(_np(out)[: int(nout)])
    out, nout = fin(st)
    outs.append(_np(out)[: int(nout)])
    return np.concatenate(outs)


def _pair(name, *args, **kw):
    """The JAX op and the port's, built alike."""
    return getattr(JSP, name)(*args, **kw), getattr(TSP, name)(*args, device="cpu", **kw)


def _check_all_chunkings(name, args, feats, exact=False, **kw):
    jop, top = _pair(name, *args, **kw)
    want = _stream(jop, feats, REF_CHUNKS, jax_op=True)
    for chunks in CHUNKINGS.values():
        got = _stream(top, feats, chunks)
        assert got.shape == want.shape, (got.shape, want.shape)
        if exact:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    return want


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(2024).standard_normal((137, 7))


@pytest.fixture(scope="module")
def vad_feats():
    rng = np.random.default_rng(7171)
    f = rng.standard_normal((137, 5))
    # column 0 plays the log energy: voiced and silent stretches
    f[:, 0] = np.where(rng.random(137) < 0.5, 8.0, 2.0) + 0.3 * rng.standard_normal(137)
    return f


@pytest.mark.parametrize("num_deltas,window", [(1, 2), (2, 3)])
def test_deltas(feats, num_deltas, window):
    want = _check_all_chunkings("StreamingDeltas", (num_deltas, window), feats)
    host = tpost.Deltas(num_deltas, context_window=window, target_axis=-1)
    np.testing.assert_allclose(want, host.apply(feats.copy(), axis=0), atol=1e-12)


@pytest.mark.parametrize("left,right", [(3, 5), (4, 4), (2, 0), (0, 3)])
def test_splice_bitwise(feats, left, right):
    want = _check_all_chunkings("StreamingSplice", (left, right), feats, exact=True)
    assert np.array_equal(want, tpost.Splice(left, right).apply(feats.copy(), axis=-1))


@pytest.mark.parametrize("m", [1, 3, 4])
@pytest.mark.parametrize("pad", [False, True])
def test_stack_bitwise(feats, m, pad):
    want = _check_all_chunkings("StreamingStack", (m, pad), feats, exact=True)
    host = tpost.Stack(m, pad_mode="edge" if pad else None)
    assert np.array_equal(want, host.apply(feats.copy(), axis=-1))


def test_pcen(feats):
    lin = np.abs(feats) + 0.1
    _check_all_chunkings("StreamingPCEN", (0.05, 0.9, 2.0, 0.5), lin)
    # per-channel parameters
    alpha = np.linspace(0.8, 0.99, 7)
    _check_all_chunkings("StreamingPCEN", (0.05, alpha, 2.0, 0.5), lin)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("norm_var", [False, True])
def test_sliding_cmvn(feats, center, norm_var):
    want = _check_all_chunkings("StreamingSlidingCMVN", (50, center, norm_var, 20), feats)
    host = tpost.SlidingCMVN(window=50, center=center, norm_var=norm_var, min_window=20)
    np.testing.assert_allclose(want, host.apply(feats.copy(), axis=-1), atol=1e-12)


@pytest.mark.parametrize("T", [0, 1, 3, 19, 20, 21, 49, 50, 51])
def test_sliding_cmvn_short_streams(T):
    """Every window-clipping regime near min_window and window."""
    x = np.random.default_rng(T).standard_normal((T, 3))
    for center in (True, False):
        jop, top = _pair("StreamingSlidingCMVN", 50, center, True, 20)
        want = _stream(jop, x, [7, 7, 7, 50], jax_op=True)
        got = _stream(top, x, [7, 7, 7, 50])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("T", [1, 2, 4, 5, 9])
def test_fir_short_streams(T):
    """Streams shorter than the FIR context: edge replication on both
    sides out of the same buffer."""
    x = np.random.default_rng(T).standard_normal((T, 3))
    for name, args in (("StreamingDeltas", (2, 2)), ("StreamingSplice", (4, 4))):
        jop, top = _pair(name, *args)
        want = _stream(jop, x, [3, 3, 3, 3], jax_op=True)
        got = _stream(top, x, [3, 3, 3, 3])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _chain_pair():
    j = JSP.StreamingPostChain([JSP.StreamingDeltas(2, 2), JSP.StreamingSlidingCMVN(50, False, True, 20),
                                JSP.StreamingSplice(2, 2)])
    t = TSP.StreamingPostChain([TSP.StreamingDeltas(2, 2, device="cpu"),
                                TSP.StreamingSlidingCMVN(50, False, True, 20, device="cpu"),
                                TSP.StreamingSplice(2, 2, device="cpu")], device="cpu")
    return j, t


def test_chain(feats):
    j, t = _chain_pair()
    assert t.out_width(7) == j.out_width(7) == 7 * 3 * 5
    assert (t.step_cap(40), t.fin_cap()) == (j.step_cap(40), j.fin_cap())
    want = _stream(j, feats, REF_CHUNKS, jax_op=True)
    for chunks in CHUNKINGS.values():
        got = _stream(t, feats, chunks)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# --- VAD ---------------------------------------------------------------------


@pytest.mark.parametrize("w", [0, 2, 5])
def test_vad_fixed_threshold_select(vad_feats, w):
    kw = dict(energy_threshold=5.0, energy_mean_scale=0.0, frames_context=w,
              proportion_threshold=0.6)
    want = _check_all_chunkings("StreamingVAD", (), vad_feats, exact=True, **kw)
    mask = _np(energy_vad(torch.tensor(vad_feats[:, 0]), **kw))
    assert np.array_equal(want, vad_feats[mask])


@pytest.mark.parametrize("w", [0, 3])
def test_vad_flag_mode(vad_feats, w):
    want = _check_all_chunkings("StreamingVAD", (), vad_feats, exact=True,
                                energy_mean_scale=0.0, frames_context=w, emit="flag")
    assert want.shape == (137, 6) and np.array_equal(want[:, :-1], vad_feats)


@pytest.mark.parametrize("w", [0, 2])
def test_vad_running_threshold(vad_feats, w):
    _check_all_chunkings("StreamingVAD", (), vad_feats, exact=True, energy_threshold=1.0,
                         energy_mean_scale=0.5, frames_context=w, proportion_threshold=0.6)


def test_vad_empty_silent_and_bad_config():
    _, top = _pair("StreamingVAD", energy_mean_scale=0.0, frames_context=2)
    out, n = top._finalize_impl(top.init_state(4, torch.float64))
    assert int(n) == 0
    assert _stream(top, np.full((50, 4), -20.0), [20, 30]).shape == (0, 4)
    for kw in (dict(frames_context=-1), dict(proportion_threshold=1.5),
               dict(energy_mean_scale=-0.1), dict(emit="gate")):
        with pytest.raises(ValueError):
            TSP.StreamingVAD(device="cpu", **kw)


# --- port-only contracts ------------------------------------------------------


def _ops():
    return [
        TSP.StreamingDeltas(1, 2, device="cpu"),
        TSP.StreamingSlidingCMVN(30, True, True, 10, device="cpu"),
        TSP.StreamingPCEN(device="cpu"),
        TSP.StreamingStack(3, pad=True, device="cpu"),
        TSP.StreamingSplice(2, 3, device="cpu"),
        TSP.StreamingVAD(energy_mean_scale=0.5, frames_context=3, device="cpu"),
        TSP.StreamingFrameLocal(lambda f: 2 * f, device="cpu"),
        _chain_pair()[1],
    ]


def test_valid_zero_step_is_bitwise_noop(feats):
    for op in _ops():
        st = op.init_state(7, torch.float64)
        st, _, _ = op._step_impl(st, torch.tensor(feats[:16]), 16)
        st2, _, n = op._step_impl(st, torch.full((16, 7), float("inf"), dtype=torch.float64), 0)
        assert int(n) == 0
        flat = [x for s in (st if isinstance(st, tuple) else (st,)) for x in
                (s if isinstance(s, tuple) else (s,))]
        flat2 = [x for s in (st2 if isinstance(st2, tuple) else (st2,)) for x in
                 (s if isinstance(s, tuple) else (s,))]
        for a, b in zip(flat, flat2):
            assert a.dtype == b.dtype and torch.equal(a, b), type(op)


@pytest.mark.parametrize("which", range(8))
def test_stream_axis_matches_single_streams(feats, which):
    """Three streams in one call per block, each with its own valid
    counts (one idle block), against three single-stream runs."""
    op = _ops()[which]
    S = 3
    rng = np.random.RandomState(which)
    blocks = [rng.standard_normal((S, c, 7)) + 3.0 for c in (13, 40, 1, 29)]
    counts = [rng.randint(0, b.shape[1] + 1, size=S) for b in blocks]
    counts[1][2] = 0
    state = op.init_state(7, torch.float64, streams=S)
    singles = [op.init_state(7, torch.float64) for _ in range(S)]
    outs_axis, outs_single = [[] for _ in range(S)], [[] for _ in range(S)]
    for b, c in zip(blocks, counts):
        state, out, n = op._step_impl(state, torch.tensor(b), torch.tensor(c))
        for s in range(S):
            singles[s], o1, n1 = op._step_impl(singles[s], torch.tensor(b[s]), int(c[s]))
            assert int(n1) == int(n[s])
            outs_axis[s].append(_np(out[s])[: int(n[s])])
            outs_single[s].append(_np(o1)[: int(n1)])
    out, n = op._finalize_impl(state)
    for s in range(S):
        o1, n1 = op._finalize_impl(singles[s])
        assert int(n1) == int(n[s])
        outs_axis[s].append(_np(out[s])[: int(n[s])])
        outs_single[s].append(_np(o1)[: int(n1)])
        a, b = np.concatenate(outs_axis[s]), np.concatenate(outs_single[s])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_STREAMS)


def test_stream_axis_matches_jax_vmap(feats):
    j, t = _chain_pair()
    S, cap = 3, 24
    rng = np.random.RandomState(5)
    jstate = jax.vmap(lambda _: j.init_state(7, jnp.float64))(jnp.arange(S))
    jstep = jax.jit(jax.vmap(j._step_impl))
    state = t.init_state(7, torch.float64, streams=S)
    got, want = [[] for _ in range(S)], [[] for _ in range(S)]
    for _ in range(5):
        block = rng.standard_normal((S, cap, 7))
        n = rng.randint(0, cap + 1, size=S)
        state, out, nout = t._step_impl(state, torch.tensor(block), torch.tensor(n))
        jstate, jout, jn = jstep(jstate, jnp.asarray(block), jnp.asarray(n))
        np.testing.assert_array_equal(_np(nout), np.asarray(jn))
        for s in range(S):
            got[s].append(_np(out[s])[: int(nout[s])])
            want[s].append(np.asarray(jout[s])[: int(jn[s])])
    out, nout = t._finalize_impl(state)
    jout, jn = jax.jit(jax.vmap(j._finalize_impl))(jstate)
    np.testing.assert_array_equal(_np(nout), np.asarray(jn))
    for s in range(S):
        got[s].append(_np(out[s])[: int(nout[s])])
        want[s].append(np.asarray(jout[s])[: int(jn[s])])
        np.testing.assert_allclose(np.concatenate(got[s]), np.concatenate(want[s]),
                                   rtol=0, atol=TOL)


# --- the factory ----------------------------------------------------------------


FACTORY = [
    ("Deltas", (2,), dict(target_axis=-1), 21),
    ("Splice", (1, 2), {}, 28),
    ("Stack", (3,), dict(pad_mode="edge"), 21),
    ("PCEN", (), {}, 7),
    ("SlidingCMVN", (), dict(window=40, min_window=10), 7),
    ("DCT", (), dict(num_ceps=5, lifter=22.0), 5),
    ("VADTrim", (), dict(energy_mean_scale=0.0, frames_context=2), 7),
]


@pytest.mark.parametrize("name,args,kw,width", FACTORY, ids=[f[0] for f in FACTORY])
def test_factory_maps_host_instances(feats, name, args, kw, width):
    jop = JSP.streaming_post_op(getattr(jpost, name)(*args, **kw))
    top = TSP.streaming_post_op(getattr(tpost, name)(*args, **kw), device="cpu")
    assert type(top).__name__ == type(jop).__name__
    assert top.out_width(7) == jop.out_width(7) == width
    x = np.abs(feats) + 0.1 if name == "PCEN" else feats
    want = _stream(jop, x, REF_CHUNKS, jax_op=True)
    got = _stream(top, x, CHUNKINGS["split"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_factory_with_tables(feats):
    """Standardize with statistics, an affine Transform and PLP: frame
    local, their host tables copied to the device once."""
    rng = np.random.RandomState(9)
    jstd, tstd = jpost.Standardize(), tpost.Standardize()
    jstd.accumulate(feats, axis=-1)
    tstd.accumulate(feats, axis=-1)
    mat = rng.randn(4, feats.shape[1] + 1)
    bank = {"name": "fbank", "num_filts": 12, "sampling_rate": 8000}
    power = np.abs(np.random.default_rng(4).standard_normal((137, 12))) + 0.1
    for jp, tp, x in ((jstd, tstd, feats),
                      (jpost.Transform(matrix=mat), tpost.Transform(matrix=mat), feats),
                      (jpost.PLP(bank=dict(bank)), tpost.PLP(bank=dict(bank)), power)):
        jop = JSP.streaming_post_op(jp)
        top = TSP.streaming_post_op(tp, device="cpu")
        assert top.out_width(x.shape[1]) == jop.out_width(x.shape[1])
        want = _stream(jop, x, [40, 40, 57], jax_op=True)
        got = _stream(top, x, CHUNKINGS["ragged"])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_factory_rejects_unstreamable():
    cases = [
        (tpost.Standardize(), "statistics"),
        (tpost.Deltas(1, concatenate=False), "concatenating"),
        (tpost.Deltas(1, target_axis=0), "target_axis"),
        (tpost.Stack(2, pad_mode="constant"), "pad_mode"),
        (tpost.VADTrim(energy_mean_scale=0.5), "energy_mean_scale"),
        (object(), "no streaming twin"),
    ]
    for post, match in cases:
        with pytest.raises(ValueError, match=match):
            TSP.streaming_post_op(post, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TSP.StreamingDeltas(1)


# --- pipelines ------------------------------------------------------------------


def _pipelines(jcomp, tcomp, posts, chunk):
    jp = JSP.StreamingPipeline(jcomp, [p[0] for p in posts], chunk_size=chunk)
    tp = TSP.StreamingPipeline(tcomp, [p[1] for p in posts], chunk_size=chunk)
    return jp, tp


def _both(name, *args, **kw):
    return getattr(jpost, name)(*args, **kw), getattr(tpost, name)(*args, **kw)


def test_pipeline_stft():
    bank = {"name": "fbank", "num_filts": 10, "sampling_rate": 8000}
    sig = np.random.default_rng(7).standard_normal(8000 + 123)
    kw = dict(dtype="float64", include_energy=True)
    posts = [_both("Deltas", 2, target_axis=-1),
             _both("SlidingCMVN", window=60, center=True, norm_var=True, min_window=20),
             _both("Stack", 3, pad_mode="edge")]
    jp, tp = _pipelines(JaxSTFT(dict(bank), **kw), STFTFrameComputer(dict(bank), device="cpu", **kw),
                        posts, 800)
    assert tp.num_coeffs == jp.num_coeffs
    want = jp.transform(sig)
    got = tp.transform(sig)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the VAD trim as the last stage, select mode
    sig[2000:5000] *= 0.01
    posts = [_both("VADTrim", energy_mean_scale=0.0, energy_threshold=-2.0, frames_context=2)]
    jp, tp = _pipelines(JaxSTFT(dict(bank), **kw), STFTFrameComputer(dict(bank), device="cpu", **kw),
                        posts, 800)
    want = jp.transform(sig)
    got = tp.transform(sig)
    assert 0 < got.shape[0] < 100 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pipeline_si():
    bank = {"name": "gammatone", "scaling_function": "mel", "num_filts": 6, "sampling_rate": 8000}
    sig = np.random.default_rng(8).standard_normal(4000 + 77)
    posts = [_both("Deltas", 1, target_axis=-1)]
    jp, tp = _pipelines(JaxSI(dict(bank), dtype="float64"),
                        SIFrameComputer(dict(bank), dtype="float64", device="cpu"), posts, 800)
    want = jp.transform(sig)
    got = tp.transform(sig)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pipeline_stream_axis_and_rules():
    """Two sessions through one pipeline on the stream axis against each
    one's transform; an opaque streamer needs in_width."""
    bank = {"name": "fbank", "num_filts": 6, "sampling_rate": 8000}
    comp = STFTFrameComputer(dict(bank), dtype="float64", device="cpu")
    pipe = TSP.StreamingPipeline(comp, [tpost.Deltas(1), TSP.StreamingStack(2, pad=True, device="cpu")],
                                 chunk_size=400)
    rng = np.random.default_rng(3)
    sigs = rng.standard_normal((2, 1700))
    lens = [1700, 1111]
    state = pipe.init_state(streams=2)
    outs = [[], []]
    for start in range(0, 2000, 400):
        v = torch.tensor([max(0, min(400, n - start)) for n in lens])
        buf = np.zeros((2, 400))
        piece = sigs[:, start : start + 400]
        buf[:, : piece.shape[1]] = piece
        state, out, n = pipe.process(state, torch.tensor(buf), v)
        for s in range(2):
            outs[s].append(_np(out[s])[: int(n[s])])
    out, n = pipe.finalize(state)
    for s in range(2):
        outs[s].append(_np(out[s])[: int(n[s])])
        np.testing.assert_allclose(np.concatenate(outs[s]), pipe.transform(sigs[s, : lens[s]]),
                                   rtol=0, atol=TOL_STREAMS)

    class Opaque:
        chunk_size = 100
        _dtype = np.float64
        device = torch.device("cpu")

        def init_state(self, streams=None):
            return ()

        def _process_impl(self, state, chunk, valid):
            return state, torch.zeros((0, 3)), 0

    with pytest.raises(ValueError, match="in_width"):
        TSP.StreamingPipeline(Opaque(), [])
    assert TSP.StreamingPipeline(Opaque(), [], in_width=3).num_coeffs == 3
