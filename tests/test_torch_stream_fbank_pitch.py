"""speech_tpu_torch.streaming.StreamingAppendPitch (Kaldi online2's 43-dim
fbank+pitch stream) at the widths of the benchmark's
``fbank40-pitch-kaldi-online`` configuration, on the CPU: against the plain
online reference ``bench_port/reference/pitch_online.py`` on seeded voiced
audio, its filter-bank columns against StreamingSTFT's bit for bit, valid-0
steps, the repeated tail, StreamServer against a direct replay, and its
counters.  Sessions are 2-3 s."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from bench_port.kinds.corpus_pitch import synth
from bench_port.reference.fbank import FbankSpec
from bench_port.reference.pitch import PitchSpec
from bench_port.reference.pitch_online import OnlinePitchSpec
from speech_tpu_torch.alias import alias_factory_subclass_from_arg
from speech_tpu_torch.compute import FrameComputer
from speech_tpu_torch.ops.pitch import PitchTrack, pitch_feats_from_track
from speech_tpu_torch.serve import StreamPool, StreamServer
from speech_tpu_torch.streaming import StreamingAppendPitch, StreamingSTFT, _tree_leaves
from speech_tpu_torch.streaming_post import StreamingProcessPitch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE, CHUNK = 16000, 1600


def _load(path):
    with open(os.path.join(REPO_ROOT, "bench_port", path)) as f:
        return json.load(f)


CONFIG = _load("configs/fbank40-pitch-kaldi-online.json")
MIX = _load("mixes/stream-pitch-replay.json")
PITCH = CONFIG["pitch"]
NF = CONFIG["computer"]["bank"]["num_filts"]
# float64 against the float64 reference: the same operations, summed in
# other orders (the NCCF's batched products, the window sums' masked
# product against the reference's slices)
TOL_64 = 1e-9
# the server's ticks step a session beside others, in sub-batches whose
# float32 products round in other orders than a session stepped alone
TOL_BATCH = 1e-5


def _computer(dtype="float32"):
    return alias_factory_subclass_from_arg(
        FrameComputer, {**CONFIG["computer"], "device": "cpu", "dtype": dtype})


@pytest.fixture(scope="module")
def streamers():
    return {d: StreamingAppendPitch(_computer(d), PITCH, CHUNK) for d in ("float32", "float64")}


@pytest.fixture(scope="module")
def signals():
    """Three voiced sessions of the cell's audio, 2.0-3.0 s, int16 PCM."""
    return synth([32000, 41234, 48000], 20261019, "test", MIX["audio"], RATE, "cpu")


def _replay(stream, signal, pieces):
    """The rows a session fed as ``pieces`` gives, one call a piece, then
    its finalize; and the rows out before the finalize."""
    state = stream.init_state()
    x = np.asarray(signal, np.float64)
    outs, at = [], 0
    for p in pieces:
        buf = np.zeros(CHUNK)
        buf[:p] = x[at: at + p]
        at += p
        state, out, n = stream._process_impl(state, torch.tensor(buf), p)
        outs.append(out[: int(n)].double().numpy())
    before = sum(o.shape[0] for o in outs)
    out, n = stream._finalize_impl(state)
    outs.append(out[: int(n)].double().numpy())
    return np.concatenate(outs), before


def test_float64_stream_is_the_online_reference(streamers, signals):
    """Every row of each session, fed in the cell's 100 ms chunks, within
    TOL_64 of the reference's columns and of the reference filter bank;
    the rows out before the finalize are the reference's count."""
    ref, fb = OnlinePitchSpec(PITCH, RATE, CHUNK), FbankSpec(CONFIG["computer"])
    for sig in signals:
        got, before = _replay(streamers["float64"], sig, ref.pieces(len(sig)))
        want_fb = fb.features(sig)
        assert got.shape == (want_fb.shape[0], NF + 3)
        assert before == ref.rows_before_finalize(len(sig), want_fb.shape[0]) > 0
        np.testing.assert_allclose(got[:, NF:], ref.features(sig, got.shape[0]), rtol=0, atol=TOL_64)
        np.testing.assert_allclose(got[:, :NF], want_fb, rtol=0, atol=TOL_64)


def test_any_chunking_is_the_reference_fed_the_same_pieces(streamers, signals):
    """Pieces of 1-1,600 samples: the tracker stages them into whole
    chunks, and each call's rows are computed from the track rows that
    call emitted, as the reference replays them."""
    ref = OnlinePitchSpec(PITCH, RATE, CHUNK)
    rng = np.random.RandomState(7)
    sig = signals[0]
    pieces = []
    while sum(pieces) < len(sig):
        pieces.append(int(min(rng.choice([1, 333, 1600, 1599, 800]), len(sig) - sum(pieces))))
    got, _ = _replay(streamers["float64"], sig, pieces)
    want = ref.columns(ref.track_calls(sig, pieces))
    T = want.shape[0]
    np.testing.assert_allclose(got[:T, NF:], want, rtol=0, atol=TOL_64)
    np.testing.assert_array_equal(got[T:, NF:], np.broadcast_to(got[T - 1, NF:], (got.shape[0] - T, 3)))


def test_float32_stream_holds_the_cells_limits(streamers, signals):
    """The float32 stream (the cell's program) read by the cell's pitch
    numbers against the reference, within the cell's limits."""
    from bench_port.kinds.corpus_pitch import numbers

    limits = _load("cells/fbank40-pitch-kaldi-online.stream-replay.json")["limits"]
    ref = OnlinePitchSpec(PITCH, RATE, CHUNK)
    items = [(sig, _replay(streamers["float32"], sig, ref.pieces(len(sig)))[0][:, NF:])
             for sig in signals]
    got = numbers(ref, items, "cpu")
    for name, value in got.items():
        if name in limits:
            assert value <= limits[name], (name, value)


def test_filter_bank_columns_are_streaming_stft_bit_for_bit(streamers, signals):
    """Three sessions on the stream axis, ragged valid counts a tick: the
    first 40 columns of every row are StreamingSTFT's own rows for the same
    chunks."""
    stream = streamers["float32"]
    fbank = StreamingSTFT(stream.computer, CHUNK)
    rng = np.random.RandomState(3)
    S, ticks = len(signals), 40
    valids = rng.choice([0, 700, 1600], size=(ticks, S), p=[0.2, 0.2, 0.6])
    a, b = stream.init_state(streams=S), fbank.init_state(streams=S)
    rows_a, rows_b = [[] for _ in range(S)], [[] for _ in range(S)]
    at = np.zeros(S, int)
    for v in valids:
        chunk = np.zeros((S, CHUNK), np.float32)
        for s in range(S):
            piece = signals[s][at[s]: at[s] + v[s]]
            chunk[s, : piece.size] = piece
            v[s] = piece.size
            at[s] += piece.size
        chunk, vt = torch.tensor(chunk), torch.tensor(v)
        a, out_a, na = stream._process_impl(a, chunk, vt)
        b, out_b, nb = fbank._process_impl(b, chunk, vt)
        for s in range(S):
            rows_a[s].append(out_a[s, : int(na[s]), :NF])
            rows_b[s].append(out_b[s, : int(nb[s])])
    for (out_a, na), (out_b, nb) in [(stream._finalize_impl(a), fbank._finalize_impl(b))]:
        for s in range(S):
            rows_a[s].append(out_a[s, : int(na[s]), :NF])
            rows_b[s].append(out_b[s, : int(nb[s])])
    for s in range(S):
        got, want = torch.cat(rows_a[s]), torch.cat(rows_b[s])
        assert got.shape == want.shape and got.shape[0] > 0
        assert torch.equal(got, want)


def test_a_valid_zero_step_leaves_the_state_bitwise(streamers, signals):
    """Mid-session, at the start and once the pitch rows flow: a step with
    valid 0 returns no rows and the state bit for bit."""
    stream = streamers["float32"]
    state = stream.init_state(streams=2)
    x = torch.tensor(np.stack([signals[0][:32000], signals[2][:32000]]).astype(np.float32))
    for c in range(12):
        if c in (0, 3, 11):
            new, _, n = stream._process_impl(state, torch.zeros(2, CHUNK), 0)
            assert int(n.sum()) == 0
            for old_leaf, new_leaf in zip(_tree_leaves(state), _tree_leaves(new)):
                assert torch.equal(old_leaf, new_leaf)
        state, _, _ = stream._process_impl(state, x[:, c * CHUNK:(c + 1) * CHUNK], CHUNK)


def test_the_tail_repeats_the_tracks_last_row(streamers, signals):
    """Rows number the filter bank's frames; those past the track's frames
    repeat the last track row's columns (as the batch path's paste), and a
    session too short for a pitch frame gets zero columns."""
    stream = streamers["float32"]
    pspec, fb = PitchSpec(PITCH, RATE), FbankSpec(CONFIG["computer"])
    for sig in (signals[1], signals[0][:5000]):
        got = stream.transform(sig)
        frames, tracked = fb.frame_count(len(sig)), pspec.frame_count(len(sig))
        assert got.shape == (frames, NF + 3)
        assert 2 <= frames - tracked <= 4 or tracked == 0
        if tracked:
            np.testing.assert_array_equal(got[tracked:, NF:],
                                          np.broadcast_to(got[tracked - 1, NF:], (frames - tracked, 3)))
        else:
            assert not got[:, NF:].any()


def test_process_pitch_on_a_whole_track_is_the_batch_columns():
    """A track that arrives in one step: every window is clipped at the
    track's end as the batch form's, so the online columns are
    pitch_feats_from_track's."""
    rng = np.random.RandomState(11)
    T = 300
    f0 = torch.tensor(120 + 40 * np.sin(np.arange(T) / 17) + rng.rand(T), dtype=torch.float64)
    nccf = torch.tensor(rng.uniform(-0.2, 0.99, T), dtype=torch.float64)
    op = StreamingProcessPitch(151, 2, device="cpu")
    state = op.init_state(2, torch.float64)
    state, out, n = op._step_impl(state, torch.stack([f0, nccf], -1), T)
    tail, m = op._finalize_impl(state)
    got = torch.cat([out[: int(n)], tail[: int(m)]])
    want = pitch_feats_from_track(PitchTrack(f0, nccf, torch.ones(T, dtype=torch.bool)))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_stream_server_rows_are_a_direct_replay(streamers, signals, monkeypatch):
    """StreamServer(tick_chunks=1), each session fed whole and closed at
    once (the cell's lanes): the closing sessions' backlogs drain through
    the ticks one 100 ms chunk at a time, so every session's rows equal the
    streamer's own replay of its chunks, to float32 rounding (TOL_BATCH);
    sessions whose backlogs end in the same tick are finalized in one
    call."""
    stream = streamers["float32"]
    ref = OnlinePitchSpec(PITCH, RATE, CHUNK)
    calls = []
    close_many = StreamPool.close_many

    def spy(pool, handles):
        calls.append(len(handles))
        return close_many(pool, handles)

    monkeypatch.setattr(StreamPool, "close_many", spy)
    sigs = signals + [signals[0]]  # two sessions of one length end together
    got = {}
    with StreamServer(stream, slots=4, chunk_size=CHUNK, tick_chunks=1) as server:
        server.warmup(occupancies=[1, 2, 4])
        handles = [server.open_session() for _ in sigs]
        # a slow warm-up holds the loop while every feed and close queues,
        # so that the loop takes them together and the backlogs start in
        # one tick
        warmup = StreamPool.warmup
        monkeypatch.setattr(StreamPool, "warmup",
                            lambda pool, *a: (time.sleep(0.5), warmup(pool, *a))[1])
        held = threading.Thread(target=server.warmup, args=((1,),))
        held.start()
        time.sleep(0.1)
        for h, sig in zip(handles, sigs):
            server.feed(h, sig)

        def close(i, h):
            server.close_session(h)
            got[i] = np.concatenate(list(server.iter_results(h)))

        threads = [threading.Thread(target=close, args=(i, h)) for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in [held, *threads]:
            t.join(timeout=120)
    for i, sig in enumerate(sigs):
        want, _ = _replay(stream, sig, ref.pieces(len(sig)))
        assert got[i].shape == want.shape
        np.testing.assert_allclose(got[i], want, rtol=0, atol=TOL_BATCH)
    assert sum(calls) == len(sigs) and 2 in calls


def test_a_reused_slot_beside_a_session_midway_is_a_direct_replay(streamers, signals):
    """StreamPool, one chunk a tick: a session opened in the slot a closed
    session left, while another session is midway through its own, gives
    the rows of its own replay (the open resets the slot's whole nested
    state: the held rows, the process step's carry, the tracker's ring),
    and the session beside it is not disturbed."""
    stream = streamers["float32"]
    ref = OnlinePitchSpec(PITCH, RATE, CHUNK)
    pool = StreamPool(stream, slots=2, chunk_size=CHUNK)
    pool.warmup()
    rows = {}

    def take(out):
        for h, f in out:
            rows.setdefault(h, []).append(f)

    def close(h):
        while len(pool._sessions[h].pending):
            take(pool.step(max_chunks=1))
        take(pool.close_many([h]))

    a, b = pool.open(), pool.open()
    pool.feed(a, signals[2])
    pool.feed(b, signals[0])
    slot = pool._sessions[b].slot
    close(b)  # a is two thirds through
    c = pool.open()
    assert pool._sessions[c].slot == slot
    pool.feed(c, signals[1])
    close(a)  # c is midway
    close(c)
    for h, sig in ((a, signals[2]), (b, signals[0]), (c, signals[1])):
        want, _ = _replay(stream, sig, ref.pieces(len(sig)))
        got = np.concatenate(rows[h])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BATCH)


def test_counters_add_up(signals):
    """After every session closed: the frames tracked are the sessions'
    pitch frames, all emitted; the stepped frames are the rows times the
    Viterbi steps of every call (the finalize's two chunks too), and the
    backtrack steps its emissions' ring walks."""
    stream = StreamingAppendPitch(_computer(), PITCH, CHUNK)
    pspec = PitchSpec(PITCH, RATE)
    sig = signals[0]
    n_chunks = -(-len(sig) // CHUNK)
    state = stream.init_state(streams=2)
    x = np.zeros((2, n_chunks * CHUNK), np.float32)
    x[0, : len(sig)] = sig
    x[1, : 20000] = sig[:20000]
    for c in range(n_chunks):
        v = torch.tensor([min(len(sig) - c * CHUNK, CHUNK), max(0, min(20000 - c * CHUNK, CHUNK))])
        state, _, _ = stream._process_impl(state, torch.tensor(x[:, c * CHUNK:(c + 1) * CHUNK]), v)
    stream._finalize_impl(state)
    tr = stream.tracker
    stats = stream.stats
    assert stats["pitch_frames_tracked"] == pspec.frame_count(len(sig)) + pspec.frame_count(20000)
    assert stats["pitch_frames_emitted"] == stats["pitch_frames_tracked"]
    assert stats["pitch_frames_stepped"] == 2 * (n_chunks + 1 + tr.k_flush) * tr.max_frames_chunk
    assert stats["pitch_backtrack_steps"] == 2 * (n_chunks + 1) * tr.ring_len
    useful = stats["pitch_frames_tracked"] / stats["pitch_frames_stepped"]
    assert 0.5 < useful < 1.0


def test_the_held_rows_stay_within_their_buffer(streamers, signals):
    """Pieces of every size up to a wide 4-chunk call: the filter-bank rows
    waiting for their pitch columns never pass ``hold_len``."""
    stream = streamers["float32"]
    rng = np.random.RandomState(5)
    sig = signals[2]
    state, at, most = stream.init_state(), 0, 0
    while at < len(sig):
        width = CHUNK * int(rng.choice([1, 1, 4]))
        p = int(min(rng.randint(1, width + 1), len(sig) - at))
        buf = np.zeros(width, np.float32)
        buf[:p] = sig[at: at + p]
        at += p
        state, _, _ = stream._process_impl(state, torch.tensor(buf), p)
        most = max(most, int(state.n_held))
    assert 0 < most <= stream.hold_len
