"""speech_tpu_torch.serve: the cases of ``tests/test_serve.py`` on the port.

``FeatureServer`` (concurrent submissions, bursts, request isolation,
admission control, stats, batch tiers, int16 ingress, the straggler behind
a close), ``StreamPool`` (interleaved sessions, slot reuse, wide drains,
``close_many``, occupancy tiers with an idle session's state bitwise
untouched, randomized lifecycles, SI) and ``StreamServer`` (threaded
sessions, lifecycle errors, a step error failing sessions terminally) are
held against ``compute_full`` of the port's float64 computer within 1e-8,
as the JAX package's tests hold its own; the port's ``compute_full`` is in
turn held against the JAX package's on the same signals.  The pool with
its slots over a mesh runs at world size 1 in this process and at world
size 2 as one launch of ``tests/torch_dist_worker.py`` (gloo).
"""

import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import torch
import torch.distributed as dist

import speech_tpu

import speech_tpu_torch
from speech_tpu_torch import parallel as tpar
from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.parallel import multihost
from speech_tpu_torch.serve import FeatureServer, StreamPool, StreamServer
from speech_tpu_torch.streaming import _tree_leaves

import torch_dist_worker as W

BANK = {"name": "fbank", "num_filts": 10, "sampling_rate": 16000}
TOL = 1e-8


def _computer(**kw):
    kwargs = dict(frame_length_ms=25, frame_shift_ms=10, dtype="float64", device="cpu")
    kwargs.update(kw)
    return STFTFrameComputer(dict(BANK), **kwargs)


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.allclose(got, want, atol=TOL), np.abs(got - want).max()


def test_port_compute_full_is_the_reference():
    """The oracle of this file agrees with the JAX package's computer."""
    sig = np.random.RandomState(1).randn(7001)
    jc = speech_tpu.compute.STFTFrameComputer(
        dict(BANK), frame_length_ms=25, frame_shift_ms=10, dtype="float64")
    np.testing.assert_allclose(_computer().compute_full(sig), np.asarray(jc.compute_full(sig)),
                               rtol=0, atol=1e-10)


# --- FeatureServer -------------------------------------------------------------


def test_feature_server_concurrent_submissions_match_compute_full():
    computer = _computer()
    rng = np.random.RandomState(11)
    signals = [rng.randn(int(rng.randint(3000, 9000))) for _ in range(24)]
    results = [None] * len(signals)
    with FeatureServer(computer, max_batch=8, max_wait_ms=20.0) as server:

        def client(i):
            results[i] = server.extract(signals[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(signals))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for got, sig in zip(results, signals):
        _close(got, computer.compute_full(sig))


def test_feature_server_burst_larger_than_batch():
    computer = _computer()
    rng = np.random.RandomState(3)
    signals = [rng.randn(4000) * (i + 1) for i in range(10)]
    with FeatureServer(computer, max_batch=4, max_wait_ms=1.0) as server:
        outs = server.extract_many(signals)
    for s, got in zip(signals, outs):
        _close(got, computer.compute_full(s))


def test_feature_server_bad_request_does_not_kill_server():
    computer = _computer()
    rng = np.random.RandomState(5)
    with FeatureServer(computer, max_wait_ms=1.0) as server:
        with pytest.raises(ValueError):
            server.submit(rng.randn(10, 10))
        with pytest.raises(TypeError):
            server.submit(np.array(["a", "b"]))
        sig = rng.randn(5000)
        _close(server.extract(sig), computer.compute_full(sig))
    with pytest.raises(RuntimeError):
        server.submit(sig)


def test_feature_server_isolates_a_failing_request(monkeypatch):
    """A micro-batch whose dispatch fails is retried request by request on
    the same extractor: only the failing request's future gets the error
    (it is never computed elsewhere), and the server lives on."""
    computer = _computer()
    rng = np.random.RandomState(6)
    signals = [rng.randn(3000 + 100 * i) for i in range(4)]
    with FeatureServer(computer, max_batch=4, max_wait_ms=50.0) as server:
        ex = server._extractor
        dispatch = ex._dispatch
        boom = RuntimeError("launch failed")

        def failing(sigs, min_batch=0):
            if any(len(s) == 3200 for s in sigs):
                raise boom
            return dispatch(sigs, min_batch)

        monkeypatch.setattr(ex, "_dispatch", failing)
        futs = [server.submit(s) for s in signals]
        for i, (f, s) in enumerate(zip(futs, signals)):
            if len(s) == 3200:
                with pytest.raises(RuntimeError, match="launch failed"):
                    f.result(timeout=60)
            else:
                _close(f.result(timeout=60), computer.compute_full(s))
        assert server.stats["failed"] == 1 and server.stats["completed"] == 3
        monkeypatch.setattr(ex, "_dispatch", dispatch)
        _close(server.extract(signals[1]), computer.compute_full(signals[1]))


def test_feature_server_sustained_load_overlap():
    computer = _computer()
    rng = np.random.RandomState(58)
    signals = [rng.randn(int(rng.randint(2000, 5000))) for _ in range(24)]
    with FeatureServer(computer, max_batch=4, max_wait_ms=5.0) as server:
        futs = [server.submit(s) for s in signals]
        outs = [f.result(timeout=120) for f in futs]
    for s, got in zip(signals, outs):
        _close(got, computer.compute_full(s))


def test_feature_server_warmup_then_serves():
    computer = _computer()
    rng = np.random.RandomState(61)
    with FeatureServer(computer, max_batch=8, max_wait_ms=5.0) as server:
        server.warmup([3000, 3500, 6000])
        assert server.stats["batches"] == 0  # warm-up bypasses the dispatcher
        outs = server.extract_many([rng.randn(3200)])
        outs += server.extract_many([rng.randn(2100) for _ in range(5)])
        outs += server.extract_many([rng.randn(5000) for _ in range(3)])
    assert all(o.shape[1] == computer.num_coeffs for o in outs)


def test_feature_server_admission_control_and_stats():
    computer = _computer()
    rng = np.random.RandomState(63)
    with FeatureServer(computer, max_wait_ms=1.0, max_pending=0) as server:
        with pytest.raises(RuntimeError, match="overloaded"):
            server.submit(rng.randn(3000))
        assert server.stats["rejected"] == 1
    sigs = [rng.randn(int(rng.randint(2000, 4000))) for _ in range(6)]
    with FeatureServer(computer, max_batch=4, max_wait_ms=5.0) as server:
        outs = server.extract_many(sigs)
    assert len(outs) == 6
    assert server.stats["submitted"] == 6 and server.stats["completed"] == 6
    assert server.stats["failed"] == 0
    assert 1 <= server.stats["batches"] <= 6
    assert server._pending == 0


@pytest.mark.parametrize("pad", [True, "pow2", False])
def test_feature_server_batch_tiers(pad, monkeypatch):
    """``pad_batches``: every micro-batch padded to ``max_batch`` rows, to
    the next power of two, or not at all; results unchanged."""
    computer = _computer()
    rng = np.random.RandomState(67)
    seen = []
    with FeatureServer(computer, max_batch=8, max_wait_ms=5.0, pad_batches=pad) as server:
        server.warmup([3000])
        ex = server._extractor
        dispatch = ex._dispatch

        def spy(sigs, min_batch=0):
            seen.append((len(sigs), min_batch))
            return dispatch(sigs, min_batch)

        monkeypatch.setattr(ex, "_dispatch", spy)
        sigs = [rng.randn(3200)] + [rng.randn(2100) for _ in range(3)]
        outs = server.extract_many(sigs[:1]) + server.extract_many(sigs[1:])
    for s, got in zip(sigs, outs):
        _close(got, computer.compute_full(s))
    want = {True: lambda n: 8, "pow2": lambda n: 1 << max(0, n - 1).bit_length(),
            False: lambda n: 0}[pad]
    assert all(m == want(n) for n, m in seen), seen
    with pytest.raises(ValueError):
        FeatureServer(computer, pad_batches="nope")


def test_feature_server_int16_submissions_match_float():
    computer = _computer()
    rng = np.random.RandomState(13)
    sigs_i = [(rng.randn(int(rng.randint(3000, 9000))) * 1000).astype(np.int16)
              for _ in range(6)]
    with FeatureServer(computer, max_batch=4, max_wait_ms=5.0) as server:
        server.warmup([4096, 8192], dtype=np.int16)
        got_i = server.extract_many(sigs_i)
        got_f = server.extract_many([s.astype(np.float64) for s in sigs_i])
    for a, b in zip(got_i, got_f):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_feature_server_close_resolves_stragglers():
    computer = _computer()
    server = FeatureServer(computer, max_wait_ms=1.0)
    server._closed = True
    server._queue.put(None)
    straggler = Future()
    server._queue.put((np.zeros(4000), straggler))
    server._closed = False
    server.close()
    with pytest.raises(RuntimeError):
        straggler.result(timeout=30)


def test_feature_server_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    computer = STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureServer(computer)


# --- StreamPool ----------------------------------------------------------------


def test_stream_pool_interleaved_sessions_match_compute_full():
    computer = _computer()
    rng = np.random.RandomState(29)
    pool = StreamPool(computer, slots=3, chunk_size=800)
    signals = {h: rng.randn(int(rng.randint(2500, 7001))) for h in [pool.open() for _ in range(3)]}
    assert pool.capacity == 0
    got = {h: [] for h in signals}
    cursors = {h: 0 for h in signals}
    while any(cursors[h] < len(s) for h, s in signals.items()):
        for h, s in signals.items():
            if cursors[h] >= len(s):
                continue
            n = int(rng.randint(1, 1200))
            pool.feed(h, s[cursors[h]: cursors[h] + n])
            cursors[h] += n
        for h2, feats in pool.step():
            got[h2].append(feats)
    for h in list(signals):
        for h2, feats in pool.close(h):
            assert h2 == h
            got[h].append(feats)
    assert pool.capacity == 3
    for h, s in signals.items():
        _close(np.concatenate(got[h]), computer.compute_full(s))


def test_stream_pool_slot_reuse_and_isolation():
    computer = _computer()
    rng = np.random.RandomState(41)
    pool = StreamPool(computer, slots=2, chunk_size=800)
    a, b = pool.open(), pool.open()
    with pytest.raises(RuntimeError):
        pool.open()
    sig_a, sig_b = rng.randn(4000), rng.randn(5200)
    pool.feed(a, sig_a)
    pool.feed(b, sig_b[:2000])
    _close(np.concatenate([f for _, f in pool.close(a)]), computer.compute_full(sig_a))
    pool.feed(b, sig_b[2000:])
    out_b = [f for _, f in pool.step()] + [f for _, f in pool.close(b)]
    _close(np.concatenate(out_b), computer.compute_full(sig_b))
    c = pool.open()
    sig_c = rng.randn(3000)
    pool.feed(c, sig_c)
    _close(np.concatenate([f for _, f in pool.close(c)]), computer.compute_full(sig_c))
    with pytest.raises(KeyError):
        pool.feed(a, sig_a)


def test_stream_pool_multi_chunk_drain_matches_compute_full():
    computer = _computer()
    rng = np.random.RandomState(57)
    pool = StreamPool(computer, slots=2, chunk_size=800)
    a, b = pool.open(), pool.open()
    sig_a, sig_b = rng.randn(800 * 9 + 123), rng.randn(800 * 3)
    pool.feed(a, sig_a)
    pool.feed(b, sig_b)
    got = {a: [], b: []}
    for h, f in pool.step(max_chunks=16):
        got[h].append(f)
    assert not any(len(s.pending) for s in pool._sessions.values())
    for h in (a, b):
        for h2, f in pool.close(h):
            got[h2].append(f)
    for h, sig in ((a, sig_a), (b, sig_b)):
        _close(np.concatenate(got[h]), computer.compute_full(sig))


def test_stream_pool_close_many_matches_individual_closes():
    computer = _computer()
    rng = np.random.RandomState(59)
    sigs = [rng.randn(int(rng.randint(2000, 6000))) for _ in range(3)]

    def run(close_batched):
        pool = StreamPool(computer, slots=4, chunk_size=800)
        handles = [pool.open() for _ in sigs]
        keep = pool.open()  # stays open; must be untouched
        pool.feed(keep, rng.randn(1000))
        for h, s in zip(handles, sigs):
            pool.feed(h, s)
        got = {h: [] for h in handles}
        if close_batched:
            for h, f in pool.close_many(handles):
                got[h].append(f)
        else:
            for h in handles:
                for h2, f in pool.close(h):
                    got[h2].append(f)
        assert len(pool._sessions[keep].pending) == 1000
        return {h: np.concatenate(fs) for h, fs in got.items()}

    a, b = run(True), run(False)
    assert sorted(a) == sorted(b)
    for h, sig in zip(sorted(a), sigs):
        _close(a[h], computer.compute_full(sig))
        assert np.allclose(a[h], b[h], atol=1e-10)


def test_stream_pool_warmup_is_noop_on_sessions():
    computer = _computer()
    pool = StreamPool(computer, slots=4, chunk_size=800)
    pool.warmup(depths=(1, 8), occupancies=(1, 2))
    sig = np.random.RandomState(62).randn(2400)
    h = pool.open()
    pool.feed(h, sig)
    out = [f for _, f in pool.step(max_chunks=8)] + [f for _, f in pool.close(h)]
    _close(np.concatenate(out), computer.compute_full(sig))


def test_stream_pool_occupancy_tiered_ticks():
    """Partial-occupancy ticks gather the active slots, step them and
    scatter them back: results match compute_full, and an idle open
    session's state stays bitwise what it was."""
    computer = _computer()
    rng = np.random.RandomState(57)
    pool = StreamPool(computer, slots=16, chunk_size=800)
    assert pool._tiered
    idle = pool.open()
    idle_sig = rng.randn(1500)
    idle_frames = 0
    pool.feed(idle, idle_sig)
    while len(pool._sessions[idle].pending):
        for _, feats in pool.step():
            idle_frames += feats.shape[0]

    def idle_state():
        slot = pool._sessions[idle].slot
        return [leaf[slot].clone() for leaf in _tree_leaves(pool._states)]

    before = idle_state()
    tiers = []
    tiered_step = pool._tiered_step

    def spy(idx, chunks, valids):
        tiers.append(idx.shape[0])
        return tiered_step(idx, chunks, valids)

    pool._tiered_step = spy
    signals, got = {}, {}
    for m in (1, 2, 3, 5):  # tiers 1, 2, 4, 8: all below 16 slots
        handles = [pool.open() for _ in range(m)]
        for h in handles:
            signals[h] = rng.randn(int(rng.randint(2000, 5000)))
            got[h] = []
        cursors = {h: 0 for h in handles}
        while any(cursors[h] < len(signals[h]) for h in handles):
            for h in handles:
                n = int(rng.randint(1, 1100))
                pool.feed(h, signals[h][cursors[h]: cursors[h] + n])
                cursors[h] += n
            for h2, feats in pool.step():
                assert h2 != idle
                got[h2].append(feats)
        for h2, feats in pool.close_many(handles):
            got[h2].append(feats)
    assert set(tiers) <= {1, 2, 4, 8} and {4, 8} <= set(tiers)
    for h, s in signals.items():
        _close(np.concatenate(got[h]), computer.compute_full(s))
    assert all(torch.equal(a, b) for a, b in zip(before, idle_state()))
    idle_frames += sum(f.shape[0] for _, f in pool.close(idle))
    assert idle_frames == computer.compute_full(idle_sig).shape[0]


def test_stream_pool_randomized_session_lifecycles():
    computer = _computer()
    rng = np.random.RandomState(65)
    pool = StreamPool(computer, slots=3, chunk_size=800)
    live = {}
    completed = 0
    for step_i in range(120):
        op = rng.rand()
        if op < 0.25 and pool.capacity:
            live[pool.open()] = {"sig": [], "out": []}
        elif op < 0.6 and live:
            h = list(live)[rng.randint(len(live))]
            seg = rng.randn(int(rng.randint(1, 2000)))
            live[h]["sig"].append(seg)
            pool.feed(h, seg)
        elif op < 0.85:
            for h, f in pool.step(max_chunks=int(rng.choice([1, 4, 16]))):
                live[h]["out"].append(f)
        elif live:
            h = list(live)[rng.randint(len(live))]
            for h2, f in pool.close(h):
                live[h2]["out"].append(f)
            sig = np.concatenate(live[h]["sig"]) if live[h]["sig"] else np.zeros(0)
            want = computer.compute_full(sig)
            out = (np.concatenate(live[h]["out"]) if live[h]["out"]
                   else np.zeros((0, computer.num_coeffs)))
            _close(out, want)
            del live[h]
            completed += 1
    assert completed >= 10, completed


def test_stream_pool_si_computer():
    from speech_tpu_torch.compute import ShortIntegrationFrameComputer

    computer = ShortIntegrationFrameComputer(
        {"name": "gammatone", "scaling_function": "mel", "num_filts": 6, "sampling_rate": 8000},
        frame_shift_ms=10, dtype="float64", device="cpu",
    )
    rng = np.random.RandomState(53)
    pool = StreamPool(computer, slots=2, chunk_size=640)
    a, b = pool.open(), pool.open()
    sigs = {a: rng.randn(3000), b: rng.randn(4100)}
    got = {a: [], b: []}
    for h, s in sigs.items():
        pool.feed(h, s)
    for _ in range(10):
        for h2, f in pool.step():
            got[h2].append(f)
    for h in (a, b):
        got[h].extend(f for _, f in pool.close(h))
        _close(np.concatenate(got[h]), computer.compute_full(sigs[h]))


def _in_process(tmp, fn):
    multihost.initialize(store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                         num_processes=1, process_id=0, backend="gloo")
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def test_pool_and_server_on_a_world_size_1_mesh(tmp_path):
    computer = _computer()
    rng = np.random.RandomState(64)
    sigs = [rng.randn(int(rng.randint(2000, 6000))) for _ in range(2)]

    def run():
        mesh = tpar.make_mesh(("data",), devices="cpu")
        pool = StreamPool(computer, slots=2, chunk_size=800, mesh=mesh)
        assert not pool._tiered
        handles = [pool.open() for _ in sigs]
        for h, s in zip(handles, sigs):
            pool.feed(h, s)
        got = {h: [] for h in handles}
        for h, f in pool.step(max_chunks=8):
            got[h].append(f)
        for h, f in pool.close_many(handles):
            got[h].append(f)
        with FeatureServer(computer, mesh=mesh, max_batch=4, max_wait_ms=10.0) as server:
            outs = server.extract_many(sigs)
        return [np.concatenate(got[h]) for h in handles], outs

    pooled, served = _in_process(str(tmp_path), run)
    for sig, a, b in zip(sigs, pooled, served):
        want = computer.compute_full(sig)
        _close(a, want)
        _close(b, want)


@pytest.fixture(scope="module")
def pool_world2(tmp_path_factory):
    return W.wait(*W.launch(2, str(tmp_path_factory.mktemp("serve_pool")), cases="serve_pool"))


def test_stream_pool_on_a_world_size_2_mesh(pool_world2):
    """Each of 2 processes ticks its block of the 4 slots; the gathered rows
    of every session equal compute_full, and a slot count that does not
    divide over the mesh is refused."""
    computer = W.stft_computer(speech_tpu_torch)
    for i, sig in enumerate(W.model_inputs()["sessions"]):
        _close(pool_world2[f"session{i}"], computer.compute_full(sig))
    assert int(pool_world2["refused"]) == 1


# --- StreamServer --------------------------------------------------------------


def test_stream_server_threaded_sessions_match_compute_full():
    computer = _computer()
    rng = np.random.RandomState(66)
    sigs = [rng.randn(int(rng.randint(3000, 9000))) for _ in range(4)]
    results = {}
    with StreamServer(computer, slots=4, chunk_size=800, max_wait_ms=2.0) as server:
        handles = [server.open_session() for _ in sigs]

        def feeder(h, sig):
            i = 0
            r = np.random.RandomState(h)
            while i < len(sig):
                n = int(r.randint(200, 1500))
                server.feed(h, sig[i: i + n])
                i += n
            server.close_session(h)

        threads = [threading.Thread(target=feeder, args=(h, s)) for h, s in zip(handles, sigs)]
        for t in threads:
            t.start()
        for h in handles:
            results[h] = list(server.iter_results(h))
        for t in threads:
            t.join()
    for h, sig in zip(handles, sigs):
        _close(np.concatenate(results[h]), computer.compute_full(sig))


def test_stream_server_lifecycle_errors():
    computer = _computer()
    with StreamServer(computer, slots=1, chunk_size=800) as server:
        h = server.open_session()
        with pytest.raises(RuntimeError):
            server.open_session()
        server.feed(h, np.random.RandomState(0).randn(1000))
        server.close_session(h)
        assert len(list(server.iter_results(h))) >= 1
        h2 = server.open_session()
        server.close_session(h2)
        with pytest.raises(ValueError):
            server.feed(h2, np.zeros((2, 2)))
        with pytest.raises(KeyError):
            next(iter(server.iter_results(h)))  # its stream ended
    with pytest.raises(RuntimeError):
        server.open_session()


def test_stream_server_step_error_fails_sessions_terminally():
    computer = _computer()
    with StreamServer(computer, slots=2, chunk_size=800, max_wait_ms=1.0) as server:
        h = server.open_session()
        boom = RuntimeError("device exploded")
        orig_step = server._pool.step
        server._pool.step = lambda **kw: (_ for _ in ()).throw(boom)
        server.feed(h, np.random.RandomState(0).randn(4000))
        with pytest.raises(RuntimeError, match="device exploded"):
            for _ in server.iter_results(h):
                pass
        with pytest.raises(KeyError):
            next(iter(server.iter_results(h)))
        time.sleep(0.05)
        server._pool.step = orig_step
        assert len(server._pool._sessions[h].pending) == 0
        server.close_session(h)
        sig = np.random.RandomState(1).randn(3000)
        h2 = server.open_session()
        server.feed(h2, sig)
        server.close_session(h2)
        _close(np.concatenate(list(server.iter_results(h2))), computer.compute_full(sig))


def test_stream_server_feed_validates_at_caller():
    computer = _computer()
    with StreamServer(computer, slots=1, chunk_size=800) as server:
        h = server.open_session()
        with pytest.raises(TypeError):
            server.feed(h, np.array(["a", "b"]))
        with pytest.raises(TypeError):
            server.feed(h, np.zeros(4, np.complex64))
        sig = np.random.RandomState(2).randn(2000)
        server.feed(h, sig)
        server.close_session(h)
        _close(np.concatenate(list(server.iter_results(h))), computer.compute_full(sig))


def test_stream_server_warmup():
    computer = _computer()
    with StreamServer(computer, slots=4, chunk_size=800, tick_chunks=4) as server:
        server.warmup(occupancies=(1, 2))
        sig = np.random.RandomState(7).randn(3000)
        h = server.open_session()
        server.feed(h, sig)
        server.close_session(h)
        _close(np.concatenate(list(server.iter_results(h))), computer.compute_full(sig))
