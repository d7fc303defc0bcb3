"""Replayed streams with pitch: ``StreamServer`` over the joined filter-bank
and online pitch streamer (``StreamingAppendPitch``), every slot a lane of
sessions back to back in a closed loop, as Kaldi's
``steps/online/nnet3/decode.sh`` feeds each test utterance through the
online pipeline as fast as it goes.

A lane opens a session, feeds its whole utterance at once, closes it
(the server drains a closing session's backlog through its ticks, one
100 ms chunk a tick at ``tick_chunks`` 1, so every session is chunked as
the reference replays it), reads its rows to the end, and opens the next
session at once.  Lane ``j`` starts with pool utterance ``j`` and walks
the pool in an order of its own (:func:`lane_orders`).  The lanes start
``ramp_s`` before the window, so that the window sees them out of step,
as a server's sessions are.  That ramp is load the run does not measure,
and not set-up: ``setup_s`` ends when the server's warm-up has run, before
the lanes start.

Mix parameters: ``sessions`` (lanes, the server's slots), ``chunk_ms``,
``tick_chunks``, ``max_wait_ms`` (the server's), ``pool`` (distinct
utterances, made in set-up), ``seconds_min``/``seconds_max`` (uniform
utterance lengths), ``audio`` (with the pitch mix's ``"voiced"`` block,
:func:`bench_port.kinds.corpus_pitch.synth`), ``trace_seconds`` (the
traced tail of the window), ``check_sessions`` (lanes drawn from the
seed whose first session opened inside the window is compared with the
references: a session in a slot that other sessions used before it,
beside sessions at other stages; one of them, drawn from the seed, opens
the pool's longest utterance there), ``ramp_s``, ``settle_s`` (the lanes'
time to finish their sessions after the window).

Values: ``audio_s``, the rows that came back to the host in the window
(the rows each tick and each close's flush hand the server), times the
frame shift; ``elapsed_s``, the window; spans ``stream.step``
(``StreamPool.step``) and ``stream.pitch`` (the streamer's pitch share of
a tick, ``_pitch_step``); ``counters``, the server's ``stats`` over the
window; ``work["pitch_frames"]``, the frames tracked in the traced
window, and ``work["launches"]``, its ticks; ``trace.ranges`` of the
program's ``"stream.pitch"`` ranges (:class:`bench_port.trace_stream.StreamTracer`).

``correct``: the filter-bank columns against ``reference/fbank.py``
(:func:`bench_port.check.compare`), the pitch columns against
``reference/pitch_online.py`` replaying the session's chunking, with the
pitch cell's numbers (:func:`bench_port.kinds.corpus_pitch.numbers`).
"""

import threading
import time

import numpy as np
import torch

from .. import check, common, traffic
from ..reference.pitch_online import OnlinePitchSpec
from .corpus_pitch import numbers, synth


class _Lane:
    def __init__(self, index):
        self.index = index
        self.checked = None  # (utterance, rows) of its first session opened in the window
        self.sessions = 0
        self.error = None


def readings(spec, pspec, fbank, pitch, device):
    """The numbers a run's check compares with its limits."""
    got = check.compare(spec, fbank, device)
    got.update(numbers(pspec, pitch, device))
    return got


def run(ctx, read=readings):
    """One run of the cell; ``read`` (as :func:`readings`) reads the
    sampled answers for the check."""
    from speech_tpu_torch.serve import StreamServer
    from speech_tpu_torch.streaming import StreamingAppendPitch

    from .. import program
    from ..trace_stream import StreamTracer, ticks_within

    mix, spec, rec = ctx.mix, ctx.spec, ctx.run
    rate, S, P = spec.rate, int(mix["sessions"]), int(mix["pool"])
    chunk = int(rate * float(mix["chunk_ms"]) / 1000)
    pspec = OnlinePitchSpec(ctx.config["pitch"], rate, chunk)
    comp = program.computer(ctx.config, ctx.device)
    streamer = StreamingAppendPitch(comp, ctx.config["pitch"], chunk_size=chunk)
    server = StreamServer(streamer, slots=S, chunk_size=chunk,
                          tick_chunks=int(mix["tick_chunks"]), max_wait_ms=float(mix["max_wait_ms"]),
                          aot_dir=program.aot_store(ctx.device))
    rec.spans.wrap(server._pool, "step", "stream.step")
    came_back = _count_rows(server._pool)
    rec.spans.wrap(streamer, "_pitch_step", "stream.pitch")
    lengths = traffic.shuffled(traffic.uniform_lengths(P, mix["seconds_min"], mix["seconds_max"], rate),
                               ctx.seed, "replay.lengths")
    longest = int(np.argmax(lengths))
    pool = synth(lengths, ctx.seed, "replay.audio", mix["audio"], rate, ctx.device)
    pick = traffic.rng(ctx.seed, "replay.check")
    sample = sorted(pick.choice(S, min(S, int(mix["check_sessions"])), replace=False).tolist())
    forced = sample[int(traffic.rng(ctx.seed, "replay.longest").integers(0, len(sample)))]
    server.warmup(occupancies=[1 << k for k in range(max(1, S).bit_length())])
    _sync(ctx.device)
    t_ready = time.perf_counter()

    lanes = [_Lane(j) for j in range(S)]
    stop, window = threading.Event(), threading.Event()

    orders = lane_orders(ctx.seed, S, P)

    def drive(lane):
        k, sampled = 0, lane.index in sample
        try:
            # a sampled lane runs on past the window until its session is
            # checked
            while not stop.is_set() or (sampled and lane.checked is None):
                u = orders[lane.index][k % P]
                check = sampled and lane.checked is None and window.is_set()
                if check and lane.index == forced:
                    u = longest
                handle = server.open_session()
                lane.sessions += 1
                server.feed(handle, pool[u])
                server.close_session(handle)
                blocks = list(server.iter_results(handle))
                if check:
                    lane.checked = (u, np.concatenate(blocks) if blocks
                                    else np.zeros((0, streamer.num_coeffs)))
                k += 1
        except Exception as e:  # noqa: BLE001 -- the run reports it
            lane.error = e

    tracer = StreamTracer(ctx.device) if ctx.trace else None
    hold = _Hold(server._pool) if tracer is not None else None
    threads = [threading.Thread(target=drive, args=(lane,), name=f"bench-lane-{lane.index}",
                                daemon=True) for lane in lanes]
    for t in threads:
        t.start()
    time.sleep(float(mix["ramp_s"]))
    stats0 = server.stats
    t0 = ctx.start_window()
    window.set()
    rec.setup_s = t_ready - ctx.t_start  # the ramp is unmeasured load, not set-up
    t_end = t0 + ctx.seconds
    if tracer is not None:
        time.sleep(max(0.0, t_end - float(mix["trace_seconds"]) - time.perf_counter()))
        traced = server.stats
        hold.run(tracer.start)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    stats1 = server.stats
    if tracer is not None:
        rec.trace = hold.run(tracer.stop)
        rec.work = {"pitch_frames": stats1["pitch_frames_tracked"] - traced["pitch_frames_tracked"],
                    "launches": len(ticks_within(rec.spans, rec.trace))}
    stop.set()
    deadline = time.perf_counter() + float(mix["settle_s"])
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    server.close()
    rec.t1 = t_end
    rec.counters = {key: stats1[key] - stats0[key] for key in stats1}
    rows_in = sum(n for t, n in came_back if t0 <= t < t_end)
    frame_s = spec.frame_shift / rate
    rec.values.update(audio_s=rows_in * frame_s, elapsed_s=ctx.seconds, rows=rows_in)
    rec.values["timeline"] = common.timeline(
        [t for t, _ in came_back], [n * frame_s for _, n in came_back], t0, t_end)
    rec.attempted = sum(lane.sessions for lane in lanes)
    rec.failed = sum(lane.error is not None for lane in lanes)
    rec.memory_peak_bytes = ctx.memory_peak()
    errors = [lane.error for lane in lanes if lane.error is not None]
    if errors:
        raise RuntimeError(f"{len(errors)} lane(s) failed") from errors[0]
    del server, streamer, comp
    fbank, pitch = [], []
    nc = spec.num_coeffs
    for j in sample:
        u, rows = lanes[j].checked or (orders[j][0], None)
        fbank.append((pool[u], None if rows is None else rows[:, :nc], None))
        pitch.append((pool[u], None if rows is None else rows[:, nc:]))
    rec.correct, rec.checks = check.verdict(read(spec, pspec, fbank, pitch, ctx.device), ctx.limits)


class _Hold:
    """Holds the server's loop thread between two ticks (at the entry of
    ``StreamPool.step``, outside the spans that time it) while :meth:`run`
    runs ``fn``: the profiler starts and stops with no thread launching
    kernels (a profiler started or stopped beside a thread that launches
    them lost the card's kernel records, for that session and the process's
    later ones)."""

    def __init__(self, pool, timeout: float = 5.0):
        self._cond = threading.Condition()
        self._want = self._holding = False
        self._timeout = timeout
        step = pool.step

        def held(*args, **kw):
            with self._cond:
                if self._want:
                    self._holding = True
                    self._cond.notify_all()
                    self._cond.wait_for(lambda: not self._want)
                    self._holding = False
            return step(*args, **kw)

        pool.step = held

    def run(self, fn):
        """``fn()`` with the loop held (or idle: a loop with no tick within
        the timeout launches nothing)."""
        with self._cond:
            self._want = True
            self._cond.wait_for(lambda: self._holding, self._timeout)
        try:
            return fn()
        finally:
            with self._cond:
                self._want = False
                self._cond.notify_all()


def lane_orders(seed: int, lanes: int, pool: int):
    """Each lane's order of the pool's utterances, drawn from the seed:
    lane ``j`` starts with utterance ``j`` and then walks the pool in an
    order of its own."""
    out = []
    for j in range(lanes):
        rest = [i for i in traffic.rng(seed, f"replay.lane{j}").permutation(pool).tolist() if i != j]
        out.append([j] + rest)
    return out


def _count_rows(pool):
    """``[(time, rows)]`` of every return of ``pool.step`` (a tick) and
    ``pool.close_many`` (the flush of the sessions a tick emptied), the
    rows that came back to the host, as they return; a step inside a
    close counts with the close."""
    came_back, closing = [], threading.local()

    def counted(fn, inner):
        def call(*args, **kw):
            if inner:
                closing.on = True
            try:
                out = fn(*args, **kw)
            finally:
                if inner:
                    closing.on = False
            if inner or not getattr(closing, "on", False):
                came_back.append((time.perf_counter(), sum(f.shape[0] for _, f in out)))
            return out

        return call

    pool.step = counted(pool.step, False)
    pool.close_many = counted(pool.close_many, True)
    return came_back


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
