"""Live streams: ``StreamServer.feed``/``iter_results`` with every session
fed 100 ms chunks at real-time pacing, as live captioning and dictation
send audio; a closed session is replaced at once by a new one.

Mix parameters: ``sessions`` (concurrent sessions, the server's slots),
``chunk_ms``, ``seconds_min``/``seconds_max`` (uniform session lengths),
``tick_chunks``, ``max_wait_ms`` (the server's), ``audio``,
``trace_seconds`` (the traced tail of the window), ``check_sessions``
(sessions of the window compared with the reference, drawn from the seed;
the longest is always among them), ``settle_s``.

Session ``k`` of lane ``j`` starts at ``t0 + phase_j`` plus the chunks of
the lane's earlier sessions; chunk ``c`` of a session is due when its last
sample would have been spoken, ``start + (c + 1) * chunk``.  A chunk's
latency runs from its due time to the moment ``iter_results`` yields the
rows it completes (the frames that read no later sample; the last chunk's
rows come with the close's flush).  Values: ``chunk_latency_s`` of every
chunk due in the window (``inf`` for one whose rows never came),
``lateness_s`` of the scheduler; spans ``stream.step``.
"""

import bisect
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import check, common, traffic


class _Lane:
    """One slot's succession of sessions."""

    def __init__(self):
        self.cond = threading.Condition()
        self.sess = -1  # the session whose handle is open
        self.handle = None
        self.backlog = []  # (session, samples) fed before its session opened
        self.dead = False


class _Session:
    def __init__(self, lane, index, start, signal, chunk):
        self.lane, self.index, self.start, self.signal = lane, index, start, signal
        self.n_chunks = -(-signal.size // chunk)
        self.times, self.rows = [], []  # arrival time and cumulative rows of each block
        self.blocks = None  # kept for the check
        self.fed = 0  # samples fed before the window closed
        self.opened = False


def run(ctx):
    from speech_tpu_torch.serve import StreamServer

    from .. import program

    mix, spec, rec = ctx.mix, ctx.spec, ctx.run
    comp = program.computer(ctx.config, ctx.device)
    S = int(mix["sessions"])
    chunk = int(spec.rate * float(mix["chunk_ms"]) / 1000)
    server = StreamServer(comp, slots=S, chunk_size=chunk, tick_chunks=int(mix["tick_chunks"]),
                          max_wait_ms=float(mix["max_wait_ms"]),
                          aot_dir=program.aot_store(ctx.device))
    consumers = ThreadPoolExecutor(max_workers=S + 16, thread_name_prefix="bench-consume")
    closers = ThreadPoolExecutor(max_workers=8, thread_name_prefix="bench-close")
    try:
        items = _drive(ctx, server, consumers, closers, mix, spec, rec, S, chunk)
    finally:
        closers.shutdown(wait=True)
        server.close()
        consumers.shutdown(wait=True)
    del server, comp
    numbers = check.compare(spec, items, ctx.device)
    rec.correct, rec.checks = check.verdict(numbers, ctx.limits)


def _plan(ctx, mix, spec, S, chunk):
    """Every lane's sessions that start inside the window: ``(lane, start
    offset, length)``, the same set of lengths and phases for every seed."""
    rate, chunk_s = spec.rate, chunk / spec.rate
    per_lane = int(math.ceil(ctx.seconds / float(mix["seconds_min"]))) + 1
    lengths = traffic.shuffled(
        traffic.uniform_lengths(S * per_lane, mix["seconds_min"], mix["seconds_max"], rate),
        ctx.seed, "stream.lengths")
    phases = traffic.shuffled((np.arange(S) + 0.5) / S * chunk_s, ctx.seed, "stream.phases")
    plan = []
    for j in range(S):
        start = float(phases[j])
        for k in range(per_lane):
            if start >= ctx.seconds and k:
                break
            n = int(lengths[j * per_lane + k])
            plan.append((j, start, n))
            start += -(-n // chunk) * chunk_s
    return plan


def _drive(ctx, server, consumers, closers, mix, spec, rec, S, chunk):
    rec.spans.wrap(server._pool, "step", "stream.step")
    rate = spec.rate
    plan = _plan(ctx, mix, spec, S, chunk)
    signals = traffic.synth([n for _, _, n in plan], ctx.seed, "stream.audio", mix["audio"],
                            rate, ctx.device)
    lanes = [_Lane() for _ in range(S)]
    sessions, by_lane = [], [[] for _ in range(S)]
    for (j, start, _), sig in zip(plan, signals):
        s = _Session(j, len(by_lane[j]), start, sig, chunk)
        sessions.append(s)
        by_lane[j].append(s)
    pick = traffic.rng(ctx.seed, "stream.check")
    sample = set(pick.choice(len(sessions), min(len(sessions), int(mix["check_sessions"])),
                             replace=False).tolist())
    sample.add(int(np.argmax([s.signal.size for s in sessions])))
    for i in sample:
        sessions[i].blocks = []
    occupancies = [1 << k for k in range(max(1, S).bit_length())]
    server.warmup(occupancies=occupancies)

    def consume(s, handle):
        total = 0
        try:
            for feats in server.iter_results(handle):
                t = time.perf_counter()
                total += feats.shape[0]
                s.times.append(t)
                s.rows.append(total)
                if s.blocks is not None:
                    s.blocks.append(feats)
        except RuntimeError:
            pass  # the session failed: its chunks' rows never come

    def open_next(lane, s):
        try:
            handle = server.open_session()
        except RuntimeError:
            with lane.cond:
                lane.dead = True
                lane.cond.notify_all()
            return
        s.opened = True
        consumers.submit(consume, s, handle)
        with lane.cond:
            # the pieces fed before this session opened; a later session's
            # (its predecessors' closes lagging by a whole session) wait
            # for their own
            for k, samples in lane.backlog:
                if k == s.index:
                    server.feed(handle, samples)
            lane.backlog = [(k, p) for k, p in lane.backlog if k != s.index]
            lane.sess, lane.handle = s.index, handle
            lane.cond.notify_all()

    def close(lane, s, reopen):
        with lane.cond:
            lane.cond.wait_for(lambda: lane.sess == s.index or lane.dead)
            if lane.dead:
                return
            handle = lane.handle
        server.close_session(handle)
        nxt = by_lane[s.lane][s.index + 1] if s.index + 1 < len(by_lane[s.lane]) else None
        if reopen and nxt is not None:
            open_next(lane, nxt)

    for j in range(S):  # the first sessions open in set-up
        open_next(lanes[j], by_lane[j][0])

    # every chunk of the window: (due offset, session, chunk index)
    events = []
    for s in sessions:
        for c in range(s.n_chunks):
            due = s.start + min((c + 1) * chunk, s.signal.size) / rate
            if due < ctx.seconds:
                events.append((due, id(s), c, s))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    tracer = ctx.tracer()
    traced = False
    t0 = ctx.start_window()
    t_trace = t0 + ctx.seconds - float(mix["trace_seconds"])
    for off, _, c, s in events:
        due = t0 + off
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if tracer is not None and not traced and due >= t_trace:
            tracer.start()
            traced = True
        rec.lateness.append(time.perf_counter() - due)
        lane = lanes[s.lane]
        piece = s.signal[c * chunk: (c + 1) * chunk]
        with lane.cond:
            if lane.dead:
                continue
            if lane.sess == s.index:
                server.feed(lane.handle, piece)
            else:
                lane.backlog.append((s.index, piece))
            s.fed = c * chunk + piece.size
        if c == s.n_chunks - 1:
            closers.submit(close, lane, s, True)
    if traced:
        rec.trace = tracer.stop()
    t_end = t0 + ctx.seconds

    # every chunk due in the window: the rows it completes, and when
    chunks = [(s, c, t0 + off) for off, _, c, s in events]
    due_rows = [spec.frames_done_after(min((c + 1) * chunk, s.signal.size), s.signal.size)
                for s, c, _ in chunks]
    deadline = time.perf_counter() + float(mix["settle_s"])
    pending = [k for k in range(len(chunks))]
    while pending and time.perf_counter() < deadline:
        pending = [k for k in pending
                   if not (chunks[k][0].rows and chunks[k][0].rows[-1] >= due_rows[k])]
        if pending:
            time.sleep(0.01)
    # the sessions still open when the window closed: close them (their
    # flush is of a cut signal, and is not judged)
    cut = [s for s in sessions if s.opened and s.fed < s.signal.size]
    for s in cut:
        closers.submit(close, lanes[s.lane], s, False)
    latency = []
    for (s, c, due), want in zip(chunks, due_rows):
        k = bisect.bisect_left(s.rows, want)
        latency.append(max(0.0, s.times[k] - due) if k < len(s.rows) else math.inf)
    rec.t1 = t_end
    rec.attempted = len(chunks)
    rec.failed = int(sum(1 for x in latency if not math.isfinite(x)))
    rec.values["chunk_latency_s"] = latency
    rec.values["timeline"] = common.timeline(
        [due for _, _, due in chunks], [x * 1e3 for x in latency], t0, t_end,
        stat=lambda v: round(common.percentile(v, 95), 3))
    rec.memory_peak_bytes = ctx.memory_peak()
    items = []
    for i in sorted(sample):
        s = sessions[i]
        if s.fed == 0:
            continue  # its first chunk was not due in the window
        upto = spec.frames_done_after(s.fed, s.signal.size)
        blocks = list(s.blocks)
        rows = np.concatenate(blocks) if blocks else None
        items.append((s.signal, rows, upto))
    return items
