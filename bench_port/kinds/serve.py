"""Whole-utterance serving: ``FeatureServer.submit`` under an open loop of
Poisson arrivals from one scheduler thread, as independent callers send
requests to a feature service.

Mix parameters: ``max_batch``, ``max_wait_ms`` (the server's),
``pool`` (distinct utterances made in set-up, sent in a seeded order),
``seconds_min``/``seconds_max`` (uniform lengths), ``rate_per_s`` (the
offered load), ``audio``, ``trace_seconds`` (the traced tail of the
window), ``check_requests`` (requests of the window compared with the
reference, drawn from the seed; the longest utterance's request is always
among them), ``settle_s`` (how long after the window a request may still
answer before it counts as failed).

Each request is timed from its due time in the schedule to its future's
result, so a stall of the scheduler or of the server counts against every
request it delays.  Values: ``latency_s`` of every request due in the
window (``inf`` for a failed one), ``lateness_s`` of the scheduler;
counters ``completed``/``batches`` over the window; spans
``serve._launch``/``serve._readback``.
"""

import math
import threading
import time

import numpy as np

from .. import check, common, traffic


def run(ctx):
    from speech_tpu_torch.serve import FeatureServer

    from .. import program

    mix, spec, rec = ctx.mix, ctx.spec, ctx.run
    rate = spec.rate
    comp = program.computer(ctx.config, ctx.device)
    server = FeatureServer(comp, max_batch=int(mix["max_batch"]),
                           max_wait_ms=float(mix["max_wait_ms"]),
                           aot_dir=program.aot_store(ctx.device))
    try:
        items = _drive(ctx, server, mix, spec, rec, rate)
    finally:
        server.close()
    del server, comp
    numbers = check.compare(spec, items, ctx.device)
    rec.correct, rec.checks = check.verdict(numbers, ctx.limits)


def _drive(ctx, server, mix, spec, rec, rate):
    rec.spans.wrap(server, "_launch", "serve._launch")
    rec.spans.wrap(server, "_readback", "serve._readback")
    lengths = traffic.shuffled(
        traffic.uniform_lengths(int(mix["pool"]), mix["seconds_min"], mix["seconds_max"], rate),
        ctx.seed, "serve.lengths")
    utts = traffic.synth(lengths, ctx.seed, "serve.audio", mix["audio"], rate, ctx.device)
    server.warmup(sorted(set(int(n) for n in lengths)))
    server.extract_many(utts[: 2 * int(mix["max_batch"])])

    lam = float(mix["rate_per_s"])
    gaps = traffic.shuffled(traffic.exp_gaps(int(1.2 * lam * ctx.seconds) + 16, lam),
                            ctx.seed, "serve.gaps")
    offsets = np.cumsum(gaps)
    n = int(np.searchsorted(offsets, ctx.seconds))
    which = np.arange(n) % len(utts)  # request i sends utterance which[i]
    order = traffic.rng(ctx.seed, "serve.order").permutation(len(utts))
    which = order[which]
    pick = traffic.rng(ctx.seed, "serve.check")
    sample = set(pick.choice(n, min(n, int(mix["check_requests"])), replace=False).tolist())
    longest = [i for i in range(n) if lengths[which[i]] == lengths.max()]
    sample.update(longest[:1])

    done = np.full(n, math.nan)
    bad = np.zeros(n, dtype=bool)
    kept = {}
    left = [n]
    lock, all_done = threading.Lock(), threading.Event()

    def finished(i):
        def cb(fut):
            t = time.perf_counter()
            err = fut.exception()
            if err is None and i in sample:
                kept[i] = fut.result()
            with lock:
                done[i] = t
                bad[i] = err is not None
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
        return cb

    tracer = ctx.tracer()
    traced = False
    stats0 = dict(server.stats)
    if n == 0:
        all_done.set()
    t0 = ctx.start_window()
    due = t0 + offsets[:n]
    t_trace = t0 + ctx.seconds - float(mix["trace_seconds"])
    for i in range(n):
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if tracer is not None and not traced and due[i] >= t_trace:
            tracer.start()
            traced = True
        rec.lateness.append(time.perf_counter() - due[i])
        try:
            fut = server.submit(utts[which[i]])
        except RuntimeError:
            with lock:
                done[i], bad[i] = time.perf_counter(), True
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
            continue
        fut.add_done_callback(finished(i))
    if traced:
        rec.trace = tracer.stop()
    all_done.wait(timeout=float(mix["settle_s"]))
    with lock:
        latency = np.where(bad | np.isnan(done), math.inf, done - due)
    stats1 = dict(server.stats)
    rec.t1 = float(np.nanmax(done)) if n else t0
    rec.attempted = n
    rec.failed = int(np.sum(~np.isfinite(latency)))
    rec.values["latency_s"] = latency.tolist()
    rec.values["timeline"] = common.timeline(
        due, latency * 1e3, t0, t0 + ctx.seconds,
        stat=lambda v: round(common.percentile(v, 95), 3))
    rec.counters = {k: stats1[k] - stats0[k] for k in stats1}
    rec.memory_peak_bytes = ctx.memory_peak()
    return [(utts[which[i]], kept.get(i), None) for i in sorted(sample)]
