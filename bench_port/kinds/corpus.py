"""Corpus extraction: ``ShardedExtractor.extract_iter`` over batches of
ragged utterances, double-buffered, as a training pipeline featurises a
corpus; on several cards every rank runs its row block of each global
batch and reads back every row.

Mix parameters: ``batch`` (utterances a global batch), ``min_batch``,
``pool_batches`` (distinct batches made in set-up and cycled through the
window), ``seconds_min``/``seconds_max`` (uniform utterance lengths),
``audio`` (see :mod:`bench_port.traffic`), ``trace_seconds`` (the traced
tail of the window), ``check_batches`` (batches of the window compared
with the reference, drawn from the seed).

Values for the readers: ``audio_s`` and ``elapsed_s`` (every utterance
whose features came back, over the window, host to host),
``useful_samples``/``kernel_samples`` (real samples over the samples
handed to the kernel after bucketing and batch padding); spans
``extract.dispatch``/``extract.collect``; ``work`` of the traced window
(this rank's valid frames and samples, and its launches).
"""

import time

import torch

from .. import check, traffic
from .. import common
from ..common import StageTimer

CONTINUE, TRACE, STOP = 1, 2, 0


def run(ctx):
    from speech_tpu_torch.parallel import ShardedExtractor

    from .. import program

    mix, spec, rec = ctx.mix, ctx.spec, ctx.run
    rate = spec.rate
    comp = program.computer(ctx.config, ctx.device)
    ex = ShardedExtractor(comp, ctx.mesh, aot_dir=program.aot_store(ctx.device))
    batch, pool_n = int(mix["batch"]), int(mix["pool_batches"])
    lengths = traffic.shuffled(
        traffic.uniform_lengths(batch * pool_n, mix["seconds_min"], mix["seconds_max"], rate),
        ctx.seed, "corpus.lengths")
    signals = traffic.synth(lengths, ctx.seed, "corpus.audio", mix["audio"], rate, ctx.device)
    pool = [signals[i * batch: (i + 1) * batch] for i in range(pool_n)]
    first, per = ex._row_block(-(-max(batch, int(mix["min_batch"])) // ex.batch_multiple)
                               * ex.batch_multiple)

    def own_rows(b):
        """This rank's valid frames and samples of pool batch ``b``."""
        lens = lengths[b * batch: (b + 1) * batch][first: first + per]
        return sum(spec.frame_count(int(n)) for n in lens), int(lens.sum())

    own = [own_rows(b) for b in range(pool_n)]
    audio = [float(lengths[b * batch: (b + 1) * batch].sum()) / rate for b in range(pool_n)]
    # warm-up: one pass over the pool, two batches in flight as in the window
    for _ in ex.extract_iter(pool, min_batch=int(mix["min_batch"])):
        pass
    _sync(ctx.device)

    timer = StageTimer(rec.spans, "extract.")
    order = []  # pool index of each batch dispatched in the window
    traced_from = traced_at = None
    tracer = ctx.tracer()

    def decide(now, t_end, t_trace):
        """Rank 0's clock decides for every rank: stop, or go on (and
        start the trace); a traced run goes on until its trace is
        ``trace_seconds`` long."""
        code = CONTINUE
        if tracer is not None and traced_from is None and now >= t_trace:
            code = TRACE
        elif now >= t_end and (tracer is None or now >= traced_at + float(mix["trace_seconds"])):
            code = STOP
        return ctx.agree(code)

    def batches(t_end, t_trace):
        nonlocal traced_from, traced_at
        i = 0
        while True:
            code = decide(time.perf_counter(), t_end, t_trace)
            if code == STOP:
                return
            if code == TRACE:
                traced_from = len(order)
                traced_at = tracer.start()
            order.append(i % pool_n)
            yield pool[i % pool_n]
            i += 1

    # a sample of the window's batches, drawn from the seed (a reservoir)
    pick, k = traffic.rng(ctx.seed, "corpus.check"), int(mix["check_batches"])
    kept = {}  # slot -> (pool index, outputs)
    done_audio, n_done = 0.0, 0
    ctx.barrier()
    t0 = ctx.start_window()
    t_end = t0 + ctx.seconds
    t_trace = t_end - float(mix["trace_seconds"])
    t_last = t0
    finished = []  # (time, audio seconds) of each batch read back
    for outs in ex.extract_iter(batches(t_end, t_trace), min_batch=int(mix["min_batch"]), timer=timer):
        t_last = time.perf_counter()
        b = order[n_done]
        done_audio += audio[b]
        finished.append((t_last, audio[b]))
        if len(outs) != len(pool[b]):
            rec.failed += len(pool[b]) - len(outs)
        slot = n_done if n_done < k else int(pick.integers(0, n_done + 1))
        if slot < k:
            kept[slot] = (b, outs)
        n_done += 1
    rec.t1 = t_last
    if tracer is not None and traced_from is not None:
        rec.trace = tracer.stop()
        traced = order[traced_from:]
        rec.work = {
            "frames": sum(own[b][0] for b in traced),
            "samples": sum(own[b][1] for b in traced),
            "launches": len(traced),
        }
    rec.attempted = n_done * batch
    rec.values.update(audio_s=done_audio, elapsed_s=t_last - t0, batches=n_done)
    rec.values["timeline"] = common.timeline([t for t, _ in finished], [a for _, a in finished],
                                             t0, t_last)
    bucketed = [ex.bucket_len(max(len(s) for s in pool[b])) for b in order]
    rows = -(-max(batch, int(mix["min_batch"])) // ex.batch_multiple) * ex.batch_multiple
    rec.values["useful_samples"] = float(sum(lengths[b * batch: (b + 1) * batch].sum() for b in order))
    rec.values["kernel_samples"] = float(sum(rows * n for n in bucketed))
    rec.memory_peak_bytes = ctx.memory_peak()
    del ex, comp
    if ctx.rank != 0:
        return  # every rank read back every row: rank 0 judges them
    items = []
    for _, (b, outs) in sorted(kept.items()):
        for j, sig in enumerate(pool[b]):
            items.append((sig, outs[j] if j < len(outs) else None, None))
    numbers = check.compare(spec, items, ctx.device)
    rec.correct, rec.checks = check.verdict(numbers, ctx.limits)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
