"""Corpus extraction with pitch: ``ShardedExtractor(pitch=...)``'s
``extract_iter`` over batches of ragged utterances, double-buffered, as an
ESPnet1 recipe dumps fbank+pitch features for a whole training corpus.

Mix parameters: those of :mod:`bench_port.kinds.corpus`, and in ``audio``
a ``"voiced"`` block (:func:`synth`).  The configuration's ``"pitch"``
block is the extractor's ``pitch=`` and the reference's
(:class:`bench_port.reference.pitch.PitchSpec`).

Values for the readers: those of the corpus kind; ``counters``, the
extractor's ``stats`` over the window (``pitch_frames``,
``pitch_valid_frames``, ...); ``work["pitch_frames"]``, the tracked frames
of the traced batches (this rank's rows, counted by the reference's frame
grid); ``trace.ranges["extract.pitch"]``, the device intervals of the
program's ``"extract.pitch"`` profiler ranges
(:class:`bench_port.trace_pitch.PitchTracer`).

``correct``: the filter-bank columns against ``reference/fbank.py``
(:func:`bench_port.check.compare`), the three pitch columns against
``reference/pitch.py`` (:func:`numbers`).
"""

import math
import time

import numpy as np
import torch

from .. import check, common, traffic
from ..common import StageTimer
from ..reference.pitch import PitchSpec

CONTINUE, TRACE, STOP = 1, 2, 0


def synth(lengths, seed: int, tag: str, audio: dict, rate: int, device, rows_per_call: int = 64):
    """The corpus kind's speech-like noise (:func:`bench_port.traffic.synth`:
    tilted white noise under a syllable-rate envelope) with a voiced source
    added on the top part of each syllable, scaled to ``rms``, as host int16
    PCM (or float32).

    ``audio["voiced"]``: ``f0_min_hz``/``f0_max_hz`` (each utterance's f0
    glides between two values drawn within this range, log-uniform, along
    a sine of period ``glide_s_min``-``glide_s_max`` seconds),
    ``gate`` (the voiced source is on where the syllable envelope, 0 to 1,
    is above it, fading in over the next 0.2) and ``level_db`` (the voiced
    source's power over the noise's, where it is fully on).  The source is
    a unit pulse train at f0 under the noise's spectral tilt, as a glottal
    source under the vocal tract's roll-off."""
    lengths = [int(n) for n in lengths]
    v = audio["voiced"]
    g = torch.Generator(device=device)
    g.manual_seed(traffic.torch_seed(seed, tag))
    lo_f, hi_f = math.log(float(v["f0_min_hz"])), math.log(float(v["f0_max_hz"]))
    out = []
    for lo in range(0, len(lengths), rows_per_call):
        block = lengths[lo: lo + rows_per_call]
        B, L = len(block), max(block)
        f = torch.fft.rfftfreq(L, 1.0 / rate, device=device)
        tilt = (1.0 + f / float(audio["tilt_hz"])) ** (-float(audio["tilt_power"]))
        t = torch.arange(L, device=device, dtype=torch.float64) / rate
        phase = torch.rand((B, 1), generator=g, device=device, dtype=torch.float64) * (2 * math.pi)
        s = 0.5 * (1.0 + torch.sin(2 * math.pi * float(audio["syllable_hz"]) * t + phase))
        env = torch.pow(10.0, -float(audio["dip_db"]) / 20.0 * (1.0 - s))
        noise = torch.randn((B, L), generator=g, device=device, dtype=torch.float32)
        noise = torch.fft.irfft(torch.fft.rfft(noise) * tilt, n=L).double()
        # the f0 contour: between two log-uniform ends, along a slow sine
        ends = lo_f + (hi_f - lo_f) * torch.rand((B, 2), generator=g, device=device,
                                                 dtype=torch.float64)
        period = float(v["glide_s_min"]) + (float(v["glide_s_max"]) - float(v["glide_s_min"])) \
            * torch.rand((B, 1), generator=g, device=device, dtype=torch.float64)
        glide_phase = torch.rand((B, 1), generator=g, device=device, dtype=torch.float64) * 2 * math.pi
        mix = 0.5 * (1.0 + torch.sin(2 * math.pi * t / period + glide_phase))
        f0 = torch.exp(ends[:, :1] + (ends[:, 1:] - ends[:, :1]) * mix)
        cycles = torch.floor(torch.cumsum(f0, dim=1) / rate)
        pulses = torch.diff(cycles, dim=1, prepend=torch.zeros_like(cycles[:, :1])).float()
        voiced = torch.fft.irfft(torch.fft.rfft(pulses) * tilt, n=L).double()
        gate = torch.clamp((s - float(v["gate"])) / 0.2, 0.0, 1.0)
        valid = torch.arange(L, device=device)[None, :] < torch.tensor(block, device=device)[:, None]

        def unit(x):
            return x / torch.sqrt((x * x * valid).sum(1, keepdim=True) / valid.sum(1, keepdim=True))

        level = 10.0 ** (float(v["level_db"]) / 20.0)
        x = env * (unit(noise) + level * gate * unit(voiced))
        x = x * (float(audio["rms"]) / torch.sqrt((x * x * valid).sum(1, keepdim=True)
                                                  / valid.sum(1, keepdim=True)))
        if audio.get("pcm") == "int16":
            x = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
        else:
            x = x.float()
        host = x.cpu().numpy()
        out.extend(np.ascontiguousarray(host[i, :n]) for i, n in enumerate(block))
    return out


COLUMNS = ("pov", "lnp", "dlp")
NUMBERS = ("pitch_departed_share", *(f"pitch_{c}_{k}" for c in COLUMNS for k in ("err", "p99")),
           "pitch_tie_utt_share", "pitch_pov_utt_p99", "pitch_lnp_utt_p50")


def _pct(e, q=99):
    return float(np.percentile(e, q, method="higher")) if e.size else 0.0


def numbers(pspec: PitchSpec, items, device, precision: str = "float64"):
    """The pitch columns' readings of ``items``, ``(signal, rows)`` with
    ``rows`` the program's three pitch columns (None: no answer), against
    the reference at ``precision`` ``"float64"``, over every checked
    utterance's rows (the tail past the track too):

    - ``pitch_departed_share``: the share of rows whose normalised log
      pitch departs from the reference's by more than one step of the lag
      grid in log lag (``log1p(lag_resolution)``): the chosen lag is
      neither the reference's nor a neighbour of it.  A sound float32
      tracker departs only where the float64 path sits on a near-tie;
    - ``pitch_pov_err``, ``pitch_lnp_err``: the largest error of the POV
      and the normalised log pitch columns on the rows that agree (all but
      the departed ones); ``pitch_dlp_err``, of the delta log pitch column
      on the rows whose delta window (``delta_window`` rows each side)
      holds no departed row;
    - ``pitch_pov_p99``, ``pitch_lnp_p99``, ``pitch_dlp_p99``: the 99th
      percentiles of the same errors.  A lag one step off the reference's
      on a near-tie moves a row's log pitch by up to a step, and the POV
      where the voicing NCCF is not flat there: a few rows, which the
      maxima see; an error of the arithmetic moves most rows, which the
      percentiles see;
    - per utterance, so that a fault confined to one utterance shows
      however few of the checked rows it holds: a row is *off the lag*
      where its log pitch is off by more than a fifth of a step (the
      chosen lag is a neighbour of the reference's, or departs), and
      ``pitch_tie_utt_share`` is the largest share of one utterance's rows
      off the lag; ``pitch_pov_utt_p99``, the largest 99th percentile of
      one utterance's POV errors on its other rows; ``pitch_lnp_utt_p50``,
      the largest median of one utterance's log pitch errors there.
      Near-ties are few and scattered, so they leave one utterance's
      numbers alone; a wrong row of the batch moves all of its own.  The
      log pitch takes the median: where the reference's voicing NCCF is
      flat at its peak, the parabola moves a stretch of rows by up to
      3e-4, more than 1% of an utterance; the delta column, which follows
      those stretches, is held over all rows only.

    Rows whose shape is not the reference's make every number infinite
    (their count is also the filter-bank check's ``row_count_mismatches``)."""
    step = math.log1p(pspec.resolution)
    kernel = np.ones(2 * pspec.delta_window + 1, np.int64)
    departed = rows_n = 0
    errs = {c: [] for c in COLUMNS}
    out = dict.fromkeys(NUMBERS[-3:], 0.0)
    for signal, rows in items:
        if rows is None:
            continue
        want = pspec.features(signal, rows.shape[0], device, precision)
        if rows.shape != want.shape:
            return dict.fromkeys(NUMBERS, math.inf)
        d = np.abs(np.asarray(rows, np.float64) - want)
        d = np.where(np.isfinite(d), d, math.inf)
        off = d[:, 1] > step
        departed += int(off.sum())
        rows_n += off.size
        near = np.convolve(off.astype(np.int64), kernel, "same") > 0
        for c, mask in zip(COLUMNS, (~off, ~off, ~near)):
            errs[c].append(d[mask, COLUMNS.index(c)])
        tie = d[:, 1] > step / 5
        for key, value in (("pitch_tie_utt_share", float(tie.mean()) if tie.size else 0.0),
                           ("pitch_pov_utt_p99", _pct(d[~tie, 0])),
                           ("pitch_lnp_utt_p50", _pct(d[~tie, 1], 50))):
            out[key] = max(out[key], value)
    out["pitch_departed_share"] = departed / max(rows_n, 1)
    for c in COLUMNS:
        e = np.concatenate(errs[c]) if errs[c] else np.zeros(0)
        out[f"pitch_{c}_err"] = float(e.max(initial=0.0))
        out[f"pitch_{c}_p99"] = _pct(e)
    return out


def readings(spec, pspec, fbank, pitch, device):
    """The numbers a run's check compares with its limits: the filter-bank
    columns' (:func:`bench_port.check.compare`) and the pitch columns'
    (:func:`numbers`)."""
    got = check.compare(spec, fbank, device)
    got.update(numbers(pspec, pitch, device))
    return got


def run(ctx, read=readings):
    """One run of the cell; ``read`` (as :func:`readings`) reads the
    sampled answers for the check."""
    from speech_tpu_torch.parallel import ShardedExtractor

    from .. import program
    from ..trace_pitch import PitchTracer

    mix, spec, rec = ctx.mix, ctx.spec, ctx.run
    rate = spec.rate
    pspec = PitchSpec(ctx.config["pitch"], rate)
    comp = program.computer(ctx.config, ctx.device)
    ex = ShardedExtractor(comp, ctx.mesh, aot_dir=program.aot_store(ctx.device),
                          pitch=ctx.config["pitch"])
    batch, pool_n = int(mix["batch"]), int(mix["pool_batches"])
    lengths = traffic.shuffled(
        traffic.uniform_lengths(batch * pool_n, mix["seconds_min"], mix["seconds_max"], rate),
        ctx.seed, "corpus.lengths")
    signals = synth(lengths, ctx.seed, "corpus.audio", mix["audio"], rate, ctx.device)
    pool = [signals[i * batch: (i + 1) * batch] for i in range(pool_n)]
    first, per = ex._row_block(-(-max(batch, int(mix["min_batch"])) // ex.batch_multiple)
                               * ex.batch_multiple)

    def own_rows(b):
        """This rank's valid frames, samples and tracked frames of pool
        batch ``b``."""
        lens = lengths[b * batch: (b + 1) * batch][first: first + per]
        return (sum(spec.frame_count(int(n)) for n in lens), int(lens.sum()),
                sum(pspec.frame_count(int(n)) for n in lens))

    own = [own_rows(b) for b in range(pool_n)]
    audio = [float(lengths[b * batch: (b + 1) * batch].sum()) / rate for b in range(pool_n)]
    # warm-up: one pass over the pool, two batches in flight as in the window
    for _ in ex.extract_iter(pool, min_batch=int(mix["min_batch"])):
        pass
    _sync(ctx.device)

    timer = StageTimer(rec.spans, "extract.")
    order = []  # pool index of each batch dispatched in the window
    traced_from = traced_at = None
    tracer = PitchTracer(ctx.device) if ctx.trace else None

    def decide(now, t_end, t_trace):
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

    pick, k = traffic.rng(ctx.seed, "corpus.check"), int(mix["check_batches"])
    kept = {}  # slot -> (pool index, outputs)
    done_audio, n_done = 0.0, 0
    ctx.barrier()
    stats0 = dict(ex.stats)
    t0 = ctx.start_window()
    t_end = t0 + ctx.seconds
    t_trace = t_end - float(mix["trace_seconds"])
    t_last = t0
    finished = []
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
    rec.counters = {key: ex.stats[key] - stats0[key] for key in ex.stats}
    if tracer is not None and traced_from is not None:
        rec.trace = tracer.stop()
        traced = order[traced_from:]
        rec.work = {
            "frames": sum(own[b][0] for b in traced),
            "samples": sum(own[b][1] for b in traced),
            "launches": len(traced),
            "pitch_frames": sum(own[b][2] for b in traced),
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
        return
    fbank, pitch = [], []
    nc = spec.num_coeffs
    for _, (b, outs) in sorted(kept.items()):
        for j, sig in enumerate(pool[b]):
            rows_j = outs[j] if j < len(outs) else None
            fbank.append((sig, None if rows_j is None else rows_j[:, :nc], None))
            pitch.append((sig, None if rows_j is None else rows_j[:, nc:]))
    rec.correct, rec.checks = check.verdict(read(spec, pspec, fbank, pitch, ctx.device),
                                            ctx.limits)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
