"""One rank of the multi-process tests of ``speech_tpu_torch.parallel``.

Not collected by pytest (no ``test_`` prefix).  ``tests/test_torch_parallel.py``
and ``tests/test_torch_nn.py`` start one of these per rank (world sizes 2
and 4, one launch each) on the CPU: a gloo process group meeting at a
``FileStore``.  Every rank runs every multi-rank case of the port
(:func:`run_cases`, or :func:`train_step`) on the same deterministic inputs (:func:`inputs`) and
rank 0 writes the gathered results to one ``.npz``; the tests compare them
with the JAX package on its CPU mesh cut to the same number of devices.
The world-size-1 run calls :func:`run_cases` in the test process itself.

This module imports torch, numpy and ``speech_tpu_torch`` only.

Usage: python torch_dist_worker.py <rank> <world> <store file> <out .npz> <cases> [<device>]

where ``<cases>`` is ``parallel`` (:func:`run_cases`), ``train`` (the
data x filter sharded training step of the STFT frontend,
:func:`train_step`; world sizes 2 and 4), ``models_train`` (the
data-parallel step of a KWS model, :func:`models_train_step`),
``serve_pool`` (a ``StreamPool`` with its slots over the data axis,
:func:`serve_pool`), ``serve_group`` (``FeatureServer`` and
``StreamServer`` served from rank 0 over the mesh, :func:`serve_group`),
``serve_bench`` (the main config's 'double' burst through a server on the
mesh, :func:`serve_bench`), ``relay_feeds`` (a stream server's commands
over the relay as objects and as tensors, :func:`relay_feeds`), ``cli`` (``signals-to-torch-feat-dir`` on a mesh,
:func:`cli_extract`) or ``bench`` (:func:`extract_bench`, GPUs only), and ``<device>`` is ``cpu`` (gloo; the default) or ``cuda``
(NCCL, one card a rank: ``tools/torch_multichip.py`` runs the same cases
on four cards).
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np

STFT_CFG = ({"name": "fbank", "num_filts": 10, "sampling_rate": 8000},)
STFT_KW = dict(frame_length_ms=25, frame_shift_ms=10, dtype="float64")
SI_BANK = {"name": "gammatone", "scaling_function": "mel", "num_filts": 6,
           "sampling_rate": 8000}
SI_VARIANTS = [(style, energy) for style in ("causal", "centered") for energy in (False, True)]
PITCH_RATE, PITCH_BATCH = 8000, 4
TRAIN_LR = 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))


def _module(package, name):
    return importlib.import_module(f"{package.__name__}.{name}")


def _device(package, device) -> dict:
    return {"device": device} if package.__name__ == "speech_tpu_torch" else {}


def stft_computer(package, device="cpu", **kw):
    """The fbank-10 computer at 8 kHz (float64) of either package (the
    port's on ``device``)."""
    return _module(package, "compute").STFTFrameComputer(
        *STFT_CFG, **{**STFT_KW, **kw}, **_device(package, device)
    )


def si_computer(package, style, energy, device="cpu"):
    """The gammatone-6 SI computer at 8 kHz (float64) of either package."""
    return _module(package, "compute").SIFrameComputer(
        dict(SI_BANK), frame_style=style, include_energy=energy, dtype="float64",
        **_device(package, device)
    )


def _np(t):
    return t.detach().cpu().numpy()


def post_chain(package):
    """Deltas, sliding CMVN and stacking, as host post-processors."""
    post = _module(package, "post")
    return [
        post.Deltas(1, target_axis=-1),
        post.SlidingCMVN(window=40, center=False, min_window=10),
        post.Stack(3, pad_mode="edge"),
    ]


def si_span(max_support: int, shift: int) -> int:
    """The least per-rank span (a multiple of the shift) that covers the
    SI halo, plus two shifts."""
    halo = max_support - 1 + 2 * shift
    return (-(-halo // shift) + 2) * shift


def inputs() -> dict:
    """The inputs of every case (numpy, seeded), the same at every world
    size up to 4: signal spans and batches divide by 4."""
    import speech_tpu_torch as stt

    rng = np.random.RandomState(20261017)
    shift = 80  # the frame shift of both computers
    support = si_computer(stt, "causal", False).max_support
    out = {}
    out["halo_signal"] = rng.randn(4 * shift * 8)
    out["stft_signal"] = rng.randn(4 * shift * 16)
    out["si_signal"] = rng.randn(4 * si_span(support, shift))
    out["ragged"] = [rng.randn(rng.randint(800, 4000)) for _ in range(11)]
    out["full_batch"] = rng.randn(8, 4096)
    out["int16"] = [(rng.randn(k) * 1000).astype(np.int16) for k in (900, 2048, 3001)]
    out["fine"] = [rng.randn(k) for k in (1100, 2500, 3100)]
    out["iter"] = [[rng.randn(rng.randint(800, 2000)) for _ in range(3)] for _ in range(3)]
    out["stats_feats"] = rng.randn(8, 20, 13)
    out["stats_counts"] = rng.randint(1, 21, size=8)
    t = np.arange(PITCH_RATE // 2) / PITCH_RATE
    pitch = np.stack(
        [np.sin(2 * np.pi * (110.0 + 25.0 * b) * t) + 0.05 * rng.randn(t.size)
         for b in range(PITCH_BATCH)]
    )
    pitch_len = np.full(PITCH_BATCH, t.size, np.int32)
    pitch_len[-1] = t.size // 2  # one padded row exercises masking
    pitch[-1, pitch_len[-1]:] = 0.0
    out["pitch"], out["pitch_lengths"] = pitch, pitch_len
    corpus = rng.randn(8, 2048)
    corpus_len = rng.randint(1024, 2049, size=8).astype(np.int32)
    for i in range(8):
        corpus[i, corpus_len[i]:] = 0.0
    out["corpus"], out["corpus_lengths"] = corpus, corpus_len
    out["post"] = [rng.randn(rng.randint(1100, 2000)) for _ in range(8)]
    out["si_ragged"] = [rng.randn(rng.randint(1100, 2000)) for _ in range(3)]
    out["train"] = rng.randn(4, 1600)
    return out


def _raises(fn, exc=ValueError, match=""):
    try:
        fn()
    except exc as e:
        return int(match in str(e))
    return 0


def _ragged(prefix: str, feats_list) -> dict:
    out = {f"{prefix}_n": np.array([f.shape[0] for f in feats_list])}
    out[prefix] = np.concatenate(feats_list)
    return out


def train_step(x: np.ndarray, device: str = "cpu") -> dict:
    """One SGD step of the STFT frontend (loss: mean squared features) on a
    ``(data, filt)`` mesh: the batch rows over ``data``, the filter
    columns of ``weights`` over ``filt``, the window replicated.  Each rank
    differentiates its part of the loss; the window's gradient sums over
    every rank and the weights' over the data axis.  Returns the loss and
    the updated parameters, gathered whole."""
    import torch
    import torch.distributed as dist

    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par

    mesh = par.make_mesh(("data", "filt"), shape=(-1, 2), devices=device)
    frontend = stt.nn.STFTFrontend(stft_computer(stt, device), dtype=torch.float64)
    n_filt = frontend.weights.shape[1]
    fpos, per = mesh.get_local_rank("filt"), frontend.weights.shape[1] // 2
    cols = slice(fpos * per, (fpos + 1) * per)
    with torch.no_grad():  # this rank's block of the filter columns
        frontend.weights = torch.nn.Parameter(frontend.weights[:, cols].clone())
    rows = par.mesh.local_tensor(x, mesh, "data")
    feats = frontend(rows)
    part = (feats ** 2).sum() / (x.shape[0] * feats.shape[1] * n_filt)
    part.backward()
    loss = part.detach().clone()
    dist.all_reduce(loss)
    dist.all_reduce(frontend.window.grad)
    dist.all_reduce(frontend.weights.grad, group=mesh.get_group("data"))
    torch.optim.SGD(frontend.parameters(), lr=TRAIN_LR).step()
    blocks = [torch.empty_like(frontend.weights) for _ in range(2)]
    dist.all_gather(blocks, frontend.weights.detach().contiguous(), group=mesh.get_group("filt"))
    return {
        "train_loss": _np(loss),
        "train_window": _np(frontend.window),
        "train_weights": _np(torch.cat(blocks, dim=1)),
    }


MODEL_CHANNELS = (16, 16)
MODEL_LR = 1e-2


def model_inputs() -> dict:
    """The inputs of the model and serving cases (numpy, seeded): a batch of
    8 ragged signals with labels, a head for the KWS model, and 4 session
    signals."""
    rng = np.random.RandomState(20261117)
    signals = rng.randn(8, 2400)
    lengths = rng.randint(1200, 2401, size=8)
    for i, n in enumerate(lengths):
        signals[i, n:] = 0.0
    return {
        "signals": signals,
        "lengths": lengths,
        "labels": rng.randint(0, 3, size=8),
        "head": rng.randn(MODEL_CHANNELS[-1], 3),
        "sessions": [rng.randn(rng.randint(1500, 5000)) for _ in range(4)],
    }


def kws_model(device="cpu"):
    """The port's KWS model on the fbank-10 frontend (float64), its head
    set from :func:`model_inputs` so that every layer gets a gradient."""
    import torch

    import speech_tpu_torch as stt

    frontend = stt.nn.STFTFrontend(stft_computer(stt, device), dtype=torch.float64)
    model = stt.models.KWSModel(frontend, num_classes=3, channels=MODEL_CHANNELS,
                                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.classifier.head.w.copy_(torch.tensor(model_inputs()["head"]))
    return model


def models_train_step(world: int, device: str = "cpu") -> dict:
    """One data-parallel SGD step of the KWS model: each rank takes its
    block of the batch's rows, ``make_train_step`` averages the gradients
    over the group.  Returns the initial and the updated parameters (by
    their ``"/"`` keys) and the metrics."""
    import torch
    import torch.distributed as dist

    import speech_tpu_torch as stt

    model = kws_model(device)
    before = {n.replace(".", "/"): _np(p).copy() for n, p in model.named_parameters()}
    x = model_inputs()
    rank, per = dist.get_rank(), x["signals"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    step = stt.models.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=MODEL_LR), group=dist.group.WORLD
    )
    metrics = step(x["signals"][rows], x["lengths"][rows], x["labels"][rows])
    out = {f"before/{k}": v for k, v in before.items()}
    out.update({f"after/{n.replace('.', '/')}": _np(p) for n, p in model.named_parameters()})
    out.update({f"metric/{k}": _np(v) for k, v in metrics.items()})
    return out


def serve_pool(world: int, device: str = "cpu") -> dict:
    """A ``StreamPool`` of 4 slots with its slots over the mesh's data axis:
    every rank drives the same sessions; returns each session's rows."""
    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par

    mesh = par.make_mesh(("data",), devices=device)
    pool = stt.serve.StreamPool(stft_computer(stt, device), slots=4, chunk_size=800, mesh=mesh)
    sigs = model_inputs()["sessions"]
    handles = [pool.open() for _ in sigs]
    got = {h: [] for h in handles}
    for h, s in zip(handles, sigs):
        pool.feed(h, s[: len(s) // 2])
    for h, f in pool.step():
        got[h].append(f)
    for h, s in zip(handles, sigs):
        pool.feed(h, s[len(s) // 2:])
    for h, f in pool.step(max_chunks=8):
        got[h].append(f)
    for h, f in pool.close_many(handles):
        got[h].append(f)
    out = {}
    for i, h in enumerate(handles):
        out[f"session{i}"] = np.concatenate(got[h])
    out["refused"] = np.array(_raises(
        lambda: stt.serve.StreamPool(stft_computer(stt, device), slots=world + 1, mesh=mesh),
        ValueError, "multiple") if world > 1 else 1)
    return out


SERVE_BAD_FRAMES = 29  # the frame count of the request a postprocessor refuses
SERVE_BAD_LEN = 2345  # (2345 + 40) // 80 = 29 frames at the 8 kHz, 10 ms shift


def serve_signals() -> list:
    """The served requests (numpy, seeded): 9 ragged signals, none of
    :data:`SERVE_BAD_FRAMES` frames."""
    rng = np.random.RandomState(20261119)
    out = []
    while len(out) < 9:
        n = int(rng.randint(1100, 4800))
        if (n + 40) // 80 != SERVE_BAD_FRAMES:
            out.append(rng.randn(n))
    return out


def _threaded(submit, signals, threads: int = 3):
    """``signals`` submitted from ``threads`` threads (request ``i`` from
    thread ``i % threads``): their results and exceptions, by request."""
    import threading

    res, errs = [None] * len(signals), [None] * len(signals)

    def client(k):
        futs = [(i, submit(signals[i])) for i in range(k, len(signals), threads)]
        for i, f in futs:
            try:
                res[i] = f.result(timeout=120)
            except Exception as e:  # noqa: BLE001 -- recorded
                errs[i] = e

    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return res, errs


REFUSALS = [0]  # this rank's refused blocks


def _refuse_bad_rows(feats, counts):
    """A postprocessor that raises on a row of :data:`SERVE_BAD_FRAMES`
    frames, on whichever rank holds it (counted in :data:`REFUSALS`)."""
    if bool((counts == SERVE_BAD_FRAMES).any()):
        REFUSALS[0] += 1
        raise ValueError("refused a bad row")
    return feats, counts


def serve_group(world: int, device: str = "cpu") -> dict:
    """``FeatureServer`` and ``StreamServer`` over the mesh, rank 0 the
    front.  Rank 0 warms the feature server up, submits
    :func:`serve_signals` from 3 threads, then (on a server whose
    postprocessor refuses one row) a micro-batch holding the bad request
    and, after it, the rest; then feeds the 4 sessions of
    :func:`model_inputs` in ragged pieces from 4 threads.  The followers
    try the client methods.  Returns the served rows, the failure and
    stats, every rank's count of row blocks run by the first server and of
    blocks refused by the second, and every follower's checks (each 1 when
    it held): its client methods refused naming rank 0, and each server's
    thread ended once rank 0's close reached it."""
    import threading

    import torch.distributed as dist

    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par

    mesh = par.make_mesh(("data",), devices=device)
    comp = stft_computer(stt, device)
    rank = dist.get_rank()
    sigs = serve_signals()
    out, checks = {}, []

    def refused(fn):
        return _raises(fn, RuntimeError, "rank 0")

    runs = [0]
    compute_batch = comp.compute_batch

    def counted(*args, **kw):
        runs[0] += 1
        return compute_batch(*args, **kw)

    comp.compute_batch = counted
    server = stt.serve.FeatureServer(comp, mesh=mesh, max_batch=4, max_wait_ms=20.0)
    if rank == 0:
        server.warmup([len(s) for s in sigs])
        server.warmup([len(sigs[0])], batch=6)  # more rows than one header holds
        res, errs = _threaded(server.submit, sigs)
        assert not any(errs), errs
        out.update(_ragged("served", res))
        out["served_stats"] = np.array([server.stats[k] for k in ("completed", "failed", "batches")])
    else:
        checks += [refused(lambda: server.submit(sigs[0])), refused(lambda: server.extract(sigs[0])),
                   refused(lambda: server.warmup([1000]))]
    server.close()
    checks.append(int(not server._worker.is_alive()))
    comp.compute_batch = compute_batch

    server = stt.serve.FeatureServer(comp, mesh=mesh, max_batch=4, max_wait_ms=200.0,
                                     postprocessors=[_refuse_bad_rows])
    if rank == 0:
        bad = np.random.RandomState(3).randn(SERVE_BAD_LEN)
        first = [sigs[0], sigs[1], bad, sigs[3]]  # one micro-batch: row 2 on rank 2 // (4 // world)
        futs = [server.submit(s) for s in first]
        out["bad_error"] = np.array(_raises(lambda: futs[2].result(timeout=120), ValueError,
                                            "refused a bad row"))
        kept = [f.result(timeout=120) for i, f in enumerate(futs) if i != 2]
        kept += server.extract_many(sigs[4:])
        out.update(_ragged("isolated", kept))
        out["isolated_stats"] = np.array([server.stats[k] for k in ("completed", "failed")])
    server.close()
    checks.append(int(not server._worker.is_alive()))

    sessions = model_inputs()["sessions"]
    streams = stt.serve.StreamServer(comp, slots=4, chunk_size=800, mesh=mesh, max_wait_ms=2.0)
    if rank == 0:
        streams.warmup()
        handles = [streams.open_session() for _ in sessions]

        def feeder(h, sig):
            r = np.random.RandomState(100 + h)
            i = 0
            while i < len(sig):
                n = int(r.randint(200, 1500))
                streams.feed(h, sig[i: i + n])
                i += n
            streams.close_session(h)

        feeders = [threading.Thread(target=feeder, args=(h, s)) for h, s in zip(handles, sessions)]
        for t in feeders:
            t.start()
        got = {h: list(streams.iter_results(h)) for h in handles}
        for t in feeders:
            t.join()
        for i, h in enumerate(handles):
            out[f"stream{i}"] = np.concatenate(got[h])
    else:
        checks += [refused(lambda: streams.open_session()), refused(lambda: streams.feed(0, sigs[0])),
                   refused(lambda: streams.close_session(0)),
                   refused(lambda: next(iter(streams.iter_results(0))))]
    streams.close()
    checks.append(int(not streams._worker.is_alive()))

    every = [None] * world
    dist.all_gather_object(every, (runs[0], REFUSALS[0]))
    out["runs"], out["refusals"] = np.array(every, dtype=np.int64).T
    dist.all_gather_object(every, checks)
    out["follower_checks"] = np.array([c for r in every[1:] for c in r], dtype=np.int64)
    out["front_checks"] = np.array(every[0], dtype=np.int64)
    return out


MAIN_BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
MAIN_KW = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True, precision="double")


def burst_utts(count: int = 256, seconds: int = 15, rate: int = 16000) -> list:
    """``chip_smoke.py``'s serving burst: ``count`` ragged float32
    utterances of 1 to ``seconds`` s from a seed."""
    rng = np.random.RandomState(18)
    return [(rng.randn(rng.randint(rate, seconds * rate + 1)) * 0.1).astype(np.float32)
            for _ in range(count)]


def serve_bench(world: int, device: str = "cuda", count: int = 256, seconds: int = 15) -> dict:
    """``FeatureServer`` at the main config of ``bench.py:117-124``
    ('double': B2 on a card) over the mesh, rank 0 the front: a warm-up
    and one untimed burst of :func:`burst_utts` from 4 threads
    (``max_batch`` 64), then five timed bursts, each burst's host ms;
    every rank's B2 launches over the server's life (counters from 0 at
    its construction) and the front's micro-batches; the last burst's
    rows."""
    import time

    import torch.distributed as dist

    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.ops import stft_kernels as K

    mesh = par.make_mesh(("data",), devices=device)
    comp = stt.compute.STFTFrameComputer(dict(MAIN_BANK), device=device, **MAIN_KW)
    utts = burst_utts(count, seconds)
    out = {}
    K.reset_launch_counts()
    server = stt.serve.FeatureServer(comp, mesh=mesh, max_batch=64, max_wait_ms=2.0)
    if dist.get_rank() == 0:
        server.warmup([seconds * 16000])
        walls = []
        _threaded(server.submit, utts, threads=4)  # the first pays pinned host allocations
        for _ in range(5):
            t0 = time.perf_counter()
            res, errs = _threaded(server.submit, utts, threads=4)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert not any(errs), errs
        out.update(_ragged("bench_rows", res))
        out["bench_ms"] = np.array(walls)
        out["bench_audio_s"] = np.array(sum(u.size for u in utts) / 16000)
        out["bench_batches"] = np.array(server.stats["batches"])
    server.close()
    every = [None] * world
    dist.all_gather_object(every, K.launch_counts()["stft_feats_int8"])
    out["bench_launches"] = np.array(every)
    return out


def relay_feeds(world: int, device: str = "cpu", sessions: int = 16, chunk: int = 1600,
                reps: int = 200) -> dict:
    """How a stream server's commands travel best to the followers, on the
    relay's gloo group: a tick's list of ``sessions`` feeds of ``chunk``
    float32 samples, ``reps`` times as one ``broadcast_object_list`` (what
    ``StreamServer`` sends) and as tensors (an int64 header of every
    command's handle and length, then one float32 buffer of the samples),
    each decoded into numpy feeds on every rank.  Returns the median ms of
    a message, the slowest rank's, for each."""
    import statistics
    import time

    import torch
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.parallel._relay import Relay

    relay = Relay(par.make_mesh(("data",), devices=device))
    ctrl = relay._ctrl
    rng = np.random.RandomState(7)
    cmds = [("feed", h, rng.randn(chunk).astype(np.float32)) for h in range(sessions)]

    def as_objects():
        if relay.front:
            relay.send_obj((cmds, 16))
            return cmds
        return relay.recv_obj()[0]

    def as_tensors():
        head = torch.zeros(2 + 2 * sessions, dtype=torch.int64)
        if relay.front:
            head[:2] = torch.tensor([len(cmds), 16])
            head[2::2] = torch.tensor([h for _, h, _ in cmds])
            head[3::2] = torch.tensor([x.size for _, _, x in cmds])
        dist.broadcast(head, src=0, group=ctrl)
        n, lens = int(head[0]), head[3::2].numpy()
        buf = (torch.from_numpy(np.concatenate([x for _, _, x in cmds])) if relay.front
               else torch.empty(int(lens[:n].sum()), dtype=torch.float32))
        dist.broadcast(buf, src=0, group=ctrl)
        parts = np.split(buf.numpy(), np.cumsum(lens[:n])[:-1])
        return [("feed", int(h), x) for h, x in zip(head[2::2][:n].tolist(), parts)]

    out = {}
    for name, fn in (("objects", as_objects), ("tensors", as_tensors)):
        got = fn()  # warm
        assert all(np.array_equal(a[2], b[2]) for a, b in zip(got, cmds))
        times = []
        for _ in range(reps):
            dist.barrier(group=ctrl)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = torch.tensor([statistics.median(times)], dtype=torch.float64)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=ctrl)
        out[f"feeds_{name}_ms"] = ms.numpy()
    return out


def run_cases(world: int, device: str = "cpu") -> dict:
    """Every multi-rank case of the port at world size ``world`` on
    ``device`` (the process group must be running); returns numpy results,
    every global result gathered whole."""
    import torch

    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.ops import framing as F
    from speech_tpu_torch.parallel import multihost

    x = inputs()
    r = {}
    mesh = par.make_mesh(("data",), devices=device)
    r["mesh_data"] = np.array(par.mesh.axis_size(mesh, "data"))
    r["mesh_error"] = np.array(
        _raises(lambda: par.make_mesh(("data",), shape=(3,), devices=device), match="!= ")
    )
    if world % 2 == 0:
        m2 = par.make_mesh(("data", "filt"), shape=(-1, 2), devices=device)
        r["mesh_2d"] = np.array([par.mesh.axis_size(m2, a) for a in ("data", "filt")])
        r["placements"] = np.array(
            [repr(p) for p in par.named_sharding(m2, None, "filt")]
            + [repr(p) for p in par.named_sharding(m2, "data")]
        )

    comp = stft_computer(stt, device)
    fl, fs = comp.frame_length, comp.frame_shift
    for style in ("causal", "centered"):
        pad_left = F.left_pad_width(style, fl, fs, False)
        frames = par.halo_frame_signal(x["halo_signal"], mesh, "data", fl, fs, pad_left)
        r[f"halo_{style}"] = _np(frames.full_tensor())
    r["halo_error"] = np.array(
        _raises(lambda: par.halo_frame_signal(np.zeros(world * 100), mesh, "data", fl, fs, 0),
                match="frame_length")
    )
    r["stft"] = _np(par.sharded_stft_feats(comp, x["stft_signal"], mesh, "data").full_tensor())
    for style, energy in SI_VARIANTS:
        sc = si_computer(stt, style, energy, device)
        r[f"si_{style}_{int(energy)}"] = (
            _np(par.sharded_si_feats(sc, x["si_signal"], mesh, "data").full_tensor())
        )
    r["si_error"] = np.array(
        _raises(lambda: par.sharded_si_feats(sc, np.zeros(world * 8), mesh, "data"),
                match="halo")
    )

    ex = par.ShardedExtractor(comp, mesh)
    r.update(_ragged("ragged", ex.extract(x["ragged"])))
    lengths = np.full(8, 4096)
    for name, lens in (("full", lengths), ("traced", torch.tensor(lengths))):
        feats, counts = ex.extract_batch(x["full_batch"], lens)
        r[f"{name}_feats"] = _np(feats.full_tensor())
        r[f"{name}_counts"] = _np(counts.full_tensor())
    r["batch_error"] = np.array(
        _raises(lambda: ex.extract_batch(x["full_batch"][:1], np.full(1, 4096)), match="multiple")
        if world > 1 else 1
    )
    got_i = ex.extract(x["int16"])
    got_f = ex.extract([s.astype(np.float64) for s in x["int16"]])
    r["int16_equal"] = np.array(all(np.array_equal(a, b) for a, b in zip(got_i, got_f)))
    r.update(_ragged("int16", got_i))
    mixed = ex.extract([x["int16"][0], x["int16"][1].astype(np.float64)])
    r.update(_ragged("mixed", mixed))
    r.update(_ragged("fine", par.ShardedExtractor(comp, mesh, bucket="fine").extract(x["fine"])))
    for i, out in enumerate(ex.extract_iter(iter(x["iter"]))):
        r.update(_ragged(f"iter{i}", out))
    r.update(_ragged("post", par.ShardedExtractor(
        comp, mesh, postprocessors=post_chain(stt)).extract(x["post"])))
    r.update(_ragged("si_extract", par.ShardedExtractor(
        si_computer(stt, "centered", True, device), mesh).extract(x["si_ragged"])))

    r["stats"] = _np(par.accumulate_stats_sharded(x["stats_feats"], x["stats_counts"], mesh))
    r["stats_onto"] = _np(par.accumulate_stats_sharded(
        x["stats_feats"], x["stats_counts"], mesh, stats=r["stats"]))

    pitch, valid = par.sharded_pitch_feats(x["pitch"], PITCH_RATE, x["pitch_lengths"], mesh)
    r["pitch"], r["pitch_valid"] = _np(pitch.full_tensor()), _np(valid.full_tensor())
    if world > 1:
        r["pitch_error"] = np.array(_raises(
            lambda: par.sharded_pitch_feats(x["pitch"][: world - 1], PITCH_RATE,
                                            x["pitch_lengths"][: world - 1], mesh),
            match="divide"))

    # the multi-process data path: each rank feeds only its own rows
    sl = multihost.process_slice(len(x["corpus"]))
    r["slice"] = np.array([sl.start, sl.stop])
    gsig = multihost.global_batch_from_host_local(x["corpus"][sl], mesh)
    glen = multihost.global_batch_from_host_local(x["corpus_lengths"][sl], mesh)
    r["global_shape"] = np.array(gsig.shape)
    feats, counts = ex.extract_batch(gsig, glen)
    r["mh_feats"] = _np(feats.full_tensor())
    r["mh_counts"] = _np(counts.full_tensor())
    r["mh_stats"] = _np(par.accumulate_stats_sharded(feats, counts, mesh))

    return r


def extract_bench(world: int, device: str = "cuda") -> dict:
    """``ShardedExtractor`` at the main config of ``bench.py:117-124``
    ('double': B2) on a 128 x 15 s global batch of float32 noise that every
    rank holds whole: the ms of one batch (CUDA events after a barrier,
    median of 5, the slowest rank), the B2 launches of one batch summed
    over the ranks, and whether the gathered features equal the whole
    batch's ``compute_batch`` on one card, bit for bit, on every rank."""
    import statistics

    import torch
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.ops import stft_kernels as K

    mesh = par.make_mesh(("data",), devices=device)
    comp = STFTFrameComputer(
        {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}, frame_length_ms=25,
        frame_shift_ms=10, include_energy=True, precision="double", device=device,
    )
    rng = np.random.RandomState(20261016)
    sigs = torch.tensor((rng.randn(128, 15 * 16000) * 0.1).astype(np.float32), device=comp.device)
    full = np.full(128, 15 * 16000)
    ex = par.ShardedExtractor(comp, mesh)
    ex.extract_batch(sigs, full)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    feats, counts = ex.extract_batch(sigs, full)
    torch.cuda.synchronize()
    launches = torch.tensor([K.launch_counts()["stft_feats_int8"]], device=comp.device)
    times = []
    for _ in range(5):
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ex.extract_batch(sigs, full)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = torch.tensor([statistics.median(times)], device=comp.device)
    want, want_n = comp.compute_batch(sigs, full)
    equal = torch.tensor(
        [int(torch.equal(feats.full_tensor(), want) and torch.equal(counts.full_tensor(), want_n))],
        device=comp.device,
    )
    dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    dist.all_reduce(launches)
    dist.all_reduce(equal, op=dist.ReduceOp.MIN)
    return {"bench_ms": _np(ms), "bench_launches": _np(launches), "bench_equal": _np(equal)}


CLI_CFG = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 10, "sampling_rate": 8000},
    "frame_length_ms": 25,
    "frame_shift_ms": 10,
    "dtype": "float64",
}


def pitch_signals() -> list:
    """Two batches of voiced 8 kHz signals for the extractor with pitch:
    ragged, one too short for a pitch frame (under 376 samples)."""
    rng = np.random.RandomState(20261019)

    def voiced(n, f0):
        t = np.arange(n) / PITCH_RATE
        return np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(4 * np.pi * f0 * t) + 0.1 * rng.randn(n)

    lens = [(3000, 5200, 300, 4100, 2600), (6100, 1900, 4500)]
    return [[voiced(n, 90.0 + 7.0 * k) for k, n in enumerate(b)] for b in lens]


def extract_pitch(world: int, device: str = "cpu") -> dict:
    """``ShardedExtractor(pitch={})`` on the mesh over two batches of
    :func:`pitch_signals` (``min_batch`` 8, so every rank gets rows of
    batch padding): every row, and this rank's (rank 0's) stats."""
    import speech_tpu_torch as stt
    from speech_tpu_torch import parallel as par

    mesh = par.make_mesh(("data",), devices=device)
    ex = par.ShardedExtractor(stft_computer(stt, device), mesh, pitch={})
    out = {}
    for b, rows in enumerate(ex.extract_iter(pitch_signals(), min_batch=8)):
        out.update(_ragged(f"pitch{b}", rows))
    out["stats"] = np.array([ex.stats[k] for k in ("rows", "pitch_frames", "pitch_valid_frames")])
    return out


def write_cli_corpus(directory: str) -> str:
    """Eleven random 16-bit wavs of 0.2-1 s at 8 kHz (seeded) in
    ``directory`` and their ``<utt> <path>`` map; returns the map's path."""
    import wave

    rng = np.random.RandomState(20261017)
    os.makedirs(directory, exist_ok=True)
    map_path = os.path.join(directory, "map.txt")
    with open(map_path, "w") as mf:
        for i in range(11):
            path = os.path.join(directory, f"utt{i:02d}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(8000)
                w.writeframes((rng.randn(rng.randint(1600, 8000)) * 1000).astype(np.int16).tobytes())
            mf.write(f"utt{i:02d} {path}\n")
    return map_path


def cli_extract(world: int, device: str = "cpu") -> dict:
    """``signals-to-torch-feat-dir`` (:data:`CLI_CFG`, batches of 4) with
    every rank of the group running the command on the same map, each into
    a directory and manifest of its own: every rank's return code, rank 0's
    files in name order (their frame counts and rows), and how many files
    and manifest lines the other ranks wrote."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from speech_tpu_torch import command_line

    rank = dist.get_rank()
    tmp = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    tmp = tmp[0]
    if rank == 0:
        write_cli_corpus(os.path.join(tmp, "corpus"))
    dist.barrier()
    out = os.path.join(tmp, f"out{rank}")
    manifest = os.path.join(tmp, f"manifest{rank}")
    rc = command_line.signals_to_torch_feat_dir(
        [os.path.join(tmp, "corpus", "map.txt"), json.dumps({**CLI_CFG, "device": device}), out,
         "--batch-size", "4", "--manifest", manifest]
    )
    rcs = [None] * world
    dist.all_gather_object(rcs, rc)
    dist.barrier()
    r = {}
    if rank == 0:
        names = sorted(os.listdir(out))
        feats = [torch.load(os.path.join(out, n)).numpy() for n in names]
        r = {"rcs": np.array(rcs), "names": np.array(names),
             "frames": np.array([f.shape[0] for f in feats]), "feats": np.concatenate(feats)}
        others = 0
        for other in range(1, world):
            others += len(os.listdir(os.path.join(tmp, f"out{other}")))
            with open(os.path.join(tmp, f"manifest{other}")) as f:
                others += sum(1 for line in f if line.strip())
        r["others_wrote"] = np.array(others)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(tmp)
    return r


def launch(world: int, out_dir, cases: str = "parallel", device: str = "cpu",
           strict: bool = True):
    """Start one process a rank of this script at world size ``world``
    (``strict``: warnings are errors, as under pytest); returns
    (processes, result path)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(HERE), HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"  # the ranks share the cores
    out = os.path.join(out_dir, f"{cases}-{device}-world{world}.npz")
    store = os.path.join(out_dir, f"store-{cases}-{device}-{world}")
    worker = os.path.join(HERE, "torch_dist_worker.py")
    warn = ["-W", "error"] if strict else []
    procs = [
        subprocess.Popen(
            [sys.executable, *warn, worker, str(rank), str(world), store, out, cases, device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    return procs, out


def wait(procs, out):
    """Wait for a :func:`launch`; its results, or the failed rank's log."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"[rank {rank}] OK" in log
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


CASES = {
    "parallel": run_cases,
    "train": lambda world, device: train_step(inputs()["train"], device),
    "models_train": models_train_step,
    "serve_pool": serve_pool,
    "serve_group": serve_group,
    "serve_bench": serve_bench,
    "relay_feeds": relay_feeds,
    "cli": cli_extract,
    "bench": extract_bench,
    "extract_pitch": extract_pitch,
}


def main(rank: int, world: int, store_path: str, out_path: str, cases: str,
         device: str) -> None:
    import torch.distributed as dist

    from speech_tpu_torch.parallel import multihost

    multihost.initialize(
        store=dist.FileStore(store_path, world),
        num_processes=world,
        process_id=rank,
        backend="gloo" if device == "cpu" else "nccl",
    )
    try:
        results = CASES[cases](world, device)
        if rank == 0:
            np.savez(out_path, **results)
    finally:
        dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
         sys.argv[6] if len(sys.argv) > 6 else "cpu")
