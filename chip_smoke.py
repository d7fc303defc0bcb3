"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero):

1. build the hand-written kernels from ``speech_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build seconds;
2. print the card's name and power limit (``nvidia-smi``);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (128 x 15 s at 16 kHz; the fbank 40 config of
   ``bench.py``) and time both with CUDA events; the float kernel (B1,
   B3) at 'highest' within TOL_FLOAT, and B1 also at 'default' within
   TOL_DEFAULT; the packed batch's row layout (``layout_rows``) at the
   corpus shapes (64 rows of 2-20 s of int16 PCM, packed by
   ``ShardedExtractor._pack_rows``) bit for bit against its plain version
   and against the extractor's host padding (``_pad_rows``);
4. drive ``stft_feats_double`` (the base-256 digit kernel, B4, which no
   computer route runs) at 128 x 15 s for 'double' and 'accurate', with
   its launch counter set to 0 before and read after; then B4 on banks of
   370 and 512 filters (filter groups, one grid slice each) against its
   plain version;
5. drive the main path, ``STFTFrameComputer.compute_batch`` on 128 x 15 s,
   for every tier (and the ragged, int16 and 10.25 ms-shift variants),
   with every launch counter set to 0 before and read after: each kernel
   of that path must have been launched;
6. drive the full chain of ``bench.py:514-539`` on 128 x 15 s (dither +
   preemphasis, ``compute_batch`` at 'double', deltas, standardization,
   stacking), counters again from 0, and hold it against the same chain
   on the plain 'highest' path with the same noise;
7. hold 'double' on the card against a float64 CPU run of the port on
   ``tests/audio/test.wav``;
8. short integration: ``ShortIntegrationFrameComputer.compute_batch`` at
   ``bench.py``'s width (32 x 10 s, gammatone-40 and gabor-40, mel scale,
   10 ms shift, energy, float32), 'highest' for both banks and 'double'
   and 'accurate' for gammatone, timed; each tier on ``test.wav`` against
   a float64 CPU run of the port;
9. PLP and VADTrim through ``device_post_chain`` on the card against the
   same chain on the CPU;
10. pitch at ``bench.py``'s width (``pitch_feats`` on 32 x 10 s of the
    tones ``bench.py:310-320`` builds), timed, against a float64 CPU run of
    the port, its one Viterbi kernel launch counted; then the pitch cell's
    path (``pitch_extractor_phase``: ``ShardedExtractor(pitch=)`` on 64
    voiced utterances of 2-20 s at 418 lags, host lengths bounding the
    Viterbi and freezing the shorter rows) with the kernel against the same
    batch on the Viterbi's loops, bit for bit, one launch a batch; then the
    kernel alone at the cell's shape (``viterbi_phase``: 64 rows x 1,965
    steps x 418 lags) against its loops, bit for bit and timed;
11. resampling (16 to 8 kHz), speed perturbation (0.9, 1.1),
    reverberation (a 0.3 s RIR) and noise at 10 dB on 128 x 15 s, timed,
    each against a float64 CPU run of the port;
12. ``feats_to_signal`` on 8 x 5 s of 'highest' features (64 iterations),
    timed, and at 4 iterations against a float64 CPU run;
13. the file path: ``read_signal`` on ``tests/audio`` (every ``.sph``
    bit-equal to its ``.wav`` twin), statistics written to a ``.npy`` and
    read back by ``Standardize(rfilename=)``, then preemphasis,
    ``compute_batch`` at 'double' and standardization on the card, bitwise
    equal to the same chain on the arrays held in memory;
14. streaming at ``bench.py``'s widths (``bench.py:438-512``): the STFT
    stream (the fbank-40 config, chunk 1600), the SI stream (gammatone-40
    'highest') and the pitch stream (``bench.py``'s tones, lookahead 50):
    the latency of one 100 ms chunk read back every tick, the amortised ms
    of a chunk over 50 ticks, and 16 sessions x 64 chunks (6.4 s each) in
    one wide call on the stream axis, each held against its batch path on
    the card (STFT and SI within 1e-4; pitch f0 within rtol 1e-3 on 99% of
    the batch's voiced frames); SI 'double' on 2 x 3 s of ``test.wav``
    against float64 on the CPU; a 60 s pitch session in float32 against
    float64 on the card; the post pipeline (deltas, sliding CMVN, stack)
    in float64 against the batch ops within 1e-9, and timed in float32.
    Every timed tick runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a host synchronisation inside a tick fails the run; the profiler
    counts a wide tick's kernel launches and their device time;
15. multi-device (``speech_tpu_torch.parallel``) on a one-card NCCL process
    group (world size 1: NCCL refuses two ranks on one card, so the
    multi-rank paths are held by the CPU gloo tests): ``ShardedExtractor``
    at the main config ('double', auto route: B2) on 128 x 15 s, bitwise
    equal to ``compute_batch`` with one B2 launch a batch, and its B1 and
    B3 routes (``fft_mode="pallas"``, 10 and 10.25 ms shifts) likewise;
    ``extract`` on 64 ragged utterances of 1-15 s with "pow2" and "fine"
    buckets, and ``extract_iter`` over 8 batches of 32 ragged utterances,
    each row within TOL_INT8 of that utterance alone on the plain digit
    route (``fft_mode="matmul"``, no kernel); ``extract_iter`` double
    buffered and not, with the device's idle share from ``torch.profiler``
    and its dispatch under ``set_sync_debug_mode("error")``;
    ``accumulate_stats_sharded``; the halo paths on one 10-minute signal;
    ``sharded_pitch_feats`` on ``bench.py``'s 32 x 10 s tones;
16. the learnable frontends (``speech_tpu_torch.nn``) at ``bench.py``'s
    widths on 32 x 10 s: ``STFTFrontend`` of the main config against the
    computer's plain 'highest' path, and the ms of one forward + backward
    + SGD step; ``GaborFrontend``-40 and ``SincFrontend``-40 forward and
    forward + backward; ``PCEN`` on the linear fbank; then the trained
    frontend's ``export_computer`` at 'double', which launches B2 once,
    equals bit for bit the export of a fresh frontend holding the same
    parameters, and leaves the original computer's features unchanged;
17. the model families (``speech_tpu_torch.models``) at the JAX package's
    default widths: ``KWSModel`` on the main config's ``STFTFrontend``
    (channels 64, 64; 10 classes; 32 x 1 s), ``SpeakerModel`` (TDNN 128,
    128, 128; embedding 192; 32 x 3 s) and ``CTCModel`` (model 128, 2
    layers, 4 heads, FFN 512, vocabulary 28; 16 x 10 s): forward and
    Adam ``make_train_step`` ms, the loss finite and lower after 4 steps,
    one step traced (kernels, device busy of its wall), the card's float32
    forward on 2 rows against the same parameters' float64 forward on the
    CPU (features, logits, embeddings and log probabilities within
    TOL_FLOAT; CTC's per-example loss within rtol TOL_FLOAT), and
    ``make_train_step``'s gradients on those rows against float64's with
    the card forward's ReLU pattern (within TOL_GRAD of each tensor's
    largest; the same backward with TF32 allowed printed beside them); the CTC loss's recursion alone,
    timed and traced; ``StreamingKWS`` with 16 sessions in a ``StreamPool``
    (ticks under ``set_sync_debug_mode("error")``, the close rows against
    the model on the whole signal within TOL_FLOAT); a ``TrainCheckpointer``
    round trip, bitwise; the flagship preset at 'double' through B2;
18. serving (``speech_tpu_torch.serve``): ``FeatureServer`` on the main
    config at 'double' (auto: B2) with four client threads submitting 256
    ragged utterances of 1-15 s, each result within TOL_INT8 of that
    utterance alone on the plain digit route, one B2 launch per
    micro-batch (counted over a third, untraced burst) and no failed
    request; its throughput, the p50/p99 latency of a lone request; the
    first two bursts traced, each with its device busy ms and idle share
    of its own wall time (``torch.profiler``) and the dispatcher's host
    calls timed; ``StreamServer`` with 16 threaded sessions of
    ``StreamingSTFT`` against ``compute_full`` within TOL_FLOAT;
19. the corpus CLIs (``speech_tpu_torch.command_line.main``, in process)
    on 256 ragged 1-15 s int16 wav files at 16 kHz with silent gaps:
    ``signals-to-torch-feat-dir`` at the main config's 'double' (B2, one
    launch a batch of 64) with ``--num-workers 4 --profile DIR``, each file
    within TOL_INT8 of its utterance alone on the plain digit route, with
    its audio-s/s from files to files, its stage split and the device's
    busy ms and idle share from the trace, then untraced; at
    ``fft_mode="pallas"`` (B1) with deltas and ``--vad-trim '{}'``
    against the same command on the plain path within TOL_FLOAT;
    ``compute-feats-from-kaldi-tables`` from a ``scp`` of the same files,
    bitwise equal to the ``.pt`` files, and ``copy-feats-tables`` ark ->
    dir -> ark bitwise; ``torch-feat-dir-to-signals`` on 8 of the files
    (4 iterations), its wavs bitwise equal to ``feats_to_signal`` (which
    phase 12 holds against float64) on the same batches, rounded, and
    their distance from float64 ``feats_to_signal`` on the CPU printed, as
    phase 12 prints its float32 one; and
    ``FeatureCorpus`` at 'double' bitwise equal to the files, which its
    feature-file mode reads back bitwise;
20. the library store (``speech_tpu_torch.aot``): a fresh process
    (``chip_smoke.py --cold-start-child``) on an empty store with nvcc and
    g++ reachable builds the five kernel libraries and shorten (each
    build's seconds; stats: 6 misses, 0 hits) and runs the main path's
    batch through ``ShardedExtractor(aot_dir=)`` at 'double' (B2) and
    ``fft_mode="pallas"`` (B1), reads a ``.sph`` file and answers a
    ``FeatureServer(aot_dir=)`` burst of 16 requests: its seconds from
    the spawn to its first feature are the cold start; the same process
    on that store with ``PATH`` and ``CUDA_HOME`` an empty directory (no
    compiler: any build would raise) is the warm start (0 misses, 0
    errors, 0 fallbacks, 6 hits); both children's features are bitwise
    equal to this process's on the same routes and batch.  Then phase
    19's 'double' command with ``--precompile --aot-dir``, its run in a
    fresh process with no compiler (files bitwise equal to phase 19's),
    and ``--aot-prune`` on a planted orphan;
21. the compatibility layer (``speech_tpu_torch.torch``) on the card:
    ``PyTorchSTFTFrameComputer`` of the main config on one 15 s signal
    within TOL_FLOAT of ``compute_full``, with finite gradients for its
    window and weights; ``PyTorchSIFrameComputer`` of gammatone-40 within
    TOL_FLOAT of the SI computer; ``log32`` within 2 ulp of ``torch.log``
    over [1e-6, 1e6].  ``speech_tpu_torch.vis`` is not run (the machine has
    no matplotlib);
22. serving on a group (``speech_tpu_torch.serve`` on a world-size-1 NCCL
    mesh, where rank 0 is the front and the relay runs end to end: each
    micro-batch's header, its rows scattered to the front itself, its run,
    its features gathered back): ``FeatureServer`` at 'double' (B2) and
    the meshless server on the same card take phase 18's burst in turns
    ((meshless, group, group, meshless) x 2, after a warm-up and a first
    burst each), each row within TOL_INT8 of its utterance alone on the
    plain digit route, their ms and audio-s/s, the dispatcher's host calls
    and the relay's own calls printed side by side (the relay's cost); a
    last, counted group burst launches B2 once a micro-batch; then
    ``StreamServer`` with 16 threaded sessions on the group and without
    a mesh, rows against ``compute_full`` within TOL_FLOAT;
23. print the kernels line and, last, the device line.

Every launch counter is set to 0 just before each driven path (phases 5,
15, 16, 17, 18, 19, 20 and 22) and read just after; the kernels line's
launches are their sums.

B2 and B4 also run on banks wider than one filter group (phases 3-4):
B2 at 1,489 and 2,978 filters, both tiers, on 16 x 15 s.

It imports torch, numpy and ``speech_tpu_torch`` only.
"""

import atexit
import contextlib
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import wave

import numpy as np

# published H100 SXM peaks, dense (NVIDIA data sheet), at a 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
MAIN = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True, dtype="float32")
BATCH, SECONDS, RATE = 128, 15, 16000
LOG_SPEC = dict(use_log=True, use_power=False, include_energy=True, log_floor=1e-5)
TOL_FLOAT = 1e-4  # f32 reduction order (tests/test_pallas.py:55)
TOL_DEFAULT = 1.5e-2  # the reduced float tier (pallas_stft.py:23-27)
TOL_INT8 = 2e-6  # the digit tiers' exactness class (tests/test_pallas.py:175)
TOL_F64 = 1e-5  # 'double' vs float64 on speech (tests/test_pallas.py:250)
# the chain on B2 vs on the plain 'highest' path: features within the float
# tier's 1e-4, then float32 standardization scales each coefficient by
# 1/std (std >= ~0.1 on the deltas)
TOL_CHAIN = 1e-3
# SI 'highest' on the card (IEEE fp32 products, cuBLAS) vs float64 on
# speech: the float tiers' 1e-4 (tests/test_pallas.py:55); the reference
# measures its own fp32 SI conv at ~2e-5 on gammatone (compute.py:899-903)
TOL_SI_FLOAT = 1e-4
SI_BANKS = {
    name: {"name": name, "scaling_function": "mel", "num_filts": 40, "sampling_rate": 16000}
    for name in ("gammatone", "gabor")
}
SI_BATCH, SI_SECONDS = 32, 10
PITCH_BATCH, PITCH_SECONDS = 32, 10  # bench.py:185 (_pitch_throughput)
TOL_PITCH = 1e-3  # f0 (relative) on voiced frames and the POV column
TOL_SIGNAL = 1e-5  # float32 vs float64 signal ops (tests/test_resample.py:44)
# feats_to_signal, 4 iterations, the card's float64 run vs the CPU's; in
# float32 Griffin-Lim's phase projections amplify rounding past 1e-4 (on
# the CPU too), so the float32 difference is printed beside it
TOL_INVERT = 1e-4
INT8_WIDE = (1489, 2978)  # one filter past B2's one-group limit, and twice it
CPU_ROWS = 8  # rows the float64 CPU references of phase 11 compute
SOURCE = "speech_tpu_torch/csrc/stft_kernels.cu"  # B1, B3
INT8_SOURCE = "speech_tpu_torch/csrc/int8_kernels.cu"  # B2
LAYOUT_SOURCE = "speech_tpu_torch/csrc/layout_kernels.cu"  # the packed batch's rows
DOUBLE_SOURCE = "speech_tpu_torch/csrc/double_kernels.cu"  # B4
VITERBI_SOURCE = "speech_tpu_torch/csrc/viterbi_kernels.cu"  # the pitch tracker's Viterbi
COMPUTE_PATH = ("stft_feats_rows", "stft_feats_frames", "stft_feats_int8")
# streaming (bench.py:438-512): 100 ms chunks; 16 sessions x 64 chunks in
# one wide call; 50 ticks for the per-chunk times
STREAM_CHUNK, STREAM_SESSIONS, STREAM_DEPTH, STREAM_TICKS = 1600, 16, 64, 50
TOL_PIPE = 1e-9  # the float64 pipeline vs the batch ops (sums re-associated)
# make_train_step's float32 gradients vs float64, relative to each tensor's
# largest: the float tier's 1e-4 (TF32 keeps about three decimal digits)
TOL_GRAD = 1e-4
PITCH_LONG_SECONDS = 60
# the pitch cell's Viterbi: 64 rows, 1,965 steps (its batches' longest
# tracked row), 418 lags (ESPnet's lag_resolution 0.005 at 4 kHz)
VITERBI_ROWS, VITERBI_STEPS, VITERBI_LAGS = 64, 1965, 418
HALO_SECONDS = 600  # phase 15's one long signal
CLI_UTTS, CLI_BATCH = 256, 64  # phase 19's corpus of files and its batches


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn`` on the card by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, n=20, reps=5):
    """Median device milliseconds a call of ``fn`` by CUDA events around
    ``n`` calls queued behind a busy card (``torch.cuda._sleep``), so that
    the host's launch overhead stays out of a kernel shorter than it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)  # tens of ms: the host queues all n meanwhile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound_ms(entry):
    """The least time for an entry's work: the larger of its operations
    over their peak rates and its bytes over the memory rate; and which."""
    t_ops = sum(ops / peak for ops, peak in entry["ops"]) * 1e3
    t_bytes = entry["nbytes"] / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


@contextlib.contextmanager
def no_sync():
    """Fail on any host synchronisation inside the block."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def wall_ms(fn, reps=3):
    """Median host milliseconds of ``fn()`` up to the card's last kernel
    (a warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def driven(counted, fn):
    """``fn()`` with the kernels' launch counters set to 0 just before and
    read just after; adds its launches to ``counted`` and returns
    (result, its launches)."""
    import torch

    from speech_tpu_torch.ops import stft_kernels as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = K.launch_counts()
    for name, count in got.items():
        counted[name] = counted.get(name, 0) + count
    return out, got


def traced(fn, top=6):
    """``fn()`` under the profiler, timed on the host's clock up to the
    card's last kernel: ``(result, its kernel launches, their summed device
    ms, the wall ms, the ``top`` kernels and the ``top`` host events (CUDA
    runtime calls of every thread included) by their ms)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device, host = {}, {}
    n_kernels = 0
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            device[e.name] = device.get(e.name, 0.0) + ms
        else:
            host[e.name] = host.get(e.name, 0.0) + ms
    busy = sum(device.values())

    def ranked(by_name):
        names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [(n[:48], round(ms, 3)) for n, ms in names]

    return out, n_kernels, busy, wall, ranked(device), ranked(host)


def kernel_split(fn, top=6):
    """``fn()`` under the profiler: its kernel launches, their summed
    device ms, and the ``top`` kernel names by device time."""
    _, n_kernels, busy, _, top_kernels, _ = traced(fn, top)
    return n_kernels, busy, top_kernels


def tick_ms(stream, chunk):
    """(latency, amortised) ms of one chunk a tick over STREAM_TICKS ticks
    of one session: read back every tick, then once at the end."""
    import torch

    state = stream.init_state()
    state, feats, n = stream._process_impl(state, chunk, chunk.shape[-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STREAM_TICKS):
        with no_sync():
            state, feats, n = stream._process_impl(state, chunk, chunk.shape[-1])
        feats.reshape(-1)[:1].cpu(), n.cpu()  # the round trip a server pays
    latency = (time.perf_counter() - t0) / STREAM_TICKS * 1e3
    t0 = time.perf_counter()
    with no_sync():
        for _ in range(STREAM_TICKS):
            state, feats, n = stream._process_impl(state, chunk, chunk.shape[-1])
    feats.reshape(-1)[:1].cpu()
    return latency, (time.perf_counter() - t0) / STREAM_TICKS * 1e3


def wide_call(stream):
    """A streamer's call for a buffer of many chunks: ``process_wide``
    where it has one (STFT, SI), else the contract's ``_process_impl``
    (pitch takes any multiple of its chunk; the pipeline)."""
    return getattr(stream, "process_wide", stream._process_impl)


def streamed_rows(stream, sigs):
    """Every session of ``sigs (S, W)`` in one wide call, then finalize:
    per session its valid rows (a list of tensors on the card)."""
    import torch

    state = stream.init_state(streams=sigs.shape[0])
    with no_sync():
        state, feats, n = wide_call(stream)(state, sigs, sigs.shape[-1])
    fin, fin_n = stream._finalize_impl(state)
    return [torch.cat([feats[s, : int(n[s])], fin[s, : int(fin_n[s])]])
            for s in range(sigs.shape[0])]


def read_wav(path):
    with wave.open(path) as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            fail(f"{path}: expected 16-bit mono PCM")
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32768.0


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    import speech_tpu_torch  # noqa: F401  (the checkout's own package)
    from speech_tpu_torch import pre
    from speech_tpu_torch import post
    from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
    from speech_tpu_torch.io import read_signal
    from speech_tpu_torch.ops import _build
    from speech_tpu_torch.ops import augment
    from speech_tpu_torch.ops import framing as F
    from speech_tpu_torch.ops import invert
    from speech_tpu_torch.ops import pitch
    from speech_tpu_torch.ops import postops
    from speech_tpu_torch.ops import resample
    from speech_tpu_torch.ops import stft_kernels as K
    from speech_tpu_torch.ops.vad import energy_vad

    # the CLIs move the process's default library store to
    # $TORCH_EXTENSIONS_DIR/speech_tpu_torch: keep it in this run's
    # temporary directory (phases 19-20 write their corpus and stores there)
    run_dir = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, run_dir, ignore_errors=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(run_dir, "torch_extensions")

    # 1. build
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    rng = np.random.RandomState(20261016)
    n = SECONDS * RATE
    host = rng.randn(BATCH, n).astype(np.float32) * 0.1
    sigs = torch.tensor(host, device=dev)
    full = np.full(BATCH, n)

    # 3. kernels against their plain versions, at the main path's shapes
    entries = {}

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    def bytes_of(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    c = computer(fft_mode="pallas")
    fl, fs = c.frame_length, c.frame_shift
    padded = F.pad_signal_full(sigs, fl, c._pad_left)
    mf = F.frame_count_np(n, fl, fs)
    half, nf = c.params["dft_cos"].shape[1], c.params["weights"].shape[1]
    consts = (c.params["dft_cos"], c.params["dft_sin"], c.params["weights"])
    # bins with a (cos, sin) column pair in the float kernel's layout
    nb_f = K._float_nb(c.params["dft_cos"], c.params["dft_sin"])
    rows_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, **LOG_SPEC)
    frames_total = BATCH * mf

    def filter_terms(params):
        """Weight terms of the float kernel's filter sums a frame: each
        filter's span of nonzero rows below ``nb_f`` (the terms outside are
        exact zeros, which it skips) and the Nyquist row, rank 1, where there
        is one."""
        spans = K._filter_spans(params["weights"])
        rows = (spans[:, 1].clamp(max=nb_f) - spans[:, 0]).clamp(min=0).sum().item()
        return rows + (nf if nb_f < half else 0)

    def float_ops(frames, passes, params):
        """The float kernel's work by the unit that runs it: ``passes`` TF32
        DFT products on the tensor cores, the fp32 filter sums on the CUDA
        cores."""
        return [(passes * 2 * frames * fl * 2 * nb_f, PEAK_TF32_FLOPS),
                (2 * frames * filter_terms(params), PEAK_FP32_FLOPS)]

    def digit_tail_terms(params, prefix):
        """Weight terms of a digit kernel's filter sums a frame: w_hi and
        w_lo over each filter's span of nonzero rows of either (the terms
        outside are exact zeros, which it skips) and the rank-1 Nyquist
        term."""
        spans = K._filter_spans(params[prefix + "w_hi"], params[prefix + "w_lo"])
        rows = (spans[:, 1] - spans[:, 0]).clamp(min=0).sum().item()
        return 2 * rows + nf

    def fma_bound_ms(frames):
        """The bound the fp32-FMA kernel was held to before: both DFT
        products and the filter product at the fp32 rate."""
        return 2 * frames * (2 * fl * half + half * nf) / PEAK_FP32_FLOPS * 1e3

    want = K.stft_feats_rows_plain(padded, c.params, **rows_kw)
    plain_rows_ms = cuda_ms(lambda: K.stft_feats_rows_plain(padded, c.params, **rows_kw))
    for precision, tol in (("highest", TOL_FLOAT), ("default", TOL_DEFAULT)):
        got = K.stft_feats_rows(padded, c.params, precision=precision, **rows_kw)
        entry = dict(
            replaces="speech_tpu/ops/pallas_stft.py:850 stft_feats_pallas (_rows_kernel :159)",
            err=(got - want).abs().max().item(), tol=tol,
            ms=cuda_ms(lambda: K.stft_feats_rows(padded, c.params, precision=precision, **rows_kw)),
            plain_ms=plain_rows_ms,
            ops=float_ops(frames_total, 3 if precision == "highest" else 1, c.params),
            nbytes=bytes_of(padded, got, *consts),
        )
        bound, _ = bound_ms(entry)
        print(f"stft_feats_rows [{precision}] vs plain: max abs {entry['err']:.3e} (tol {tol:g}); "
              f"{entry['ms']:.3f} ms, plain {plain_rows_ms:.3f} ms, bound {bound:.3f} ms "
              f"({100 * bound / entry['ms']:.1f}%), fp32-FMA bound {fma_bound_ms(frames_total):.3f} ms",
              flush=True)
        check(entry["err"] <= tol, f"stft_feats_rows [{precision}] disagrees with its plain version")
        if precision == "highest":
            entries["stft_feats_rows"] = entry
        del got
    del want

    c3 = computer(fft_mode="pallas", frame_shift_ms=10.25)  # shift 164: B3
    fs3 = c3.frame_shift
    mf3 = F.frame_count_np(n, fl, fs3)
    frames3 = F.frame_padded(F.pad_signal_full(sigs, fl, c3._pad_left), mf3, fl, fs3).contiguous()
    got = K.stft_feats_frames(frames3, c3.params, **LOG_SPEC)
    want = K.stft_feats_frames_plain(frames3, c3.params, **LOG_SPEC)
    entries["stft_feats_frames"] = dict(
        replaces="speech_tpu/ops/pallas_stft.py:246 stft_feats_pallas_from_frames (_frames_kernel :208)",
        err=(got - want).abs().max().item(), tol=TOL_FLOAT,
        ms=cuda_ms(lambda: K.stft_feats_frames(frames3, c3.params, **LOG_SPEC)),
        plain_ms=cuda_ms(lambda: K.stft_feats_frames_plain(frames3, c3.params, **LOG_SPEC)),
        ops=float_ops(BATCH * mf3, 3, c3.params),
        nbytes=bytes_of(frames3, got, *consts),
    )
    e3 = entries["stft_feats_frames"]
    bound, _ = bound_ms(e3)
    print(f"stft_feats_frames [highest]: {e3['ms']:.3f} ms, bound {bound:.3f} ms "
          f"({100 * bound / e3['ms']:.1f}%), fp32-FMA bound {fma_bound_ms(BATCH * mf3):.3f} ms",
          flush=True)
    del got, want, frames3

    int8_ms = {}
    for precision in ("double", "accurate"):
        ci = computer(precision=precision)
        p = ci.params
        i8_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, dft_size=ci.dft_size, **LOG_SPEC)
        got = K.stft_feats_int8(padded, p, **i8_kw)
        want = K.stft_feats_int8_plain(padded, p, **i8_kw)
        err = (got - want).abs().max().item()
        print(f"stft_feats_int8 [{precision}] vs plain: max abs {err:.3e}", flush=True)
        check(err <= TOL_INT8, f"stft_feats_int8 [{precision}] disagrees with its plain version: {err}")
        int8_ms[precision] = cuda_ms(lambda: K.stft_feats_int8(padded, p, **i8_kw))
        # the tier's own pairs: 19 for 'double', 15 for 'accurate'
        n_pairs = sum(len(xs) for _, xs, _, _ in p["i8k_offsets"])
        nb = p["i8k_mask"].shape[0]
        tail = [p["i8k_" + k] for k in ("gmats", "mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")]
        entry = dict(
            replaces="speech_tpu/ops/pallas_stft.py:703 stft_feats_pallas_int8 (_int8_rows_kernel :573)",
            err=err, tol=TOL_INT8, ms=int8_ms[precision],
            ops=[
                (2 * frames_total * fl * 2 * nb * n_pairs, PEAK_INT8_OPS),
                (2 * frames_total * digit_tail_terms(p, "i8k_"), PEAK_FP32_FLOPS),
            ],
            nbytes=bytes_of(padded, got, *tail), source=INT8_SOURCE,
        )
        bound, _ = bound_ms(entry)
        # the count before the tail went over the spans: w_hi and w_lo dense
        dense, _ = bound_ms({**entry, "ops": [entry["ops"][0],
                                              (2 * frames_total * nb * nf * 2, PEAK_FP32_FLOPS)]})
        print(f"stft_feats_int8 [{precision}]: {int8_ms[precision]:.3f} ms, {n_pairs} pairs, "
              f"bound {bound:.3f} ms (dense tail: {dense:.3f}), "
              f"{100 * bound / int8_ms[precision]:.1f}% of bound", flush=True)
        if precision == "double":
            entry["plain_ms"] = cuda_ms(lambda: K.stft_feats_int8_plain(padded, p, **i8_kw), reps=3)
            entries["stft_feats_int8"] = entry
        del got, want

    # the packed batch's row layout at the corpus cell's shapes: 64 rows of
    # 2-20 s of 16 kHz int16 PCM (a 524,288 bucket), packed by the
    # extractor; the kernel's block against its plain version and against
    # the extractor's host padding, bit for bit
    from speech_tpu_torch import parallel as par

    lay_rng = np.random.RandomState(18)
    lay_ex = par.ShardedExtractor(computer(precision="double"))
    check(lay_ex._packs, "the extractor does not pack on the card")
    pcm16 = [lay_rng.randint(-32768, 32768, size=k).astype(np.int16)
             for k in lay_rng.randint(2 * RATE, 20 * RATE + 1, size=64)]
    lay_lens, lay_max, lay_dtype = lay_ex._host_batch(pcm16, 64)
    buf, table = lay_ex._pack_rows(pcm16, lay_lens, lay_dtype, 0, 64)
    lay_packed, lay_table = buf.to(dev), table.to(dev)
    lay_args = (lay_packed, lay_table[1], lay_table[2], lay_max)
    got = K.layout_rows(*lay_args)
    want = K.layout_rows_plain(*lay_args)
    padded_host = lay_ex._pad_rows(pcm16, lay_lens, lay_max, lay_dtype, 0, 64).to(dev)
    err = max((got.int() - w.int()).abs().max().item() for w in (want, padded_host))
    real = int(table[2].sum())
    entries["layout_rows"] = dict(
        replaces="none: the JAX package pads on the host (speech_tpu/parallel/extract.py:381 "
                 "ShardedExtractor._dispatch)",
        err=err, tol=0, ms=queued_ms(lambda: K.layout_rows(*lay_args)),
        plain_ms=cuda_ms(lambda: K.layout_rows_plain(*lay_args), reps=3), ops=[],
        nbytes=real * 2 + bytes_of(got, lay_table[1:]), source=LAYOUT_SOURCE,
    )
    e = entries["layout_rows"]
    bound, _ = bound_ms(e)
    print(f"layout_rows at the corpus shapes (64 x {lay_max} {lay_dtype}, {real * 2 / 1e6:.1f} MB "
          f"packed): bitwise equal to layout_rows_plain and to _pad_rows: "
          f"{torch.equal(got, want) and torch.equal(got, padded_host)}; {e['ms'] * 1e3:.1f} us "
          f"on the card a launch (20 queued), {cuda_ms(lambda: K.layout_rows(*lay_args)) * 1e3:.1f} "
          f"us a lone call with the host's launch; plain {e['plain_ms']:.3f} ms, bound "
          f"{bound * 1e3:.1f} us ({100 * bound / e['ms']:.1f}%) [{smi}]", flush=True)
    del got, want, padded_host, lay_packed, lay_table, lay_args, buf, table, pcm16
    for name, e in entries.items():
        print(f"{name} vs plain: max abs {e['err']:.3e} (tol {e['tol']:g}); "
              f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms", flush=True)
        check(e["err"] <= e["tol"], f"{name} disagrees with its plain version: {e['err']}")

    # 4. B4, the base-256 digit kernel, on the same padded rows: 'double'
    # (the default 13 pairs) and 'accurate' (n_x 4, cutoff 3: 10 pairs);
    # then on the digit adversary (pair sums past 2^23) at K 512 with the
    # Hamming window
    double_ms = {}
    launches = {}
    tiers = {"double": {}, "accurate": dict(n_x=4, cutoff=3)}
    adv_rows = K._digit_adversary_rows(BATCH, n).to(dev)
    for precision, sched in tiers.items():
        cd = computer(precision=precision)
        p = cd.params
        d_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, dft_size=cd.dft_size,
                    **LOG_SPEC, **sched)
        got = K.stft_feats_double(padded, p, **d_kw)
        want = K.stft_feats_double_plain(padded, p, **d_kw)
        err = (got - want).abs().max().item()
        print(f"stft_feats_double [{precision}] vs plain: max abs {err:.3e}", flush=True)
        check(err <= TOL_INT8, f"stft_feats_double [{precision}] disagrees with its plain version: {err}")
        ca = computer(precision=precision, frame_length_ms=32, window_function="hamming")
        a_kw = dict(num_frames=F.frame_count_np(n, 512, ca.frame_shift), frame_length=512,
                    frame_shift=ca.frame_shift, dft_size=ca.dft_size, **LOG_SPEC, **sched)
        a_pad = F.pad_signal_full(adv_rows, 512, ca._pad_left)
        a_err = (K.stft_feats_double(a_pad, ca.params, **a_kw)
                 - K.stft_feats_double_plain(a_pad, ca.params, **a_kw)).abs().max().item()
        print(f"stft_feats_double [{precision}] adversary K 512 vs plain: max abs {a_err:.3e}",
              flush=True)
        check(a_err <= TOL_INT8, f"stft_feats_double [{precision}] disagrees on the adversary: {a_err}")
        del a_pad
        double_ms[precision] = cuda_ms(lambda: K.stft_feats_double(padded, p, **d_kw))
        plain_ms = cuda_ms(lambda: K.stft_feats_double_plain(padded, p, **d_kw), reps=3)
        nb = p["pdk_mask"].shape[0]
        n_pairs = len(K._double_pairs(p, sched.get("n_x"), sched.get("cutoff")))
        dots = 2 * frames_total * fl * 2 * nb * n_pairs
        tail = [p["pdk_" + k] for k in ("mats", "mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")]
        entry = dict(
            replaces="speech_tpu/ops/pallas_stft.py:431 stft_feats_pallas_double (_double_rows_kernel :304)",
            err=max(err, a_err), tol=TOL_INT8, ms=double_ms[precision], plain_ms=plain_ms,
            ops=[
                (dots, PEAK_BF16_FLOPS),  # the pair dots on the bf16 tensor cores
                (2 * frames_total * digit_tail_terms(p, "pdk_"), PEAK_FP32_FLOPS),
            ],
            nbytes=bytes_of(padded, got, *tail), source=DOUBLE_SOURCE,
        )
        bound, _ = bound_ms(entry)
        print(f"stft_feats_double [{precision}]: {double_ms[precision]:.3f} ms, "
              f"plain {plain_ms:.3f} ms, {n_pairs} pairs, bound {bound:.3f} ms "
              f"({100 * bound / double_ms[precision]:.1f}%), the same dots on the CUDA "
              f"cores' fp32 FMAs {dots / PEAK_FP32_FLOPS * 1e3:.3f} ms", flush=True)
        if precision == "double":
            entries["stft_feats_double"] = entry
        K.reset_launch_counts()
        K.stft_feats_double(padded, p, **d_kw)
        torch.cuda.synchronize()
        count = K.launch_counts()["stft_feats_double"]
        check(count == 1, f"stft_feats_double [{precision}] launched {count} times, not once")
        launches["stft_feats_double"] = launches.get("stft_feats_double", 0) + count
        del got, want
    del padded
    torch.cuda.empty_cache()

    # B4 on banks wider than one group's filter sums: 370 and 512 filters
    wide_rows = sigs[:16]
    for num_filts in (370, 512):
        cw = STFTFrameComputer(dict(BANK, num_filts=num_filts), device=dev,
                               **{**MAIN, "precision": "double"})
        w_pad = F.pad_signal_full(wide_rows, fl, cw._pad_left)
        w_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, dft_size=cw.dft_size, **LOG_SPEC)
        plan = K.double_launch_plan(dev, frame_shift=fs, frame_length=fl, n_filts=num_filts)
        got = K.stft_feats_double(w_pad, cw.params, **w_kw)
        err = (got - K.stft_feats_double_plain(w_pad, cw.params, **w_kw)).abs().max().item()
        ms = cuda_ms(lambda: K.stft_feats_double(w_pad, cw.params, **w_kw))
        print(f"stft_feats_double [double] {num_filts} filters on 16 x 15 s: "
              f"{plan['groups']} groups of {plan['group_filters']}, {ms:.3f} ms, "
              f"vs plain max abs {err:.3e}", flush=True)
        check(plan["groups"] > 1, f"{num_filts} filters ran as one group")
        check(err <= TOL_INT8, f"stft_feats_double at {num_filts} filters disagrees: {err}")
        del got, w_pad

    # B2 on banks wider than one group's filter sums; the main path's 40
    # filters stay one group
    plan40 = K.int8_launch_plan(dev, frame_shift=fs, frame_length=fl, n_filts=40)
    print(f"stft_feats_int8 plan at 40 filters: {plan40}", flush=True)
    check(plan40["groups"] == 1, f"B2 at 40 filters runs as {plan40['groups']} groups")
    for num_filts in INT8_WIDE:
        plan = K.int8_launch_plan(dev, frame_shift=fs, frame_length=fl, n_filts=num_filts)
        check(plan["groups"] > 1, f"B2 at {num_filts} filters ran as one group")
        for precision in ("double", "accurate"):
            cw = STFTFrameComputer(dict(BANK, num_filts=num_filts), device=dev,
                                   **{**MAIN, "precision": precision})
            w_pad = F.pad_signal_full(wide_rows, fl, cw._pad_left)
            w_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, dft_size=cw.dft_size,
                        **LOG_SPEC)
            got = K.stft_feats_int8(w_pad, cw.params, **w_kw)
            err = (got - K.stft_feats_int8_plain(w_pad, cw.params, **w_kw)).abs().max().item()
            ms = cuda_ms(lambda: K.stft_feats_int8(w_pad, cw.params, **w_kw), reps=3)
            print(f"stft_feats_int8 [{precision}] {num_filts} filters on 16 x 15 s: "
                  f"{plan['groups']} groups x {plan['group_filters']} filters "
                  f"({plan['tile']}-frame tiles, slab {plan['slab']} k-steps), {ms:.3f} ms, "
                  f"vs plain max abs {err:.3e} (tol {TOL_INT8:g})", flush=True)
            check(err <= TOL_INT8, f"stft_feats_int8 [{precision}] at {num_filts} filters "
                                   f"disagrees: {err}")
            del got, w_pad, cw
    torch.cuda.empty_cache()

    # 5. the main path at full size; counts from 0 just before, read after
    paths = [
        ("double (auto)", computer(precision="double"), sigs, full),
        ("accurate (auto)", computer(precision="accurate"), sigs, full),
        ("pallas highest", computer(fft_mode="pallas"), sigs, full),
        ("pallas highest 10.25 ms", computer(fft_mode="pallas", frame_shift_ms=10.25), sigs, full),
        ("pallas default", computer(fft_mode="pallas", precision="default"), sigs, full),
        ("highest (plain matmul)", computer(), sigs, full),
    ]
    ragged = rng.randint(n // 2, n + 1, size=BATCH)
    ragged[0] = n
    pcm = torch.tensor((host * 32767).astype(np.int16), device=dev)
    paths += [
        ("double ragged", computer(precision="double"), sigs, ragged),
        ("double int16", computer(precision="double"), pcm, full),
    ]
    for _, comp, _, _ in paths:
        comp.params  # host build outside the measured main path
    K.reset_launch_counts()
    results = {}
    for label, comp, x, lengths in paths:
        feats, counts = comp.compute_batch(x, lengths)
        torch.cuda.synchronize()
        results[label] = (comp, feats, counts)
    main_counts = K.launch_counts()
    print(f"main path launches: {main_counts}", flush=True)
    for name in COMPUTE_PATH:
        check(main_counts[name] > 0, f"{name} was not launched by the main path")
        launches[name] = main_counts[name]
    for label, (comp, feats, counts) in results.items():
        want_frames = F.frame_count_np(n, comp.frame_length, comp.frame_shift)
        check(tuple(feats.shape) == (BATCH, want_frames, 41), f"{label}: shape {tuple(feats.shape)}")
        valid = torch.arange(feats.shape[1], device=dev)[None, :] < counts[:, None].long()
        check(bool(torch.isfinite(feats[valid]).all()), f"{label}: non-finite features")
    ref = results["highest (plain matmul)"][1]
    for label, tol in (("double (auto)", TOL_FLOAT), ("accurate (auto)", TOL_FLOAT),
                       ("pallas highest", TOL_FLOAT), ("pallas default", TOL_DEFAULT)):
        diff = (results[label][1] - ref).abs().max().item()
        print(f"{label} vs highest (plain matmul): max abs {diff:.3e}", flush=True)
        check(diff <= tol, f"{label} disagrees with the plain path: {diff}")
    rc, rf, rn = results["double ragged"]
    expect = torch.tensor([F.frame_count_np(int(v), fl, fs) for v in ragged], device=dev)
    check(bool((rn == expect).all()), "ragged counts")
    del results
    audio_s = BATCH * SECONDS
    for label, comp, x, lengths in paths:
        ms = cuda_ms(lambda: comp.compute_batch(x, lengths))
        print(f"compute_batch {label}: {ms:.3f} ms median, "
              f"{audio_s / (ms / 1e3):.0f} audio-s/s", flush=True)

    # 6. the full chain: dither + preemphasis, compute_batch ('double':
    # B2), deltas of order 2, standardization, stacking by 3; unit noise
    # under a 3 Hz envelope (a ~26 dB swing, as syllables give speech)
    envelope = 0.05 + np.abs(np.sin(2 * np.pi * 3.0 * np.arange(n) / RATE))
    chain_sigs = torch.tensor((rng.randn(BATCH, n) * envelope).astype(np.float32), device=dev)
    filts = postops.delta_filters(2)

    def chain(comp):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = pre.preemphasize(pre.dither(gen, chain_sigs, 0.1))
        feats, _ = comp.compute_batch(x, full)
        feats = postops.standardize(postops.deltas(feats, filts))
        return postops.stack(feats, 3, pad=True)

    chain_double, chain_plain = computer(precision="double"), computer()
    for comp in (chain_double, chain_plain):
        comp.params
    K.reset_launch_counts()
    out = chain(chain_double)
    torch.cuda.synchronize()
    chain_counts = K.launch_counts()
    print(f"full chain launches: {chain_counts}", flush=True)
    check(chain_counts["stft_feats_int8"] == 1, "the full chain did not run the int8 kernel once")
    check(tuple(out.shape) == (BATCH, 500, 369), f"full chain: shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "full chain: non-finite values")
    diff = (out - chain(chain_plain)).abs().max().item()
    print(f"full chain (double) vs plain 'highest' chain: max abs {diff:.3e} (tol {TOL_CHAIN:g})", flush=True)
    check(diff <= TOL_CHAIN, f"full chain disagrees with the plain chain: {diff}")
    del out
    chain_ms = cuda_ms(lambda: chain(chain_double))
    print(f"full chain (double): {chain_ms:.3f} ms median, "
          f"{audio_s / (chain_ms / 1e3):.0f} audio-s/s", flush=True)
    torch.cuda.empty_cache()

    # 7. 'double' on the card vs a float64 run of the port on the CPU
    here = os.path.dirname(os.path.abspath(__file__))
    speech = read_wav(os.path.join(here, "tests", "audio", "test.wav"))
    speech = speech / np.abs(speech).max()
    two = np.stack([speech, np.roll(speech, 777)]).astype(np.float32)
    lens = np.full(2, two.shape[1])
    f64 = STFTFrameComputer(dict(BANK), **{**MAIN, "dtype": "float64"}, device="cpu")
    want64, _ = f64.compute_batch(two.astype(np.float64), lens)
    got32, _ = computer(precision="double").compute_batch(two, lens)
    err64 = np.abs(got32.cpu().numpy() - want64.numpy()).max()
    print(f"double (card) vs float64 (CPU) on test.wav: max abs {err64:.3e}", flush=True)
    check(err64 <= TOL_F64, f"'double' vs float64: {err64}")

    # 8. short integration at bench.py's width; its products are cuBLAS
    # (IEEE fp32), as XLA runs them in the JAX package
    si_n = SI_SECONDS * RATE
    si_sigs = sigs[:SI_BATCH, :si_n].contiguous()
    si_full = np.full(SI_BATCH, si_n)
    si_audio = SI_BATCH * SI_SECONDS
    wav = speech[: 3 * RATE]
    si_runs = [("gammatone", "highest"), ("gabor", "highest"),
               ("gammatone", "double"), ("gammatone", "accurate")]
    for bank, precision in si_runs:
        sc = SIFrameComputer(dict(SI_BANKS[bank]), frame_shift_ms=10, include_energy=True,
                             dtype="float32", precision=precision, device=dev)
        sc.params
        feats, counts = sc.compute_batch(si_sigs, si_full)
        torch.cuda.synchronize()
        want_frames = int(sc.frame_counts_np([si_n])[0])
        check(tuple(feats.shape) == (SI_BATCH, (si_n + 80) // 160, 41),
              f"SI {bank} {precision}: shape {tuple(feats.shape)}")
        check(bool((counts == want_frames).all()), f"SI {bank} {precision}: counts")
        check(bool(torch.isfinite(feats[:, :want_frames]).all()),
              f"SI {bank} {precision}: non-finite features")
        del feats, counts
        ms = cuda_ms(lambda: sc.compute_batch(si_sigs, si_full), reps=3)
        s64 = SIFrameComputer(dict(SI_BANKS[bank]), frame_shift_ms=10, include_energy=True,
                              dtype="float64", conv_mode="matmul", device="cpu")
        want64 = s64.compute_full(wav.astype(np.float64))
        got32 = sc.compute_full(wav.astype(np.float32)).astype(np.float64)
        err = np.abs(got32 - want64).max()
        tol = TOL_F64 if precision in ("double", "accurate") else TOL_SI_FLOAT
        print(f"SI compute_batch {bank} [{precision}] ({sc._resolved_conv_mode()}) "
              f"{SI_BATCH} x {SI_SECONDS} s: {ms:.3f} ms median, "
              f"{si_audio / (ms / 1e3):.0f} audio-s/s; test.wav 3 s vs float64 (CPU): "
              f"max abs {err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"SI {bank} [{precision}] vs float64: {err}")
        del sc
        torch.cuda.empty_cache()
    del si_sigs

    # 9. PLP and VADTrim through the device post chain: linear power
    # fbank features with their energy column, voiced frames kept (first,
    # in order) by energy VAD on the log energy, then PLP cepstra of the
    # bands; the same chain on the CPU from the same features
    plp_comp = computer(use_log=False, use_power=True)
    plp_feats, plp_counts = plp_comp.compute_batch(chain_sigs, full)

    def vad_trim(x, n):
        log_e = torch.log(torch.clamp_min(x[..., 0].double(), 1e-30))
        voiced = energy_vad(log_e, energy_threshold=0.0, energy_mean_scale=1.0,
                            frames_context=2, proportion_threshold=0.5, lengths=n)
        order = torch.argsort((~voiced).to(torch.int8), dim=-1, stable=True)
        bands = torch.gather(x[..., 1:], -2, order[..., None].expand(-1, -1, x.shape[-1] - 1))
        return bands, voiced.sum(-1)

    plp_chain = postops.device_post_chain([vad_trim, post.PLP(bank=dict(BANK)), post.Deltas(1)])
    card_out, card_n = plp_chain(plp_feats, plp_counts)
    torch.cuda.synchronize()
    cpu_out, cpu_n = plp_chain(plp_feats.cpu(), plp_counts.cpu())
    check(torch.equal(card_n.cpu(), cpu_n), "PLP/VAD chain: voiced counts differ from the CPU's")
    check(0 < int(cpu_n.min()) and int(cpu_n.max()) < plp_feats.shape[1],
          f"PLP/VAD chain: VAD kept {int(cpu_n.min())}..{int(cpu_n.max())} frames")
    valid = torch.arange(card_out.shape[1])[None, :] < cpu_n[:, None]
    plp_err = (card_out.cpu() - cpu_out).abs()[valid].max().item()
    check(bool(torch.isfinite(card_out.cpu()[valid]).all()), "PLP/VAD chain: non-finite values")
    plp_ms = cuda_ms(lambda: plp_chain(plp_feats, plp_counts))
    print(f"VADTrim + PLP + deltas chain on the card vs the CPU: shape {tuple(card_out.shape)}, "
          f"voiced {int(cpu_n.sum())} of {BATCH * plp_feats.shape[1]} frames, max abs "
          f"{plp_err:.3e} (tol {TOL_FLOAT:g}); {plp_ms:.3f} ms", flush=True)
    check(plp_err <= TOL_FLOAT, f"PLP/VAD chain disagrees with the CPU: {plp_err}")
    del plp_feats, card_out, chain_sigs

    # 10. pitch at bench.py's width: tones of 100 + 9b Hz plus 0.05 noise
    # (seed 0), full lengths; the card in float32 against the port's
    # float64 CPU run on the same signals
    p_rng = np.random.RandomState(0)
    t = np.arange(PITCH_SECONDS * RATE) / RATE
    p_host = np.stack([np.sin(2 * np.pi * (100.0 + 9.0 * b) * t) + 0.05 * p_rng.randn(t.size)
                       for b in range(PITCH_BATCH)]).astype(np.float32)
    p_sigs = torch.tensor(p_host, device=dev)
    p_len = torch.full((PITCH_BATCH,), t.size, dtype=torch.int64, device=dev)
    K.reset_launch_counts()
    feats_p, counts_p = pitch.pitch_feats(p_sigs, RATE, lengths=p_len, return_valid=True)
    torch.cuda.synchronize()
    p_count = K.launch_counts()["viterbi_path"]
    check(p_count == 1, f"pitch_feats launched the Viterbi kernel {p_count} times, not once")
    launches["viterbi_path"] = p_count
    pitch_ms = cuda_ms(lambda: pitch.pitch_feats(p_sigs, RATE, lengths=p_len))
    track64 = pitch.kaldi_pitch(p_host.astype(np.float64), RATE, device="cpu")
    feats64 = pitch.pitch_feats_from_track(track64)
    track32 = pitch.kaldi_pitch(p_sigs, RATE, lengths=p_len)
    voiced = (track64.nccf > 0.5) & track64.valid
    close = torch.isclose(track32.f0.cpu().double(), track64.f0, rtol=TOL_PITCH, atol=0)[voiced]
    share = close.float().mean().item()
    pov_err = (feats_p[..., 0].cpu().double() - feats64[..., 0]).abs().max().item()
    print(f"pitch_feats {PITCH_BATCH} x {PITCH_SECONDS} s: {pitch_ms:.3f} ms median, "
          f"{PITCH_BATCH * PITCH_SECONDS / (pitch_ms / 1e3):.0f} audio-s/s; frames "
          f"{int(counts_p.sum())} (CPU {int(track64.valid.sum())}), voiced on the CPU "
          f"{int(voiced.sum())}, f0 within rtol {TOL_PITCH:g} on {int(close.sum())} "
          f"({100 * share:.2f}%); POV column max abs {pov_err:.3e} (tol {TOL_PITCH:g})",
          flush=True)
    check(tuple(feats_p.shape) == (PITCH_BATCH, track64.f0.shape[-1], 3),
          f"pitch_feats: shape {tuple(feats_p.shape)}")
    check(bool(torch.isfinite(feats_p).all()), "pitch_feats: non-finite values")
    check(torch.equal(counts_p.cpu(), track64.valid.sum(-1)), "pitch frame counts differ")
    check(share >= 0.99, f"pitch f0 within rtol {TOL_PITCH:g} on only {100 * share:.2f}%")
    check(pov_err <= TOL_PITCH, f"pitch POV column vs float64: {pov_err}")
    del p_sigs, feats_p, track32
    torch.cuda.empty_cache()
    launches["viterbi_path"] += pitch_extractor_phase(dev, smi)
    entries["viterbi_path"] = viterbi_phase(dev, smi)

    # 11. resampling and augmentation at the main path's 128 x 15 s; the
    # float64 CPU references take the first CPU_ROWS rows (every op is per
    # row)
    ref_rows = host[:CPU_ROWS].astype(np.float64)
    rir_rng = np.random.RandomState(11)
    rir = rir_rng.randn(int(0.3 * RATE)) * np.exp(-np.arange(int(0.3 * RATE)) / (0.05 * RATE))
    rir[40] = 2.0  # the direct path
    noise_buf = (rir_rng.randn(n) * 0.1).astype(np.float32)
    noise_dev = torch.tensor(noise_buf, device=dev)
    noise64 = torch.tensor(noise_buf.astype(np.float64))
    gen = torch.Generator(device=dev)
    # (x, noise buffer, generator) -> output; mix_noise reads the buffer at
    # random offsets when timed and at offset 0 (no generator) when checked
    signal_ops = {
        "resample 16 -> 8 kHz": lambda x, buf, g: resample.resample(x, 1, 2),
        "speed_perturb 0.9": lambda x, buf, g: augment.speed_perturb(x, 0.9),
        "speed_perturb 1.1": lambda x, buf, g: augment.speed_perturb(x, 1.1),
        "reverberate 0.3 s RIR": lambda x, buf, g: augment.reverberate(x, rir),
        "mix_noise 10 dB": lambda x, buf, g: augment.mix_noise(g, x, buf, 10.0),
    }
    for label, op in signal_ops.items():
        out = op(sigs, noise_dev, gen.manual_seed(1))
        torch.cuda.synchronize()
        check(out.shape[0] == BATCH and bool(torch.isfinite(out).all()), f"{label}: bad output")
        ms = cuda_ms(lambda: op(sigs, noise_dev, gen.manual_seed(1)), reps=3)
        got = op(sigs[:CPU_ROWS], noise_dev, None).cpu().double()
        want = op(torch.tensor(ref_rows), noise64, None)
        err = (got - want).abs().max().item()
        print(f"{label} {BATCH} x {SECONDS} s: {ms:.3f} ms median, "
              f"{audio_s / (ms / 1e3):.0f} audio-s/s; rows 0-{CPU_ROWS - 1} vs float64 (CPU) "
              f"max abs {err:.3e} (tol {TOL_SIGNAL:g})", flush=True)
        check(err <= TOL_SIGNAL, f"{label} vs float64: {err}")
        del out, got
    torch.cuda.empty_cache()

    # 12. feature inversion: 8 x 5 s of 'highest' fbank features
    inv_comp = computer()
    inv_n = 5 * RATE
    inv_feats, _ = inv_comp.compute_batch(sigs[:8, :inv_n], np.full(8, inv_n))
    y = invert.feats_to_signal(inv_feats, inv_comp, n_iters=64)
    torch.cuda.synchronize()
    check(tuple(y.shape) == (8, inv_feats.shape[1] * fs) and bool(torch.isfinite(y).all()),
          f"feats_to_signal: shape {tuple(y.shape)} or non-finite values")
    inv_ms = cuda_ms(lambda: invert.feats_to_signal(inv_feats, inv_comp, n_iters=64), reps=3)
    inv64 = STFTFrameComputer(dict(BANK), **{**MAIN, "dtype": "float64"}, device="cpu")
    want = invert.feats_to_signal(inv_feats.cpu().double(), inv64, n_iters=4)
    card64 = STFTFrameComputer(dict(BANK), **{**MAIN, "dtype": "float64"}, device=dev)
    got = invert.feats_to_signal(inv_feats.double(), card64, n_iters=4).cpu()
    inv_err = (got - want).abs().max().item()
    err32 = (invert.feats_to_signal(inv_feats, inv_comp, n_iters=4).cpu().double()
             - want).abs().max().item()
    print(f"feats_to_signal 8 x 5 s, 64 iterations: {inv_ms:.3f} ms median; 4 iterations, "
          f"float64 on the card vs float64 (CPU) max abs {inv_err:.3e} (tol {TOL_INVERT:g}); "
          f"float32 on the card vs float64 (CPU) {err32:.3e}, output peak "
          f"{want.abs().max().item():.3f}", flush=True)
    check(inv_err <= TOL_INVERT, f"feats_to_signal vs float64: {inv_err}")
    del inv_feats, y

    # 13. the file path: audio and statistics from files, then the chain
    audio_dir = os.path.join(here, "tests", "audio")
    t0 = time.perf_counter()
    sph = sorted(glob.glob(os.path.join(audio_dir, "*.sph")))
    for path in sph:
        twin = path.replace("_shn.sph", ".wav").replace(".sph", ".wav")
        check(np.array_equal(read_signal(path), read_signal(twin)),
              f"{os.path.basename(path)} differs from its .wav twin")
    mono = [os.path.join(audio_dir, "test.wav")] + [p for p in sph if "_1" in os.path.basename(p)]
    from_files = [read_signal(p) for p in mono]
    read_ms = (time.perf_counter() - t0) * 1e3
    in_memory = [(read_wav(p.replace("_shn.sph", ".wav")) * 32768.0).astype(np.int16)
                 for p in mono]
    check(all(np.array_equal(a, b) for a, b in zip(from_files, in_memory)),
          "read_signal differs from the in-memory PCM")
    lens_f = np.array([a.size for a in from_files])

    def padded_batch(arrays):
        out = np.zeros((len(arrays), lens_f.max()), np.int16)
        for i, a in enumerate(arrays):
            out[i, : a.size] = a
        return torch.tensor(out.astype(np.float32) / 32768.0, device=dev)

    file_comp = computer(precision="double")

    def file_chain(x, stats):
        feats, counts = file_comp.compute_batch(pre.preemphasize(x), lens_f)
        return postops.standardize_with_stats(feats, stats), counts

    feats_f, counts_f = file_comp.compute_batch(pre.preemphasize(padded_batch(from_files)), lens_f)
    acc = post.Standardize()
    for row, c in enumerate(counts_f.tolist()):
        acc.accumulate(feats_f[row, :c].cpu().double().numpy())
    with tempfile.TemporaryDirectory() as tmp:
        stats_path = os.path.join(tmp, "cmvn.npy")
        acc.save(stats_path)
        loaded = post.Standardize(stats_path)
    check(np.array_equal(loaded.stats, acc.stats), "statistics read back differ")
    K.reset_launch_counts()
    x_files = padded_batch(from_files)
    out_files, n_files = file_chain(x_files, torch.tensor(loaded.stats, device=dev))
    torch.cuda.synchronize()
    file_counts = K.launch_counts()
    out_mem, n_mem = file_chain(padded_batch(in_memory),
                                torch.tensor(post.Standardize.from_stats(acc.stats).stats,
                                             device=dev))
    file_ms = cuda_ms(lambda: file_chain(x_files, torch.tensor(loaded.stats, device=dev)))
    print(f"file path: {len(sph)} .sph files bit-equal to their .wav twins, {len(mono)} mono "
          f"files read in {read_ms:.1f} ms (host); chain launches {file_counts}; "
          f"{file_ms:.3f} ms median on the card; bitwise equal to the in-memory chain: "
          f"{torch.equal(out_files, out_mem)}", flush=True)
    check(file_counts["stft_feats_int8"] == 1, "the file path did not run the int8 kernel once")
    check(torch.equal(n_files, n_mem) and torch.equal(out_files, out_mem),
          "the file path differs from the in-memory chain")

    # 14. streaming
    streaming_phase(dev, here, speech)

    # 15. multi-device, on a one-card NCCL group; 16. the frontends
    for name, count in multidevice_phase(dev, smi, host).items():
        launches[name] = launches.get(name, 0) + count
    for name, count in frontend_phase(dev, smi).items():
        launches[name] = launches.get(name, 0) + count

    # 17. the model families; 18. serving; 19. the corpus CLIs; 20. the
    # library store's cold and warm starts; 21. the compatibility layer
    phases = [lambda: models_phase(dev, smi), lambda: serving_phase(dev, smi),
              lambda: cli_phase(dev, smi, run_dir),
              lambda: cold_start_phase(dev, smi, host, run_dir)]
    for phase in phases:
        for name, count in phase().items():
            launches[name] = launches.get(name, 0) + count
    compat_phase(dev, smi, host)

    # 22. both servers on a one-card NCCL group, through the relay
    for name, count in group_serving_phase(dev, smi).items():
        launches[name] = launches.get(name, 0) + count

    # 23. the kernels line, the card, the device line
    kernels = []
    for name, e in entries.items():
        bound, bound_by = bound_ms(e)
        kernels.append({
            "name": name, "route": "cuda", "source": e.get("source", SOURCE),
            "replaces": e["replaces"],
            "launches": launches[name], "max_abs_err": e["err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
        })
    print(f"stft_feats_int8 accurate ms: {int8_ms['accurate']:.3f}; "
          f"stft_feats_double accurate ms: {double_ms['accurate']:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def pitch_extractor_phase(dev, smi):
    """The pitch cell's path: ``ShardedExtractor(pitch=)`` at ESPnet's lag
    grid (418 lags) on one batch of 64 voiced int16 utterances of 2-20 s
    (pulse trains gliding within 80-300 Hz over noise), whose host lengths
    end the Viterbi at the longest row's frames and freeze the shorter
    rows at theirs; its rows with the kernel equal those of the same batch
    with ``viterbi_on_kernel`` refused (the Viterbi's loops) bit for bit,
    the kernel runs once a batch, and ``pitch_kernel_steps`` counts every
    one of ``pitch_steps``.  Returns the kernel's launches."""
    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.ops import pitch
    from speech_tpu_torch.ops import stft_kernels as K

    rng = np.random.RandomState(23)
    batch = []
    for n in rng.randint(2 * RATE, 20 * RATE, size=VITERBI_ROWS):
        t = np.arange(n) / RATE
        f0 = 80.0 * (300.0 / 80.0) ** (0.5 + 0.5 * np.sin(2 * np.pi * t / rng.uniform(0.5, 2.0)))
        pulses = np.diff(np.floor(np.cumsum(f0) / RATE), prepend=0.0)
        x = np.convolve(pulses, np.exp(-np.arange(80) / 12.0))[:n] + 0.05 * rng.randn(n)
        batch.append(np.round(x / np.abs(x).max() * 8000).astype(np.int16))
    comp = STFTFrameComputer(dict(BANK, num_filts=80), device=dev, frame_length_ms=25,
                             frame_shift_ms=10, precision="highest")
    opts = {"lag_resolution": 0.005}
    check(pitch.pitch_lag_count(RATE, **opts) == VITERBI_LAGS, "the cell's lag grid moved")
    ex = par.ShardedExtractor(comp, pitch=opts)
    list(ex.extract_iter([batch], min_batch=VITERBI_ROWS))  # warm-up
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = list(ex.extract_iter([batch], min_batch=VITERBI_ROWS))[0]
    ms = (time.perf_counter() - t0) * 1e3
    count = K.launch_counts()["viterbi_path"]
    on_kernel = pitch.viterbi_on_kernel
    pitch.viterbi_on_kernel = lambda *a: False
    try:
        loops = par.ShardedExtractor(comp, pitch=opts)
        want = list(loops.extract_iter([batch], min_batch=VITERBI_ROWS))[0]
    finally:
        pitch.viterbi_on_kernel = on_kernel
    st, lst = ex.stats, loops.stats
    differ = sum(int(not np.array_equal(a, b)) for a, b in zip(got, want))
    print(f"pitch on the extractor ({VITERBI_ROWS} utterances of 2-20 s, {VITERBI_LAGS} lags, "
          f"host lengths): {count} viterbi_path launch a batch; {differ} of {len(got)} rows "
          f"differ from the loops'; pitch_steps {st['pitch_steps']} of {st['pitch_frames']} "
          f"frames, pitch_kernel_steps {st['pitch_kernel_steps']} (loops "
          f"{lst['pitch_kernel_steps']}); {ms:.1f} ms a batch on the host clock [{smi}]",
          flush=True)
    check(count == 1, f"the extractor launched the Viterbi kernel {count} times a batch")
    check(len(got) == len(want) == VITERBI_ROWS and differ == 0,
          f"the extractor's pitch rows differ from the loops' on {differ} rows")
    check(0 < st["pitch_steps"] < st["pitch_frames"], f"the Viterbi was not bounded: {st}")
    check(st["pitch_kernel_steps"] == st["pitch_steps"] == 2 * lst["pitch_steps"]
          and lst["pitch_kernel_steps"] == 0, f"pitch_kernel_steps: {st}, loops {lst}")
    return count


def viterbi_phase(dev, smi):
    """The pitch tracker's Viterbi kernel alone at the pitch cell's shape
    (``VITERBI_ROWS`` rows, ``VITERBI_STEPS`` steps, ``VITERBI_LAGS``
    lags; scores uniform in [-1, 1], every row tracked to the end) against
    its two loops on the same scores, bit for bit; its bound is
    ``bench_port/roofline_pitch.py``'s Viterbi term (an add and a min a
    pair of lags a row a step at the float32 rate; the scores read, int16
    back-pointers written and the table read once).  Returns its
    kernels-line entry."""
    import torch

    from speech_tpu_torch.ops import pitch
    from speech_tpu_torch.ops import stft_kernels as K

    rows, steps, L = VITERBI_ROWS, VITERBI_STEPS, VITERBI_LAGS
    rng = np.random.RandomState(10)
    nc = torch.tensor(rng.uniform(-1.0, 1.0, (rows, steps, L)).astype(np.float32), device=dev)
    nc = torch.movedim(nc, 1, 0)  # (steps, rows, L), as _choose_lags hands it over
    tables = pitch._lag_tables(4000.0, 50.0, 400.0, 0.1, 0.005)
    check(len(tables[2]) == L, f"the lag grid has {len(tables[2])} lags")
    tmat = pitch._const(tables[4], nc)
    plan = K.viterbi_launch_plan(dev, rows, L)
    got = pitch._viterbi(nc, tmat)
    on_kernel = pitch.viterbi_on_kernel
    pitch.viterbi_on_kernel = lambda *a: False
    try:
        want = pitch._viterbi(nc, tmat)
        loop_ms = cuda_ms(lambda: pitch._viterbi(nc, tmat), reps=3)
    finally:
        pitch.viterbi_on_kernel = on_kernel
    differ = int((got != want).sum())
    ms = cuda_ms(lambda: pitch._viterbi(nc, tmat))
    entry = dict(
        replaces="none: the JAX package runs the Viterbi as two lax.scan passes "
                 "(speech_tpu/ops/pitch.py); the port's plain version is "
                 "speech_tpu_torch/ops/pitch.py:_viterbi's two loops",
        err=float(differ), tol=0, ms=ms, plain_ms=loop_ms,
        ops=[(2.0 * rows * steps * L * L, PEAK_FP32_FLOPS)],
        nbytes=rows * steps * L * (4 + 2) + L * L * 4, source=VITERBI_SOURCE,
    )
    bound, bound_by = bound_ms(entry)
    print(f"viterbi_path at the pitch cell's shape ({rows} rows x {steps} steps x {L} lags; plan "
          f"{plan}): {differ} lags differ from the loops'; {ms:.3f} ms a launch, the loops "
          f"{loop_ms:.3f} ms ({loop_ms / ms:.1f}x); bound {bound:.3f} ms by {bound_by} "
          f"({100 * bound / ms:.2f}%) [{smi}]", flush=True)
    check(differ == 0, f"viterbi_path differs from the loops on {differ} lags")
    del nc, got, want
    torch.cuda.empty_cache()
    return entry


def pitch_split(sp, sigs):
    """Where a wide pitch tick's time goes: the host ms (to the card's last
    kernel) and launches of one absorbed chunk of every session and of its
    parts, and of the one backtrack of all the tick's chunks."""
    import torch

    from speech_tpu_torch.ops import pitch

    S, N, F = sigs.shape[0], sp.chunk_size, sp.max_frames_chunk
    state = sp.init_state(streams=S)
    timeline = sp._timeline(state, STREAM_DEPTH * F)
    full = torch.full((S,), N, device=sigs.device)
    every = torch.ones(S, dtype=torch.bool, device=sigs.device)
    buf = torch.cat([state.raw_carry, sigs[:, :N]], dim=1)
    work = sp._front(buf)
    frames = torch.randn(S, F, sp.span, device=sigs.device)
    ballast = torch.ones(S, device=sigs.device)
    costs = torch.randn(STREAM_DEPTH, S, sp.n_lags, device=sigs.device)
    ends = torch.full((STREAM_DEPTH, S), sp.ring_len, device=sigs.device)
    parts = {
        "absorb": lambda: sp._absorb(state, sigs[:, :N], full, every, timeline, state.n_frames),
        "resample": lambda: sp._front(buf),
        "lowpass": lambda: pitch._lowpass(work, sp.work_rate, sp.lowpass_cutoff),
        "nccf": lambda: pitch._nccf_from_frames(frames, sp.nccf_window, sp.tables, ballast),
        "backtrack": lambda: sp._emit_tracks(timeline, costs, ends, ends, ends - sp.lookahead, F),
    }
    out = {}
    for name, fn in parts.items():
        with no_sync():
            ms = wall_ms(fn, reps=5)
        out[name] = (ms, kernel_split(fn)[0])
    rest = out["absorb"][0] - sum(out[k][0] for k in ("resample", "lowpass", "nccf"))
    print(f"pitch wide tick split ({S} sessions): one absorbed chunk {out['absorb'][0]:.3f} ms, "
          f"{out['absorb'][1]} launches = resample {out['resample'][0]:.3f} ms "
          f"({out['resample'][1]}) + lowpass {out['lowpass'][0]:.3f} ({out['lowpass'][1]}) + "
          f"NCCF {out['nccf'][0]:.3f} ({out['nccf'][1]}) + {F} Viterbi steps and bookkeeping "
          f"{rest:.3f}; the backtrack of {STREAM_DEPTH} chunks ({sp.ring_len} steps) "
          f"{out['backtrack'][0]:.3f} ms ({out['backtrack'][1]} launches)", flush=True)


def streaming_phase(dev, here, speech):
    """Phase 14: the streamers and the post pipeline at bench.py's widths,
    timed ticks under sync checking, each held against its batch path."""
    import torch

    from speech_tpu_torch import post
    from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
    from speech_tpu_torch.ops import pitch, postops
    from speech_tpu_torch.streaming import StreamingPitch, StreamingSI, StreamingSTFT
    from speech_tpu_torch.streaming_post import StreamingPipeline

    # set_sync_debug_mode warns once that it is a prototype
    warnings.filterwarnings("ignore", message="Synchronization debug mode")
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    S, C, depth = STREAM_SESSIONS, STREAM_CHUNK, STREAM_DEPTH
    W = C * depth
    audio_s = S * W / RATE
    rng = np.random.RandomState(2)
    sigs = torch.tensor((rng.randn(S, W) * 0.1).astype(np.float32), device=dev)
    lengths = np.full(S, W)

    def report(label, stream, x):
        lat, amort = tick_ms(stream, x[0, :C])
        wide = wall_ms(lambda: streamed_ticks(stream, x))
        n_k, busy, top = kernel_split(lambda: streamed_ticks(stream, x))
        print(f"{label} stream: latency {lat:.3f} ms a 100 ms chunk (read back every tick), "
              f"amortised {amort:.3f} ms over {STREAM_TICKS} ticks; {S} x {depth} chunks in one "
              f"wide call {wide:.3f} ms ({audio_s / (wide / 1e3):.0f} audio-s/s), {n_k} kernel "
              f"launches, {busy:.3f} ms of device time (idle {100 * (1 - busy / wide):.1f}%); "
              f"top kernels {top}", flush=True)

    def streamed_ticks(stream, x):
        state = stream.init_state(streams=x.shape[0])
        with no_sync():
            return wide_call(stream)(state, x, x.shape[-1])

    def max_err(rows, want, counts):
        errs = []
        for s, r in enumerate(rows):
            check(r.shape[0] == int(counts[s]), f"stream rows {r.shape[0]} vs batch {int(counts[s])}")
            check(bool(torch.isfinite(r).all()), "non-finite streamed rows")
            errs.append((r - want[s, : r.shape[0]]).abs().max().item())
        return max(errs)

    # STFT: the fbank-40 computer of bench.py:117-124 ('highest', plain path)
    stft = STFTFrameComputer(dict(BANK), device=dev, **MAIN)
    stream = StreamingSTFT(stft, C)
    want, counts = stft.compute_batch(sigs, lengths)
    err = max_err(streamed_rows(stream, sigs), want, counts)
    print(f"STFT stream {S} x {W / RATE:.1f} s vs compute_batch: max abs {err:.3e} "
          f"(tol {TOL_FLOAT:g})", flush=True)
    check(err <= TOL_FLOAT, f"STFT stream disagrees with compute_batch: {err}")
    report("STFT", stream, sigs)

    # SI: gammatone-40 'highest' (bench.py:126-137), then 'double' on test.wav
    si = SIFrameComputer(dict(SI_BANKS["gammatone"]), frame_shift_ms=10, include_energy=True,
                         dtype="float32", device=dev)
    si_stream = StreamingSI(si, C)
    want, counts = si.compute_batch(sigs, lengths)
    err = max_err(streamed_rows(si_stream, sigs), want, counts)
    print(f"SI stream ({si_stream.conv_mode}) {S} x {W / RATE:.1f} s vs compute_batch: max abs "
          f"{err:.3e} (tol {TOL_SI_FLOAT:g})", flush=True)
    check(err <= TOL_SI_FLOAT, f"SI stream disagrees with compute_batch: {err}")
    report("SI gammatone-40", si_stream, sigs)
    wav = np.stack([speech[: 3 * RATE], np.roll(speech, 777)[: 3 * RATE]])
    sd = SIFrameComputer(dict(SI_BANKS["gammatone"]), frame_shift_ms=10, include_energy=True,
                         dtype="float32", precision="double", device=dev)
    s64 = SIFrameComputer(dict(SI_BANKS["gammatone"]), frame_shift_ms=10, include_energy=True,
                          dtype="float64", conv_mode="matmul", device="cpu")
    rows = streamed_rows(StreamingSI(sd, C), torch.tensor(wav.astype(np.float32), device=dev))
    err = 0.0
    for s, r in enumerate(rows):
        want64 = s64.compute_full(wav[s].astype(np.float64))
        check(r.shape[0] == want64.shape[0], "SI 'double' stream: frame count")
        err = max(err, np.abs(r.cpu().numpy().astype(np.float64) - want64).max())
    print(f"SI 'double' stream 2 x 3 s of test.wav vs float64 (CPU): max abs {err:.3e} "
          f"(tol {TOL_F64:g})", flush=True)
    check(err <= TOL_F64, f"SI 'double' stream vs float64: {err}")
    del sd, rows
    torch.cuda.empty_cache()

    # pitch: bench.py's tones (100 + 9b Hz plus 0.05 noise, seed 0), 6.4 s
    p_rng = np.random.RandomState(0)
    t = np.arange(W) / RATE
    tones = np.stack([np.sin(2 * np.pi * (100.0 + 9.0 * b) * t) + 0.05 * p_rng.randn(W)
                      for b in range(S)]).astype(np.float32)
    p_sigs = torch.tensor(tones, device=dev)
    p_stream = StreamingPitch(RATE, C, lookahead_frames=50, device=dev)
    rows = streamed_rows(p_stream, p_sigs)
    track = pitch.kaldi_pitch(p_sigs, RATE, lengths=torch.full((S,), W, device=dev))
    voiced = (track.nccf > 0.5) & track.valid
    close = 0
    for s, r in enumerate(rows):
        check(r.shape[0] == int(track.valid[s].sum()), "pitch stream: frame count")
        ok = torch.isclose(r[:, 0], track.f0[s], rtol=TOL_PITCH, atol=0) | ~voiced[s]
        close += int(ok.sum()) - int((~voiced[s]).sum())
    share = close / int(voiced.sum())
    print(f"pitch stream {S} x {W / RATE:.1f} s vs kaldi_pitch on the card: f0 within rtol "
          f"{TOL_PITCH:g} on {100 * share:.2f}% of {int(voiced.sum())} voiced frames", flush=True)
    check(share >= 0.99, f"pitch stream f0 agrees on only {100 * share:.2f}%")
    report("pitch", p_stream, p_sigs)
    pitch_split(p_stream, p_sigs)
    # one long session, float32 against float64 on the card: where the
    # reference's unshifted Viterbi costs drift
    n_long = PITCH_LONG_SECONDS * RATE
    tl = np.arange(n_long) / RATE
    f0t = 150.0 + 40.0 * np.sin(2 * np.pi * 0.7 * tl)
    voice = np.sin(2 * np.pi * np.cumsum(f0t) / RATE) + 0.1 * np.random.RandomState(21).randn(n_long)
    tracks = {}
    for dtype in (torch.float32, torch.float64):
        sp = StreamingPitch(RATE, C, lookahead_frames=50, dtype=dtype, device=dev)
        t0 = time.perf_counter()
        (tracks[dtype],) = streamed_rows(sp, torch.tensor(voice[None], dtype=dtype, device=dev))
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
    f32, f64 = tracks[torch.float32].double(), tracks[torch.float64]
    check(f32.shape == f64.shape, "long pitch session: frame counts differ")
    v = f64[:, 1] > 0.5
    share = torch.isclose(f32[v, 0], f64[v, 0], rtol=TOL_PITCH, atol=0).double().mean().item()
    print(f"pitch stream, one {PITCH_LONG_SECONDS} s session in one call: float32 vs float64 "
          f"on the card, f0 within rtol {TOL_PITCH:g} on {100 * share:.2f}% of {int(v.sum())} "
          f"voiced frames; float64 call {long_ms:.1f} ms", flush=True)
    check(share >= 0.99, f"long pitch session: float32 agrees on only {100 * share:.2f}%")
    torch.cuda.empty_cache()

    # the post pipeline: float64 against the batch ops, then timed in float32
    def pipeline(dtype):
        comp = STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, "dtype": dtype})
        posts = [post.Deltas(2), post.SlidingCMVN(center=False), post.Stack(3)]
        return comp, StreamingPipeline(comp, posts, chunk_size=C)

    comp64, pipe64 = pipeline("float64")
    sigs64 = sigs.double()
    rows = streamed_rows(pipe64, sigs64)
    feats64, _ = comp64.compute_batch(sigs64, lengths)
    want = postops.deltas(feats64, postops.delta_filters(2))
    want = postops.sliding_cmvn(want, window=600, center=False, min_window=100)
    want = postops.stack(want, 3)
    err = max_err(rows, want, [want.shape[1]] * S)
    print(f"pipeline (deltas, sliding CMVN, stack) float64 {S} x {W / RATE:.1f} s vs the batch "
          f"ops: {want.shape[1]} rows of {want.shape[2]} a session, max abs {err:.3e} "
          f"(tol {TOL_PIPE:g})", flush=True)
    check(err <= TOL_PIPE, f"pipeline disagrees with the batch ops: {err}")
    _, pipe32 = pipeline("float32")
    report("pipeline float32", pipe32, sigs)


def multidevice_phase(dev, smi, host):
    """Phase 15: speech_tpu_torch.parallel on a world-size-1 NCCL group.
    Returns the launches of the driven paths, by kernel."""
    import torch
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
    from speech_tpu_torch.ops import framing as F
    from speech_tpu_torch.ops import pitch
    from speech_tpu_torch.parallel import multihost

    counted = {}

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    tmp = tempfile.mkdtemp()
    multihost.initialize(store=dist.FileStore(os.path.join(tmp, "store"), 1),
                         num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = par.make_mesh(("data",))
        check(par.mesh.axis_size(mesh, "data") == 1, "mesh size")
        n = SECONDS * RATE
        sigs = torch.tensor(host, device=dev)
        full = np.full(BATCH, n)
        audio_s = BATCH * SECONDS
        # the extractor on each kernel route, at the main path's 128 x 15 s
        routes = [("double (auto)", dict(precision="double"), "stft_feats_int8"),
                  ("pallas highest", dict(fft_mode="pallas"), "stft_feats_rows"),
                  ("pallas highest 10.25 ms", dict(fft_mode="pallas", frame_shift_ms=10.25),
                   "stft_feats_frames")]
        for label, kw, kernel in routes:
            comp = computer(**kw)
            comp.params
            ex = par.ShardedExtractor(comp, mesh)
            (feats, counts), got = driven(counted, lambda: ex.extract_batch(sigs, full))
            check(got[kernel] == 1, f"extractor {label}: {kernel} launched {got[kernel]} times")
            want, want_n = comp.compute_batch(sigs, full)
            check(torch.equal(feats.full_tensor(), want) and torch.equal(counts.full_tensor(), want_n),
                  f"extractor {label} differs from compute_batch")
            ms = cuda_ms(lambda: ex.extract_batch(sigs, full))
            print(f"ShardedExtractor {label} {BATCH} x {SECONDS} s: bitwise equal to compute_batch, "
                  f"{kernel} x{got[kernel]}; {ms:.3f} ms median, {audio_s / (ms / 1e3):.0f} "
                  f"audio-s/s [{smi}]", flush=True)
            if label == "double (auto)":
                main_ex, main_feats, main_counts = ex, feats, counts
            del feats, counts, want
        # statistics over the extractor's features
        st = par.accumulate_stats_sharded(main_feats, main_counts, mesh)
        want = par.accumulate_stats(main_feats.full_tensor(), main_counts.full_tensor())
        check(torch.equal(st, want), "accumulate_stats_sharded differs from accumulate_stats")
        print(f"accumulate_stats_sharded on {tuple(main_feats.shape)}: equal to accumulate_stats, "
              f"frames {int(st[0, -1])}", flush=True)
        del main_feats, main_counts, sigs
        torch.cuda.empty_cache()

        # ragged utterances, both buckets, each row against its own batch
        rng = np.random.RandomState(15)
        utts = [(rng.randn(rng.randint(RATE, n + 1)) * 0.1).astype(np.float32) for _ in range(64)]
        comp = main_ex._computer
        # each utterance alone on the plain digit route ('double' at
        # fft_mode="matmul" runs no kernel), within the digit tolerance
        ref = computer(precision="double", fft_mode="matmul")
        check(ref._use_kernel(dev) is None, "the reference computer takes a kernel route")
        own, got = driven({}, lambda: [ref.compute_batch(u[None], [u.size])[0][0].cpu().numpy()
                                        for u in utts])
        check(not any(got.values()), f"the plain reference launched {got}")

        def row_err(outs, first=0):
            """Max abs of extracted rows against utterances ``first, ...``."""
            us = range(first, first + len(outs))
            check(all(o.shape == own[i].shape for o, i in zip(outs, us)), "frame counts")
            return max(np.abs(o - own[i]).max() for o, i in zip(outs, us))

        for bucket in ("pow2", "fine"):
            ex = par.ShardedExtractor(comp, mesh, bucket=bucket)
            outs, got = driven(counted, lambda: ex.extract(utts))
            check(got["stft_feats_int8"] == 1, f"extract ({bucket}): B2 launched {got}")
            err = row_err(outs)
            ms = wall_ms(lambda: ex.extract(utts))
            audio = sum(u.size for u in utts) / RATE
            print(f"extract ({bucket}) 64 ragged utterances of 1-{SECONDS} s ({audio:.0f} s of "
                  f"audio, padded to {ex.bucket_len(max(u.size for u in utts))}): max abs vs "
                  f"own plain-route compute_batch {err:.3e} (tol {TOL_INT8:g}); {ms:.3f} ms host to host, "
                  f"{audio / (ms / 1e3):.0f} audio-s/s [{smi}]", flush=True)
            check(err <= TOL_INT8, f"extract ({bucket}) vs the plain route: {err}")

        # extract_iter: 8 batches of 32 ragged utterances
        firsts = [(8 * i) % 32 for i in range(8)]
        batches = [utts[f: f + 32] for f in firsts]
        ex = par.ShardedExtractor(comp, mesh)
        outs, got = driven(counted, lambda: list(ex.extract_iter(iter(batches))))
        check(len(outs) == 8 and got["stft_feats_int8"] == 8 and got["layout_rows"] == 8,
              f"extract_iter: {len(outs)} batches, launches {got}")
        iter_err = max(row_err(out, f) for f, out in zip(firsts, outs))
        check(iter_err <= TOL_INT8, f"extract_iter vs the plain route: {iter_err}")
        ex._collect(*ex._dispatch(batches[0]))
        torch.cuda.synchronize()
        with no_sync():
            pending = ex._dispatch(batches[1])
        ex._collect(*pending)
        overlapped = wall_ms(lambda: list(ex.extract_iter(iter(batches)))) / 8
        serial = wall_ms(lambda: [ex.extract(b) for b in batches]) / 8
        n_k, busy, top = kernel_split(lambda: list(ex.extract_iter(iter(batches))))
        audio = sum(u.size for b in batches for u in b) / RATE / 8
        print(f"extract_iter 8 batches of 32 ragged utterances ({audio:.0f} s of audio a batch): "
              f"max abs vs the plain route {iter_err:.3e} (tol {TOL_INT8:g}); "
              f"{overlapped:.3f} ms a batch double-buffered, {serial:.3f} ms one at a time; "
              f"{n_k} launches, device busy {busy / 8:.3f} ms a batch, idle "
              f"{100 * (1 - busy / (8 * overlapped)):.1f}%; dispatch queued no host sync; "
              f"top kernels {top} [{smi}]", flush=True)

        # the halo paths on one 10-minute signal
        long_n = HALO_SECONDS * RATE
        long = torch.tensor((rng.randn(long_n) * 0.1).astype(np.float32), device=dev)
        plain = computer()
        fl, fs = plain.frame_length, plain.frame_shift
        frames = par.halo_frame_signal(long, mesh, "data", fl, fs, plain._pad_left).full_tensor()
        want = F.frame_padded(F.pad_signal_full(long, fl, plain._pad_left), long_n // fs, fl, fs)
        check(torch.equal(frames, want), "halo_frame_signal differs from frame_padded")
        del frames, want
        got = par.sharded_stft_feats(plain, long, mesh, "data").full_tensor()
        want = torch.tensor(plain.compute_full(long.cpu().numpy()), device=dev)
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: par.sharded_stft_feats(plain, long, mesh, "data"), reps=3)
        print(f"halo_frame_signal {HALO_SECONDS} s: bitwise equal to frame_padded; sharded_stft_feats "
              f"vs compute_full: max abs {err:.3e} (tol {TOL_FLOAT:g}), {ms:.3f} ms [{smi}]",
              flush=True)
        check(got.shape == want.shape and err <= TOL_FLOAT, f"sharded_stft_feats: {err}")
        del got, want
        si = SIFrameComputer(dict(SI_BANKS["gammatone"]), frame_shift_ms=10, include_energy=True,
                             dtype="float32", device=dev)
        got = par.sharded_si_feats(si, long, mesh, "data").full_tensor()
        want = torch.tensor(si.compute_full(long.cpu().numpy()), device=dev)
        err = (got[: want.shape[0]] - want).abs().max().item()
        ms = cuda_ms(lambda: par.sharded_si_feats(si, long, mesh, "data"), reps=3)
        print(f"sharded_si_feats gammatone-40 {HALO_SECONDS} s vs compute_full: max abs {err:.3e} "
              f"(tol {TOL_SI_FLOAT:g}), {ms:.3f} ms [{smi}]", flush=True)
        check(err <= TOL_SI_FLOAT, f"sharded_si_feats: {err}")
        del got, want, long
        torch.cuda.empty_cache()

        # pitch on bench.py's tones
        p_rng = np.random.RandomState(0)
        t = np.arange(PITCH_SECONDS * RATE) / RATE
        tones = torch.tensor(np.stack(
            [np.sin(2 * np.pi * (100.0 + 9.0 * b) * t) + 0.05 * p_rng.randn(t.size)
             for b in range(PITCH_BATCH)]).astype(np.float32), device=dev)
        lens = torch.full((PITCH_BATCH,), t.size, device=dev)
        got, got_valid = par.sharded_pitch_feats(tones, RATE, lens, mesh)
        want, want_valid = pitch.pitch_feats(tones, RATE, lengths=lens, return_valid=True)
        check(torch.equal(got.full_tensor(), want) and torch.equal(got_valid.full_tensor(), want_valid),
              "sharded_pitch_feats differs from pitch_feats")
        ms = cuda_ms(lambda: par.sharded_pitch_feats(tones, RATE, lens, mesh), reps=3)
        print(f"sharded_pitch_feats {PITCH_BATCH} x {PITCH_SECONDS} s: bitwise equal to "
              f"pitch_feats, valid counts equal; {ms:.3f} ms [{smi}]", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return counted


def frontend_phase(dev, smi):
    """Phase 16: the learnable frontends at bench.py's widths, 32 x 10 s.
    Returns the launches of the driven path (the exported computer)."""
    import torch

    from speech_tpu_torch import nn
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.filters import GaborFilterBank

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    n = SI_SECONDS * RATE
    rng = np.random.RandomState(16)
    x = torch.tensor((rng.randn(SI_BATCH, n) * 0.1).astype(np.float32), device=dev)
    full = np.full(SI_BATCH, n)

    def step_ms(module, loss_of, optimizer=None):
        def step():
            if optimizer is not None:
                optimizer.zero_grad()
            loss_of(module).backward()
            if optimizer is not None:
                optimizer.step()
        return cuda_ms(step, reps=3)

    original = computer(precision="double")
    original.params
    frontend = nn.STFTFrontend(original)
    with torch.no_grad():
        fwd = frontend(x)
    want, _ = computer().compute_batch(x, full)
    err = (fwd - want).abs().max().item()
    check(err <= TOL_FLOAT, f"STFTFrontend vs the plain 'highest' path: {err}")
    fwd_ms = cuda_ms(lambda: frontend(x))
    sgd = torch.optim.SGD(frontend.parameters(), lr=0.1)
    before, _ = original.compute_batch(x, full)
    sgd_ms = step_ms(frontend, lambda m: -m(x).mean(), sgd)  # the timed steps train it
    print(f"STFTFrontend (main config) {SI_BATCH} x {SI_SECONDS} s: vs the computer's plain "
          f"'highest' path max abs {err:.3e} (tol {TOL_FLOAT:g}); forward {fwd_ms:.3f} ms, "
          f"forward + backward + SGD step {sgd_ms:.3f} ms [{smi}]", flush=True)

    bank = GaborFilterBank("mel", num_filts=40, sampling_rate=RATE)
    for label, module in (("GaborFrontend-40", nn.GaborFrontend(bank, device=dev)),
                          ("SincFrontend-40", nn.SincFrontend(40, RATE, device=dev))):
        with torch.no_grad():
            out = module(x)
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite features")
        f_ms = cuda_ms(lambda: module(x), reps=3)
        fb_ms = step_ms(module, lambda m: m(x).mean())
        print(f"{label} {SI_BATCH} x {SI_SECONDS} s ({module.filter_size} taps): output "
              f"{tuple(out.shape)}; forward {f_ms:.3f} ms, forward + backward {fb_ms:.3f} ms "
              f"[{smi}]", flush=True)
        del out
    linear, _ = computer(use_log=False).compute_batch(x, full)
    pcen = nn.PCEN(linear.shape[-1], device=dev)
    out = pcen(linear)
    check(bool(torch.isfinite(out).all()), "PCEN: non-finite values")
    pcen_ms = step_ms(pcen, lambda m: m(linear).mean())
    print(f"PCEN on the linear fbank {tuple(linear.shape)}: forward + backward {pcen_ms:.3f} ms "
          f"[{smi}]", flush=True)
    del linear, out
    torch.cuda.empty_cache()

    # the trained frontend, exported at 'double'
    counted = {}
    (exported, _), _ = driven(counted, lambda: frontend.export_computer().compute_batch(x, full))
    check(counted["stft_feats_int8"] == 1, f"export_computer: launches {counted}")
    fresh = nn.STFTFrontend(computer(precision="double"))
    nn.params_from_jax(fresh, {k: v.detach().cpu().numpy() for k, v in frontend.named_parameters()})
    again, _ = fresh.export_computer().compute_batch(x, full)
    after, _ = original.compute_batch(x, full)
    with torch.no_grad():
        trained = frontend(x)
    moved = (exported - before).abs().max().item()
    err = (exported - trained).abs().max().item()
    print(f"export_computer after the 4 timed SGD steps, 'double': stft_feats_int8 x"
          f"{counted['stft_feats_int8']}; vs the trained frontend max abs {err:.3e}, moved "
          f"{moved:.3e} from the original; bitwise equal to a fresh export "
          f"{torch.equal(exported, again)}; original unchanged {torch.equal(after, before)} [{smi}]",
          flush=True)
    check(torch.equal(exported, again), "export_computer differs from a fresh export")
    check(torch.equal(after, before), "export_computer changed the original computer")
    check(err <= TOL_FLOAT and moved > 100 * TOL_FLOAT,
          f"export_computer does not follow the trained parameters ({err}, {moved})")
    return counted


class KeepGrads:
    """An optimizer for ``make_train_step`` whose step only keeps a copy of
    the gradients (``zero_grad`` then clears them as a real one's does)."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self):
        self.grads = [p.grad.detach().clone() for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None


def relative_grad_errs(model, got, want, top=3):
    """The largest gradient difference, each tensor's relative to its
    largest float64 gradient, and the ``top`` tensors by it."""
    errs = {name: ((g.cpu().double() - w).abs().max() / w.abs().max()).item()
            for (name, _), g, w in zip(model.named_parameters(), got, want)}
    ranked = sorted(errs.items(), key=lambda kv: -kv[1])[:top]
    return ranked[0][1], [(n, float(f"{e:.3e}")) for n, e in ranked]


@contextlib.contextmanager
def relu_pattern(masks, replay=False):
    """``torch.relu`` that appends each call's ``z > 0`` to ``masks``, or
    with ``replay`` applies the recorded ones in their order: ReLU's
    derivative jumps at 0, so a pre-activation within rounding of 0 would
    take different branches in float32 and float64 and move its column's
    gradient by up to about 1e-3; the float64 twin replays the card's."""
    import torch

    relu, pattern = torch.relu, iter(list(masks))

    def record(z):
        masks.append((z > 0).cpu())
        return relu(z)

    def apply(z):
        return z * next(pattern).to(device=z.device, dtype=z.dtype)

    torch.relu = apply if replay else record
    try:
        yield
    finally:
        torch.relu = relu


@contextlib.contextmanager
def tf32_allowed():
    """PyTorch's TF32 settings for the block (cuDNN's default; matmuls at
    'high'), whatever they were before."""
    import torch

    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def _tones(rng, batch, seconds, classes, noise=0.1):
    """``batch`` rows of ``seconds`` at RATE: class ``c`` a tone at 200 +
    300 c Hz plus noise; returns (float32 signals, labels)."""
    t = np.arange(seconds * RATE) / RATE
    labels = rng.randint(0, classes, size=batch)
    x = np.stack([0.3 * np.sin(2 * np.pi * (200.0 + 300.0 * c) * t + rng.uniform(0, 6.3))
                  + noise * rng.randn(t.size) for c in labels])
    return x.astype(np.float32), labels


def models_phase(dev, smi):
    """Phase 17: the model families at the reference's default widths.
    Returns the launches of the driven path (the 'double' preset)."""
    import torch

    from speech_tpu_torch import models, nn
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.serve import StreamPool

    counted = {}
    rng = np.random.RandomState(17)

    def frontend(device, dtype):
        comp = STFTFrameComputer(dict(BANK), device=device, **{**MAIN, "dtype": dtype})
        return nn.STFTFrontend(comp, dtype=dtype)

    def train(label, model, batch, out_of):
        """4 Adam steps (the loss finite and lower after them), the forward
        and step ms, one step traced, and on 2 rows the card's float32
        forward and ``make_train_step``'s gradients against the same
        parameters' float64 forward and gradients (with the card's ReLU
        pattern) on the CPU; the same gradients with TF32 allowed are
        printed beside them."""
        step = models.make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
        with torch.no_grad():
            before = model.loss(*batch)[0].item()
        for _ in range(4):
            step(*batch)
        with torch.no_grad():
            after = model.loss(*batch)[0].item()
        check(np.isfinite(before) and np.isfinite(after) and after < before,
              f"{label}: loss {before} -> {after} after 4 Adam steps")
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(batch[0], batch[1]))
        step_ms = cuda_ms(lambda: step(*batch), reps=3)
        _, n_k, busy, wall, top, _ = traced(lambda: step(*batch))
        twin = out_of(frontend("cpu", "float64"))
        with torch.no_grad():  # the same parameters, in float64 on the CPU
            for p, q in zip(model.parameters(), twin.parameters()):
                q.copy_(p.double().cpu())
        rows = [b[:2] for b in batch]
        host_rows = [r.cpu().double() if r.dtype == torch.float32 else r.cpu() for r in rows]
        errs = {}
        with torch.no_grad():
            f32 = model.frontend(rows[0], rows[1])
            f64 = twin.frontend(*host_rows[:2])
            errs["features"] = (f32.cpu().double() - f64).abs().max().item()
            got, want = model(*rows[:2]), twin(*host_rows[:2])
            if isinstance(got, tuple):  # CTC: log probabilities on valid frames, loss
                c = got[1].cpu()
                errs["log_probs"] = max(
                    (got[0][i, : c[i]].cpu().double() - want[0][i, : c[i]]).abs().max().item()
                    for i in range(2))
                g_loss = model.loss(*rows)[1]["per_example"].cpu().double()
                w_loss = twin.loss(*host_rows)[1]["per_example"]
                errs["per-example loss (relative)"] = ((g_loss - w_loss).abs() / w_loss.abs()).max().item()
            else:
                errs["output"] = (got.cpu().double() - want).abs().max().item()
        keep, masks = KeepGrads(model.parameters()), []
        with relu_pattern(masks):
            models.make_train_step(model, keep)(*rows)
        with relu_pattern(masks, replay=True):
            twin.loss(*host_rows)[0].backward()
        want_grads = [q.grad for q in twin.parameters()]
        grad_err, grad_top = relative_grad_errs(model, keep.grads, want_grads)
        with tf32_allowed():  # the control: the backward outside ieee_float32
            model.loss(*rows)[0].backward()
        tf32_err, tf32_top = relative_grad_errs(
            model, [p.grad for p in model.parameters()], want_grads)
        model.zero_grad()
        print(f"{label}: loss {before:.4f} -> {after:.4f} after 4 Adam steps; forward "
              f"{fwd_ms:.3f} ms, make_train_step (Adam) {step_ms:.3f} ms; one step traced: "
              f"{n_k} kernels, device busy {busy:.3f} ms of its {wall:.3f} ms wall, top {top}; "
              f"float32 card vs float64 CPU on 2 rows: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {TOL_FLOAT:g}); make_train_step's gradients {grad_err:.3e} of each "
              f"tensor's largest {grad_top} (tol {TOL_GRAD:g}; with TF32 allowed "
              f"{tf32_err:.3e} {tf32_top}) [{smi}]", flush=True)
        for k, v in errs.items():
            check(v <= TOL_FLOAT, f"{label}: {k} {v} from float64")
        check(grad_err <= TOL_GRAD, f"{label}: gradients {grad_err} from float64")
        return step

    # KWS: 32 x 1 s, 10 classes
    x, labels = _tones(rng, 32, 1, 10)
    kws_batch = (torch.tensor(x, device=dev), torch.full((32,), x.shape[1], device=dev),
                 torch.tensor(labels, device=dev))

    def kws_of(fe):
        return models.KWSModel(fe, num_classes=10, channels=(64, 64),
                               generator=torch.Generator().manual_seed(1))

    kws = kws_of(frontend(dev, "float32"))
    kws_step = train("KWSModel fbank-41, channels (64, 64), 10 classes, 32 x 1 s", kws,
                     kws_batch, kws_of)

    # speaker: 32 x 3 s, 10 speakers
    x, labels = _tones(rng, 32, 3, 10)
    spk_batch = (torch.tensor(x, device=dev), torch.full((32,), x.shape[1], device=dev),
                 torch.tensor(labels, device=dev))

    def spk_of(fe):
        return models.SpeakerModel(fe, num_speakers=10, embed_dim=192, channels=(128, 128, 128),
                                   generator=torch.Generator().manual_seed(2))

    train("SpeakerModel TDNN (128, 128, 128), embed 192, 32 x 3 s", spk_of(frontend(dev, "float32")),
          spk_batch, spk_of)

    # CTC: 16 x 10 s, vocabulary 28
    x, _ = _tones(rng, 16, 10, 28)
    lab_len = rng.randint(20, 61, size=16)
    labs = np.zeros((16, 60), np.int64)
    for i, n in enumerate(lab_len):
        labs[i, :n] = rng.randint(1, 29, size=n)
    ctc_batch = (torch.tensor(x, device=dev), torch.full((16,), x.shape[1], device=dev),
                 torch.tensor(labs, device=dev), torch.tensor(lab_len, device=dev))

    def ctc_of(fe):
        return models.CTCModel(fe, vocab_size=28, model_dim=128, num_layers=2, num_heads=4,
                               ffn_dim=512, generator=torch.Generator().manual_seed(3))

    ctc = ctc_of(frontend(dev, "float32"))
    train("CTCModel dim 128, 2 layers, 4 heads, FFN 512, vocabulary 28, 16 x 10 s", ctc,
          ctc_batch, ctc_of)
    # the step's share of the loss: its recursion over frames, forward and
    # backward, on the model's log probabilities
    with torch.no_grad():
        aux = ctc.loss(*ctc_batch)[1]
    frames = aux["log_probs"].shape[1]
    leaf = aux["log_probs"].clone().requires_grad_()
    logit_pad = (torch.arange(frames, device=dev)[None] >= aux["counts"][:, None]).float()
    label_pad = (torch.arange(labs.shape[1], device=dev)[None] >= ctc_batch[3][:, None]).float()

    def ctc_loss_alone():
        leaf.grad = None
        models.ctc.ctc_loss(leaf, logit_pad, ctc_batch[2], label_pad).mean().backward()

    _, n_k, busy, wall, _, _ = traced(ctc_loss_alone)
    print(f"CTC loss alone (the recursion over {frames} frames, forward + backward): "
          f"{cuda_ms(ctc_loss_alone, reps=3):.3f} ms; traced: {n_k} kernels, device busy "
          f"{busy:.3f} ms of its {wall:.3f} ms wall [{smi}]", flush=True)

    # StreamingKWS: 16 sessions of 1 s in a pool, ticks under the sync check
    skws = models.StreamingKWS(kws, window_frames=128, chunk_size=STREAM_CHUNK)
    pool = StreamPool(skws, slots=STREAM_SESSIONS)
    sigs = kws_batch[0][:STREAM_SESSIONS].cpu().numpy()
    handles = [pool.open() for _ in range(STREAM_SESSIONS)]
    for h, sig in zip(handles, sigs):
        pool.feed(h, sig)
    pool.warmup(depths=(1,))
    ticks = []
    rows = {h: [] for h in handles}
    while any(len(pool._sessions[h].pending) for h in handles):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_sync():
            pending = pool._queue_tick(max_chunks=1)
        for h, r in pool._finish_tick(pending):
            rows[h].append(r)
        ticks.append((time.perf_counter() - t0) * 1e3)
    for h, r in pool.close_many(handles):
        rows[h].append(r)
    with torch.no_grad():
        want = kws(kws_batch[0][:STREAM_SESSIONS], kws_batch[1][:STREAM_SESSIONS]).cpu().numpy()
    err = max(np.abs(np.concatenate(rows[h])[-1] - want[i]).max() for i, h in enumerate(handles))
    print(f"StreamingKWS in a StreamPool of {STREAM_SESSIONS} sessions x 1 s, chunk "
          f"{STREAM_CHUNK}: {len(ticks)} ticks queued no host sync, tick latency (one readback) "
          f"median {statistics.median(ticks):.3f} ms; close rows vs the model on the whole "
          f"signal max abs {err:.3e} (tol {TOL_FLOAT:g}) [{smi}]", flush=True)
    check(err <= TOL_FLOAT, f"StreamingKWS pool vs the batch model: {err}")

    # a train-state round trip on the card, bitwise
    opt = torch.optim.Adam(kws.parameters(), lr=1e-3)
    step = models.make_train_step(kws, opt)
    step(*kws_batch)
    with tempfile.TemporaryDirectory() as tmp:
        with models.TrainCheckpointer(tmp) as ckpt:
            ckpt.save(1, kws, opt, extra={"epoch": 3})
        twin = kws_of(frontend(dev, "float32"))
        twin_opt = torch.optim.Adam(twin.parameters(), lr=1e-3)
        with models.TrainCheckpointer(tmp) as ckpt:
            at, _, _, extra = ckpt.restore(like=(twin, twin_opt))
    same = all(torch.equal(a, b) for a, b in zip(kws.parameters(), twin.parameters()))
    models.make_train_step(twin, twin_opt)(*kws_batch)
    step(*kws_batch)
    resumed = all(torch.equal(a, b) for a, b in zip(kws.parameters(), twin.parameters()))
    print(f"TrainCheckpointer round trip on the card: step {at}, extra {extra}, parameters "
          f"bitwise equal {same}, one more Adam step from each bitwise equal {resumed}", flush=True)
    check(same and resumed and at == 1 and extra == {"epoch": 3}, "checkpoint round trip")

    # the flagship preset at 'double': one B2 launch
    preset = models.create("fbank-energy-41-16k", precision="double", device=dev)
    (feats, counts), got = driven(counted, lambda: preset.compute_batch(kws_batch[0], kws_batch[1]))
    plain = models.create("fbank-energy-41-16k", precision="double", fft_mode="matmul", device=dev)
    ref, _ = plain.compute_batch(kws_batch[0], kws_batch[1])
    err = (feats - ref).abs().max().item()
    print(f"preset fbank-energy-41-16k at 'double' on 32 x 1 s: stft_feats_int8 x"
          f"{got['stft_feats_int8']}, vs the plain digit route max abs {err:.3e} "
          f"(tol {TOL_INT8:g})", flush=True)
    check(got["stft_feats_int8"] == 1 and err <= TOL_INT8, f"preset at 'double': {got}, {err}")
    return counted


SERVE_UTTS, SERVE_THREADS, SERVE_BATCH = 256, 4, 64  # phases 18 and 22's burst


def burst_inputs(dev, _cache={}):
    """The serving burst (phases 18 and 22, made once): 256 ragged
    utterances of 1-15 s from a seed, their seconds of audio, and each
    utterance's features alone on the plain digit route ('double' at
    ``fft_mode="matmul"``, which launches no kernel)."""
    if "utts" not in _cache:
        from speech_tpu_torch.compute import STFTFrameComputer

        rng = np.random.RandomState(18)
        utts = [(rng.randn(rng.randint(RATE, SECONDS * RATE + 1)) * 0.1).astype(np.float32)
                for _ in range(SERVE_UTTS)]
        ref = STFTFrameComputer(dict(BANK), device=dev, precision="double", fft_mode="matmul",
                                **MAIN)
        check(ref._use_kernel(dev) is None, "the reference computer takes a kernel route")
        own, got = driven({}, lambda: [ref.compute_batch(u[None], [u.size])[0][0].cpu().numpy()
                                        for u in utts])
        check(not any(got.values()), f"the plain reference launched {got}")
        _cache.update(utts=utts, audio=sum(u.size for u in utts) / RATE, own=own)
    return _cache["utts"], _cache["audio"], _cache["own"]


def burst(server, utts):
    """Every utterance submitted to ``server`` from SERVE_THREADS client
    threads (utterance ``i`` from thread ``i % SERVE_THREADS``); the
    results in order."""
    import threading

    out = [None] * len(utts)

    def client(k):
        futs = [(i, server.submit(utts[i])) for i in range(k, len(utts), SERVE_THREADS)]
        for i, f in futs:
            out[i] = f.result()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def burst_err(outs, own):
    """Max abs of served rows against each utterance alone (inf on a
    shape mismatch)."""
    return max(np.abs(o - own[i]).max() if o.shape == own[i].shape else np.inf
               for i, o in enumerate(outs))


def host_spans(obj, names):
    """Time the host calls ``names`` of ``obj`` (the profiler records the
    ops of its own thread only): their ms, by name, appended as they
    return."""
    spans = {name: [] for name in names}
    for name, ms in spans.items():
        def timed(*args, _fn=getattr(obj, name), _ms=ms, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                _ms.append((time.perf_counter() - t0) * 1e3)
        setattr(obj, name, timed)
    return spans


def span_summary(spans):
    """(count, summed ms, longest ms) of each timed call."""
    return {k: (len(v), round(sum(v), 3), round(max(v), 3) if v else 0.0)
            for k, v in spans.items()}


def stream_sessions(server, sigs):
    """Every session of ``sigs`` opened on ``server`` and fed from a thread
    of its own in ragged pieces, then closed; each session's rows."""
    import threading

    handles = [server.open_session() for _ in sigs]

    def feeder(h, sig):
        r = np.random.RandomState(h)
        i = 0
        while i < sig.size:
            k = int(r.randint(400, 3200))
            server.feed(h, sig[i: i + k])
            i += k
        server.close_session(h)

    threads = [threading.Thread(target=feeder, args=(h, s)) for h, s in zip(handles, sigs)]
    for t in threads:
        t.start()
    rows = [np.concatenate(list(server.iter_results(h))) for h in handles]
    for t in threads:
        t.join()
    return rows


def stream_err(rows, sigs, plain):
    err = 0.0
    for i, (out, sig) in enumerate(zip(rows, sigs)):
        want = plain.compute_full(sig)
        check(out.shape == want.shape, f"StreamServer session {i}: {out.shape} != {want.shape}")
        err = max(err, np.abs(out - want).max())
    return err


def serving_phase(dev, smi):
    """Phase 18: FeatureServer through B2 and StreamServer with threaded
    sessions.  Returns the launches of the driven path (the burst)."""
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.serve import FeatureServer, StreamServer

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    counted = {}
    n_max = SECONDS * RATE
    utts, audio, own = burst_inputs(dev)
    rng = np.random.RandomState(181)
    comp = computer(precision="double")
    comp.params

    def traced_burst(server, spans):
        for ms in spans.values():
            ms.clear()
        out = traced(lambda: burst(server, utts))
        return out + (span_summary(spans),)

    with FeatureServer(comp, max_batch=SERVE_BATCH, max_wait_ms=2.0) as server:
        spans = host_spans(server._extractor, ("_dispatch", "_collect"))
        server.warmup([n_max])
        # burst 1 (the first after the warm-up) and burst 2, each traced:
        # device busy and wall time of the same burst, and the dispatcher's
        # host calls (count, summed ms, longest ms)
        traces = [traced_burst(server, spans) for _ in range(2)]
        # burst 3, untraced: the launches counted from 0, the throughput
        batches = server.stats["batches"]
        t0 = time.perf_counter()
        outs, launched = driven(counted, lambda: burst(server, utts))
        wall = time.perf_counter() - t0
        stats = dict(server.stats)
        err = max(burst_err(t[0], own) for t in traces + [(outs,)])
        lone = []
        for i in range(100):
            u = utts[i % 16]
            t1 = time.perf_counter()
            server.extract(u)
            lone.append((time.perf_counter() - t1) * 1e3)
    print(f"FeatureServer at 'double', {SERVE_THREADS} client threads x "
          f"{SERVE_UTTS // SERVE_THREADS} ragged utterances of 1-{SECONDS} s "
          f"({audio:.0f} s of audio) a burst: max abs vs each utterance alone on the plain digit "
          f"route {err:.3e} (tol {TOL_INT8:g}); stats after 3 bursts {stats}; burst 3 "
          f"(untraced): stft_feats_int8 x{launched['stft_feats_int8']} for "
          f"{stats['batches'] - batches} micro-batches, {audio / wall:.0f} audio-s/s "
          f"({wall * 1e3:.1f} ms); lone request latency p50 {np.percentile(lone, 50):.3f} ms, "
          f"p99 {np.percentile(lone, 99):.3f} ms [{smi}]", flush=True)
    for k, (_, n_k, busy, t_wall, top, host, calls) in enumerate(traces, 1):
        print(f"FeatureServer burst {k} under the profiler: {audio / t_wall * 1e3:.0f} audio-s/s "
              f"({t_wall:.1f} ms wall), {n_k} kernels, device busy {busy:.3f} ms, idle "
              f"{100 * (1 - busy / t_wall):.1f}% of this burst's wall; the dispatcher's host "
              f"calls (count, ms, longest ms) {calls}; top kernels {top}; top host events "
              f"{host} [{smi}]", flush=True)
    check(err <= TOL_INT8, f"FeatureServer vs the plain route: {err}")
    check(stats["failed"] == 0 and stats["completed"] == 3 * len(utts),
          f"FeatureServer stats {stats}")
    check(launched["stft_feats_int8"] == stats["batches"] - batches,
          f"B2 launches {launched['stft_feats_int8']} != batches {stats['batches'] - batches}")

    # StreamServer: 16 threaded sessions of StreamingSTFT
    plain = computer()
    sigs = [(rng.randn(rng.randint(3 * RATE, 6 * RATE)) * 0.1).astype(np.float32)
            for _ in range(STREAM_SESSIONS)]
    t0 = time.perf_counter()
    with StreamServer(plain, slots=STREAM_SESSIONS, chunk_size=STREAM_CHUNK) as server:
        rows = stream_sessions(server, sigs)
    wall = time.perf_counter() - t0
    err = stream_err(rows, sigs, plain)
    audio = sum(s.size for s in sigs) / RATE
    print(f"StreamServer {STREAM_SESSIONS} threaded sessions of StreamingSTFT ({audio:.0f} s of "
          f"audio, ragged feeds): rows vs compute_full max abs {err:.3e} (tol {TOL_FLOAT:g}); "
          f"{wall * 1e3:.1f} ms wall [{smi}]", flush=True)
    check(err <= TOL_FLOAT, f"StreamServer vs compute_full: {err}")
    return counted


def group_serving_phase(dev, smi):
    """Phase 22: both servers on a world-size-1 NCCL group, through the
    relay (rank 0, the front, sends each micro-batch's header, scatters its
    rows to itself, runs them and gathers them back), in turns with the
    meshless servers on the same card.  Returns the launches of the driven
    path (a group burst)."""
    import torch.distributed as dist

    from speech_tpu_torch import parallel as par
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.parallel import multihost
    from speech_tpu_torch.serve import FeatureServer, StreamServer

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    counted = {}
    utts, audio, own = burst_inputs(dev)
    comp = computer(precision="double")
    tmp = tempfile.mkdtemp()
    multihost.initialize(store=dist.FileStore(os.path.join(tmp, "store"), 1),
                         num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = par.make_mesh(("data",))
        servers = {"meshless": FeatureServer(comp, max_batch=SERVE_BATCH, max_wait_ms=2.0),
                   "group": FeatureServer(comp, mesh=mesh, max_batch=SERVE_BATCH,
                                          max_wait_ms=2.0)}
        check(servers["group"]._relay is not None and servers["meshless"]._relay is None,
              "the group server takes no relay")
        spans = {k: host_spans(srv, ("_launch", "_readback")) for k, srv in servers.items()}
        relay_spans = host_spans(servers["group"]._relay, ("send", "scatter", "agree", "gather"))
        for srv in servers.values():  # the first bursts pay pinned host allocations
            srv.warmup([SECONDS * RATE])
            burst(srv, utts)
        walls = {k: [] for k in servers}
        err = 0.0
        for ms in [*spans["meshless"].values(), *spans["group"].values(),
                   *relay_spans.values()]:
            ms.clear()
        for name in ("meshless", "group", "group", "meshless") * 2:
            t0 = time.perf_counter()
            outs = burst(servers[name], utts)
            walls[name].append(round((time.perf_counter() - t0) * 1e3, 3))
            err = max(err, burst_err(outs, own))
        calls = {k: span_summary(v) for k, v in spans.items()}
        relay_calls = span_summary(relay_spans)
        group = servers["group"]
        batches = group.stats["batches"]
        outs, launched = driven(counted, lambda: burst(group, utts))
        err = max(err, burst_err(outs, own))
        stats = dict(group.stats)
        for srv in servers.values():
            srv.close()
        ms = {k: statistics.median(v) for k, v in walls.items()}
        print(f"FeatureServer on a world-size-1 NCCL group (the relay: header, scatter to the "
              f"front, run, gather to the front) against the meshless server on the same card, "
              f"{SERVE_UTTS} ragged utterances of 1-{SECONDS} s ({audio:.0f} s of audio) from "
              f"{SERVE_THREADS} threads, in turns (meshless, group, group, meshless) x 2: group "
              f"{walls['group']} ms (median {ms['group']:.3f}, "
              f"{audio / ms['group'] * 1e3:.0f} audio-s/s), meshless {walls['meshless']} ms "
              f"(median {ms['meshless']:.3f}, {audio / ms['meshless'] * 1e3:.0f} audio-s/s), "
              f"group - meshless {ms['group'] - ms['meshless']:.3f} ms a burst; over those "
              f"bursts the dispatcher's host calls (count, ms, longest ms) {calls} and the "
              f"group's relay calls {relay_calls}; a last, "
              f"counted group burst: stft_feats_int8 x{launched['stft_feats_int8']} for "
              f"{stats['batches'] - batches} micro-batches; max abs vs each utterance alone on "
              f"the plain digit route {err:.3e} (tol {TOL_INT8:g}) [{smi}]", flush=True)
        check(err <= TOL_INT8, f"the group FeatureServer vs the plain route: {err}")
        check(stats["failed"] == 0 and stats["completed"] == 6 * len(utts),
              f"the group FeatureServer's stats {stats}")
        check(launched["stft_feats_int8"] == stats["batches"] - batches > 0,
              f"group B2 launches {launched['stft_feats_int8']} != batches "
              f"{stats['batches'] - batches}")

        # StreamServer: 16 threaded sessions over the same group and without
        # a mesh, in turns, each after its warm-up (on the group the first
        # warm-up pays the slot gather's first call)
        plain = computer()
        rng = np.random.RandomState(22)
        sigs = [(rng.randn(rng.randint(3 * RATE, 6 * RATE)) * 0.1).astype(np.float32)
                for _ in range(STREAM_SESSIONS)]
        walls, warm = {"group": [], "meshless": []}, {"group": [], "meshless": []}
        errs = {"group": 0.0, "meshless": 0.0}
        for name in ("meshless", "group", "group", "meshless"):
            kw = dict(mesh=mesh) if name == "group" else {}
            with StreamServer(plain, slots=STREAM_SESSIONS, chunk_size=STREAM_CHUNK, **kw) as srv:
                check((srv._relay is not None) == (name == "group"), f"{name} StreamServer relay")
                t0 = time.perf_counter()
                srv.warmup()
                warm[name].append(round((time.perf_counter() - t0) * 1e3, 3))
                t0 = time.perf_counter()
                rows = stream_sessions(srv, sigs)
                walls[name].append(round((time.perf_counter() - t0) * 1e3, 3))
            errs[name] = max(errs[name], stream_err(rows, sigs, plain))
        audio = sum(s.size for s in sigs) / RATE
        print(f"StreamServer {STREAM_SESSIONS} threaded sessions of StreamingSTFT ({audio:.0f} s "
              f"of audio, ragged feeds), in turns: on the world-size-1 NCCL group rows vs "
              f"compute_full max abs {errs['group']:.3e} (tol {TOL_FLOAT:g}), {walls['group']} ms "
              f"wall after warm-ups of {warm['group']} ms; without a mesh {errs['meshless']:.3e}, "
              f"{walls['meshless']} ms after warm-ups of {warm['meshless']} ms [{smi}]",
              flush=True)
        for name, e in errs.items():
            check(e <= TOL_FLOAT, f"{name} StreamServer vs compute_full: {e}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return counted


def trace_device_ms(trace_dir):
    """Device ms by category (kernels, copies, memsets) in the one Chrome
    trace that ``--profile DIR`` wrote into ``trace_dir``, and the ms its
    events span."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"--profile wrote {len(files)} traces into {trace_dir}")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e and "dur" in e]
    out = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
    for e in events:
        if e.get("cat") in out:
            out[e["cat"]] += e["dur"] / 1e3
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return out, span


def cli_phase(dev, smi, tmp):
    """Phase 19: the corpus CLIs through ``command_line.main``, in process,
    on a corpus of wav files written under ``tmp`` (``map.txt``, ``wavs/``;
    the 'double' run's files in ``b2/``, which phase 20 reads; the caller
    removes ``tmp``).  Returns the launches of the driven paths."""
    import io

    import torch

    from speech_tpu_torch import command_line
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.corpus import FeatureCorpus
    from speech_tpu_torch.io import kaldi_tables as kt
    from speech_tpu_torch.ops import invert

    counted = {}
    rng = np.random.RandomState(19)
    main_cfg = {"name": "stft", "bank": dict(BANK), **MAIN}

    def cfg(**kw):
        return json.dumps({**main_cfg, **kw})

    def run(*argv):
        """``main(argv)`` with its launches counted: (stderr, launches, wall s)."""
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc, got = driven(counted, lambda: command_line.main(list(argv)))
        wall = time.perf_counter() - t0
        check(rc == 0, f"{argv[0]} returned {rc}: {err.getvalue()[-2000:]}")
        return err.getvalue(), got, wall

    def pt(directory, utt):
        return torch.load(os.path.join(directory, utt + ".pt"))

    # 256 ragged 1-15 s int16 wavs of noise with 1-3 digitally silent
    # gaps of 0.2-1 s each (so that --vad-trim drops frames; no frame
    # has an energy near its threshold)
    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    map_path = os.path.join(tmp, "map.txt")
    pcms = {}
    with open(map_path, "w") as mf:
        for i in range(CLI_UTTS):
            n = rng.randint(RATE, SECONDS * RATE + 1)
            pcm = np.clip(rng.randn(n) * 3000, -32767, 32767).astype(np.int16)
            for _ in range(rng.randint(1, 4)):
                g = rng.randint(RATE // 5, RATE + 1)
                start = rng.randint(0, max(n - g, 1))
                pcm[start: start + g] = 0
            utt = f"utt{i:03d}"
            path = os.path.join(wav_dir, utt + ".wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(RATE)
                w.writeframes(pcm.tobytes())
            mf.write(f"{utt} {path}\n")
            pcms[utt] = pcm
    utts = sorted(pcms)
    audio = sum(p.size for p in pcms.values()) / RATE
    n_batches = -(-CLI_UTTS // CLI_BATCH)

    # signals-to-torch-feat-dir at 'double' (B2), traced, then untraced
    b2_dir, trace_dir = os.path.join(tmp, "b2"), os.path.join(tmp, "trace")
    err, got, wall = run("signals-to-torch-feat-dir", map_path, cfg(precision="double"), b2_dir,
                         "--batch-size", str(CLI_BATCH), "--num-workers", "4",
                         "--profile", trace_dir)
    split = [line for line in err.splitlines() if line.startswith("stages")]
    check(got["stft_feats_int8"] == n_batches,
          f"B2 launched {got['stft_feats_int8']} times for {n_batches} batches")
    dev_ms, span = trace_device_ms(trace_dir)
    busy = sum(dev_ms.values())
    err2, got2, wall2 = run("signals-to-torch-feat-dir", map_path, cfg(precision="double"),
                            os.path.join(tmp, "b2_untraced"), "--batch-size", str(CLI_BATCH),
                            "--num-workers", "4", "--profile")
    split2 = [line for line in err2.splitlines() if line.startswith("stages")]
    check(got2["stft_feats_int8"] == n_batches, f"untraced run: B2 launched {got2}")
    ref = STFTFrameComputer(dict(BANK), device=dev, precision="double", fft_mode="matmul",
                            **MAIN)
    check(ref._use_kernel(dev) is None, "the reference computer takes a kernel route")
    own, plain_got = driven({}, lambda: {
        u: ref.compute_batch(pcms[u][None], [pcms[u].size])[0][0].cpu().numpy() for u in utts})
    check(not any(plain_got.values()), f"the plain reference launched {plain_got}")
    err_b2, same = 0.0, True
    for u in utts:
        f = pt(b2_dir, u)
        check(f.dtype == torch.float32 and f.device.type == "cpu" and f.shape == own[u].shape,
              f"{u}: {f.dtype} {f.device} {tuple(f.shape)} vs {own[u].shape}")
        err_b2 = max(err_b2, np.abs(f.numpy() - own[u]).max())
        same &= torch.equal(f, pt(os.path.join(tmp, "b2_untraced"), u))
    print(f"signals-to-torch-feat-dir 'double' on {CLI_UTTS} wav files ({audio:.0f} s of "
          f"audio), batches of {CLI_BATCH}, 4 reader threads, traced: {wall:.3f} s files to "
          f"files, {audio / wall:.0f} audio-s/s; {split[-1] if split else 'no split'}; "
          f"stft_feats_int8 x{got['stft_feats_int8']}; device busy {busy:.3f} ms "
          f"({ {k: round(v, 3) for k, v in dev_ms.items()} }), idle "
          f"{100 * (1 - busy / (wall * 1e3)):.1f}% of the run's wall, "
          f"{100 * (1 - busy / span):.1f}% of the {span:.1f} ms its trace spans; untraced: "
          f"{wall2:.3f} s, {audio / wall2:.0f} audio-s/s; "
          f"{split2[-1] if split2 else 'no split'}; files vs each utterance alone on the "
          f"plain digit route max abs {err_b2:.3e} (tol {TOL_INT8:g}); the two runs' files "
          f"bitwise equal {same} [{smi}]", flush=True)
    check(err_b2 <= TOL_INT8, f"signals-to-torch-feat-dir 'double' vs the plain route: {err_b2}")
    check(same, "the traced and untraced runs wrote different files")
    check(busy > 0, "the trace holds no device time")

    # B1 with deltas and --vad-trim, against the same command on the
    # plain path
    extra = ["--batch-size", str(CLI_BATCH), "--num-workers", "4", "--postprocess",
             json.dumps([{"name": "deltas", "num_deltas": 2}]), "--vad-trim", "{}"]
    b1_dir, plain_dir = os.path.join(tmp, "b1"), os.path.join(tmp, "plain")
    _, got_b1, wall_b1 = run("signals-to-torch-feat-dir", map_path, cfg(fft_mode="pallas"),
                             b1_dir, *extra)
    check(got_b1["stft_feats_rows"] == n_batches,
          f"B1 launched {got_b1['stft_feats_rows']} times for {n_batches} batches")
    _, got_plain, wall_plain = run("signals-to-torch-feat-dir", map_path,
                                   cfg(fft_mode="matmul"), plain_dir, *extra)
    # the extractor lays each packed batch out on the card: its one launch
    # a batch, and no feature kernel
    feats_plain = {k: v for k, v in got_plain.items() if k != "layout_rows"}
    check(not any(feats_plain.values()) and got_plain["layout_rows"] == n_batches,
          f"the plain path launched {got_plain}")
    err_b1, kept, frames = 0.0, 0, 0
    for u in utts:
        a, b = pt(b1_dir, u).numpy(), pt(plain_dir, u).numpy()
        check(a.shape == b.shape and a.shape[1] == 3 * 41, f"{u}: {a.shape} vs {b.shape}")
        err_b1 = max(err_b1, np.abs(a - b).max(initial=0.0))  # all-silent: 0 rows
        kept += a.shape[0]
        frames += own[u].shape[0]
    print(f"signals-to-torch-feat-dir fft_mode='pallas' (B1 x{got_b1['stft_feats_rows']}) "
          f"+ deltas(2) + --vad-trim: {wall_b1:.3f} s ({audio / wall_b1:.0f} audio-s/s), "
          f"plain path {wall_plain:.3f} s; VAD kept {kept} of {frames} frames; vs the plain "
          f"path max abs {err_b1:.3e} (tol {TOL_FLOAT:g}) [{smi}]", flush=True)
    check(err_b1 <= TOL_FLOAT, f"B1 CLI run vs the plain path: {err_b1}")
    check(0 < kept < frames, f"--vad-trim kept {kept} of {frames} frames")

    # Kaldi tables: a scp of the same files -> ark at 'double', then
    # copy-feats-tables ark -> dir: -> ark
    scp = os.path.join(tmp, "wav.scp")
    with open(scp, "w") as f:
        f.writelines(f"{u} {os.path.join(wav_dir, u + '.wav')}\n" for u in utts)
    ark = os.path.join(tmp, "feats.ark")
    _, got_k, wall_k = run("compute-feats-from-kaldi-tables", "scp:" + scp, "ark:" + ark,
                           cfg(precision="double"), "--batch-size", str(CLI_BATCH))
    check(got_k["stft_feats_int8"] == n_batches, f"compute-feats-from-kaldi-tables: {got_k}")
    table = dict(kt.iter_table("ark:" + ark))
    check(list(table) == utts, "the feature table's keys")
    check(all(np.array_equal(table[u], pt(b2_dir, u).numpy()) for u in utts),
          "compute-feats-from-kaldi-tables differs from signals-to-torch-feat-dir")
    copy_dir, ark2 = os.path.join(tmp, "copied"), os.path.join(tmp, "copied.ark")
    run("copy-feats-tables", "ark:" + ark, "dir:" + copy_dir)
    run("copy-feats-tables", "dir:" + copy_dir, "ark:" + ark2)
    copied = dict(kt.iter_table("ark:" + ark2))
    check(list(copied) == utts and all(np.array_equal(copied[u], table[u]) for u in utts),
          "copy-feats-tables ark -> dir -> ark is not bitwise")
    print(f"compute-feats-from-kaldi-tables scp -> ark at 'double' (B2 "
          f"x{got_k['stft_feats_int8']}): {wall_k:.3f} s, {audio / wall_k:.0f} audio-s/s, "
          f"bitwise equal to the .pt files; copy-feats-tables ark -> dir -> ark bitwise "
          f"[{smi}]", flush=True)

    # torch-feat-dir-to-signals on 8 of the files, 4 iterations: its
    # wavs against feats_to_signal on the same buckets of 16 rows (the
    # command's batches), and the distance from float64 on the CPU
    inv_src, inv_out = os.path.join(tmp, "inv_feats"), os.path.join(tmp, "inv_wavs")
    os.makedirs(inv_src)
    for u in utts[:8]:
        shutil.copy(os.path.join(b2_dir, u + ".pt"), inv_src)
    _, _, wall_inv = run("torch-feat-dir-to-signals", inv_src, cfg(), inv_out,
                         "--n-iters", "4")
    inv_comp = STFTFrameComputer(dict(BANK), device=dev, **MAIN)
    f64 = STFTFrameComputer(dict(BANK), **{**MAIN, "dtype": "float64"}, device="cpu")
    shift = f64.frame_shift
    buckets = {}
    for u in utts[:8]:
        f = pt(b2_dir, u).numpy()
        buckets.setdefault(1 << (f.shape[0] - 1).bit_length(), []).append((u, f))
    same_inv, err64 = True, 0.0
    for t_pad, group in buckets.items():
        batch = np.zeros((16, t_pad, 41), np.float32)
        counts = np.zeros(16, np.int32)
        for i, (_, f) in enumerate(group):
            batch[i, : f.shape[0]], counts[i] = f, f.shape[0]
        ys = invert.feats_to_signal(
            torch.from_numpy(batch).to(dev), inv_comp, n_iters=4, length=t_pad * shift,
            lengths=torch.from_numpy(counts).to(dev)).cpu().numpy()
        for i, (u, f) in enumerate(group):
            with wave.open(os.path.join(inv_out, u + ".wav")) as w:
                check(w.getframerate() == RATE, f"{u}.wav: rate {w.getframerate()}")
                got_pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            want = np.clip(np.round(ys[i, : f.shape[0] * shift]), -32767, 32767)
            same_inv &= got_pcm.shape == want.shape and np.array_equal(got_pcm, want)
            y64 = invert.feats_to_signal(torch.from_numpy(f).double()[None], f64, n_iters=4)
            pcm64 = np.clip(np.round(y64[0].numpy()), -32767, 32767)
            err64 = max(err64, np.abs(got_pcm - pcm64).max() / 32768.0)
    print(f"torch-feat-dir-to-signals 8 files, 4 iterations: {wall_inv:.3f} s; wavs bitwise "
          f"equal to feats_to_signal on the card on the same batches: {same_inv}; max abs "
          f"from float64 feats_to_signal (CPU) {err64:.3e} of int16 full scale [{smi}]",
          flush=True)
    check(same_inv, "torch-feat-dir-to-signals differs from feats_to_signal")

    # FeatureCorpus at 'double', then in feature-file mode over the .pt dir
    utt2path = [(u, os.path.join(wav_dir, u + ".wav")) for u in utts]
    t0 = time.perf_counter()
    batches, got_c = driven(counted, lambda: list(FeatureCorpus(
        json.loads(cfg(precision="double")), utt2path, num_workers=4)))
    wall_c = time.perf_counter() - t0
    check(got_c["stft_feats_int8"] == len(batches) == -(-CLI_UTTS // 32),
          f"FeatureCorpus: {len(batches)} batches, launches {got_c}")
    seen = {u: f for us, fs in batches for u, f in zip(us, fs)}
    check(sorted(seen) == utts and all(
        isinstance(seen[u], np.ndarray) and np.array_equal(seen[u], pt(b2_dir, u).numpy())
        for u in utts), "FeatureCorpus differs from the CLI's files")
    back = {u: f for us, fs in FeatureCorpus(
        None, [(u, os.path.join(b2_dir, u + ".pt")) for u in utts], batch_size=64)
        for u, f in zip(us, fs)}
    check(sorted(back) == utts and all(
        np.array_equal(back[u], pt(b2_dir, u).double().numpy()) for u in utts),
        "FeatureCorpus feature-file mode differs from the files")
    print(f"FeatureCorpus 'double' ({len(batches)} batches of 32, 4 reader threads, "
          f"stft_feats_int8 x{got_c['stft_feats_int8']}): {wall_c:.3f} s, "
          f"{audio / wall_c:.0f} audio-s/s, bitwise equal to the CLI's files; feature-file "
          f"mode reads them back bitwise [{smi}]", flush=True)
    return counted


SERVER_BURST = 16  # phase 20's FeatureServer requests


def _burst_utts():
    """Phase 20's server burst: 16 ragged 1-15 s utterances from a seed."""
    rng = np.random.RandomState(20)
    return [(rng.randn(rng.randint(RATE, SECONDS * RATE + 1)) * 0.1).astype(np.float32)
            for _ in range(SERVER_BURST)]


def cold_start_child(store_dir, work, t_spawn):
    """Phase 20's fresh process (``chip_smoke.py --cold-start-child STORE
    WORK T``): the main path's batch (``WORK/host.npy``) through
    ``ShardedExtractor(aot_dir=STORE)`` at 'double' (B2) and at
    ``fft_mode="pallas"`` (B1), one ``.sph`` file through the store's
    shorten decoder and a ``FeatureServer(aot_dir=STORE)`` burst; writes
    the features to WORK and prints, last, a JSON line of the store's
    stats, its builds' seconds, the compilers it found and the seconds
    from ``T`` (the parent's clock at the spawn) to its first feature."""
    marks = [("start", time.time())]  # the interpreter's start, to here
    import torch

    from speech_tpu_torch import aot, utils
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.io import _native, read_signal
    from speech_tpu_torch.parallel import ShardedExtractor
    from speech_tpu_torch.serve import FeatureServer

    marks.append(("imports", time.time()))
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    marks.append(("cuda context", time.time()))
    out = {"compilers": {c: aot.find_compiler(c) for c in ("nvcc", "g++")}}
    store = aot.AOTCache(store_dir)
    utils.enable_persistent_compilation_cache(store)  # the shorten decoder's store too

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    host = np.load(os.path.join(work, "host.npy"))
    full = np.full(host.shape[0], host.shape[1])
    marks.append(("input", time.time()))
    comp = computer(precision="double")
    comp.params
    marks.append(("host tables", time.time()))
    feats, _ = ShardedExtractor(comp, aot_dir=store).extract_batch(host, full)
    first = feats[0, 0].cpu()  # the first feature, on the host
    marks.append(("libraries + first batch", time.time()))
    out["first_feature_s"] = marks[-1][1] - t_spawn
    out["split_s"] = {name: round(t - prev, 3)
                      for (name, t), (_, prev) in zip(marks, [("spawn", t_spawn)] + marks)}
    check(bool(torch.isfinite(first).all()), "non-finite first feature")
    np.save(os.path.join(work, "b2.npy"), feats.cpu().numpy())
    feats, _ = ShardedExtractor(computer(fft_mode="pallas"), aot_dir=store).extract_batch(
        host, full)
    np.save(os.path.join(work, "b1.npy"), feats.cpu().numpy())
    sph = sorted(glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "tests", "audio", "*_shn.sph")))[0]
    out["shorten_native"] = _native.get_shorten_lib() is not None
    np.save(os.path.join(work, "sph.npy"), read_signal(sph))
    with FeatureServer(computer(precision="double"), max_batch=SERVER_BURST,
                       aot_dir=store) as server:
        futures = [server.submit(u) for u in _burst_utts()]
        answers = [f.result() for f in futures]
    np.savez(os.path.join(work, "server.npz"), *answers)
    out["stats"] = dict(store.stats)
    out["build_seconds"] = dict(store.build_seconds)
    print(json.dumps(out), flush=True)


def cold_start_phase(dev, smi, host, tmp):
    """Phase 20: the library store.  A fresh process on an empty store with
    the compilers reachable (it builds the four libraries: the cold
    start), then one on that store with no compiler reachable (the warm
    start), each against the parent's features on the same route and
    batch, bitwise; the CLI's ``--precompile`` and a run in a process
    without compilers against phase 19's files, bitwise; ``--aot-prune``
    on a planted orphan.  Returns the launches of the parent's driven
    paths."""
    import io

    import torch

    from speech_tpu_torch import command_line
    from speech_tpu_torch.aot import AOTCache
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.io import read_signal
    from speech_tpu_torch.parallel import ShardedExtractor

    here = os.path.dirname(os.path.abspath(__file__))
    counted = {}
    work, store = os.path.join(tmp, "cold"), os.path.join(tmp, "store")
    empty = os.path.join(tmp, "no_compilers")  # PATH and CUDA_HOME of the warm runs
    for d in (work, empty):
        os.makedirs(d)
    np.save(os.path.join(work, "host.npy"), host)
    no_compilers = {"PATH": empty, "CUDA_HOME": empty}

    def computer(**kw):
        return STFTFrameComputer(dict(BANK), device=dev, **{**MAIN, **kw})

    def child(label, env):
        t = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold-start-child", store, work, repr(t)],
            env=dict(os.environ, **env), capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"{label} child failed ({proc.returncode}): "
                                    f"{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        got["wall_s"] = time.time() - t
        got["feats"] = {k: np.load(os.path.join(work, f"{k}.npy")) for k in ("b2", "b1", "sph")}
        with np.load(os.path.join(work, "server.npz")) as z:
            got["server"] = [z[f"arr_{i}"] for i in range(SERVER_BURST)]
        return got

    # (a) and (c): a fresh process, an empty store, the compilers reachable
    cold = child("cold", {})
    st = cold["stats"]
    check(st["misses"] == 6 and st["hits"] == 0 and st["errors"] == 0 and st["fallbacks"] == 0,
          f"cold store stats {st}")
    check(sorted(cold["build_seconds"]) == ["double_kernels", "int8_kernels", "layout_kernels",
                                            "shorten", "stft_kernels", "viterbi_kernels"],
          f"builds {cold['build_seconds']}")
    store_bytes = AOTCache(store).size_bytes()
    print(f"cold start (a fresh process, an empty store, nvcc and g++ reachable): builds "
          f"{ {k: round(v, 3) for k, v in sorted(cold['build_seconds'].items())} } s "
          f"(the five nvcc builds run together), stats {st}; first feature "
          f"{cold['first_feature_s']:.3f} s after the spawn ({cold['split_s']}), whole child "
          f"{cold['wall_s']:.3f} s; store {store_bytes} bytes [{smi}]", flush=True)

    # (b): a fresh process on that store, no compiler reachable
    warm = child("warm", no_compilers)
    st = warm["stats"]
    check(not any(warm["compilers"].values()), f"the warm child found {warm['compilers']}")
    check(st["misses"] == 0 and st["errors"] == 0 and st["fallbacks"] == 0 and st["hits"] == 6,
          f"warm store stats {st}")
    check(warm["shorten_native"] and cold["shorten_native"], "shorten fell back to Python")

    # the parent's own features on the same routes and batch
    full = np.full(host.shape[0], host.shape[1])
    own = {}
    for key, kw in (("b2", dict(precision="double")), ("b1", dict(fft_mode="pallas"))):
        ex = ShardedExtractor(computer(**kw))
        own[key], got = driven(counted, lambda: ex.extract_batch(host, full)[0].cpu().numpy())
        want = {"b2": "stft_feats_int8", "b1": "stft_feats_rows"}[key]
        check(got[want] == 1, f"{key}: the parent's run launched {got}")
    sph = sorted(glob.glob(os.path.join(here, "tests", "audio", "*_shn.sph")))[0]
    own["sph"] = read_signal(sph)
    for label, run in (("cold", cold), ("warm", warm)):
        for key in ("b2", "b1", "sph"):
            check(np.array_equal(run["feats"][key], own[key]),
                  f"the {label} child's {key} differs from the parent's")
    ref = computer(precision="double", fft_mode="matmul")
    plain = [ref.compute_batch(u[None], [u.size])[0][0].cpu().numpy() for u in _burst_utts()]
    for label, run in (("cold", cold), ("warm", warm)):
        err = max(np.abs(a - b).max() if a.shape == b.shape else np.inf
                  for a, b in zip(run["server"], plain))
        check(err <= TOL_INT8, f"{label} FeatureServer burst vs the plain digit route: {err}")
    print(f"warm start (a fresh process on that store, no nvcc, no g++: PATH and CUDA_HOME an "
          f"empty directory): stats {st}; first feature {warm['first_feature_s']:.3f} s after "
          f"the spawn ({warm['split_s']}), whole child "
          f"{warm['wall_s']:.3f} s; B2 and B1 features of {BATCH} x {SECONDS} s and the .sph "
          f"bitwise equal to the parent's (and the cold child's); {SERVER_BURST} FeatureServer "
          f"answers within {TOL_INT8:g} of the plain digit route [{smi}]", flush=True)

    # (d): --precompile, then the run in a process with no compiler
    cli_store = os.path.join(tmp, "cli_store")
    cfg = json.dumps({"name": "stft", "bank": dict(BANK), **MAIN, "precision": "double"})
    argv = ["signals-to-torch-feat-dir", os.path.join(tmp, "map.txt"), cfg,
            os.path.join(tmp, "precompiled"), "--batch-size", str(CLI_BATCH),
            "--aot-dir", cli_store]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = command_line.main(argv + ["--precompile"])
    pre_s = time.perf_counter() - t0
    check(rc == 0, f"--precompile returned {rc}: {err.getvalue()[-2000:]}")
    summary = [line for line in err.getvalue().splitlines() if line.startswith("precompiled")]
    check(len(summary) == 1, f"no --precompile summary: {err.getvalue()[-2000:]}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "speech_tpu_torch.command_line", *argv],
                          env=dict(os.environ, PYTHONPATH=here, **no_compilers), cwd=here,
                          capture_output=True, text=True, timeout=900)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the precompiled CLI run failed ({proc.returncode}): "
                                f"{proc.stderr[-3000:]}")
    names = sorted(os.listdir(os.path.join(tmp, "b2")))
    check(sorted(os.listdir(os.path.join(tmp, "precompiled"))) == names,
          "the precompiled run wrote other files than phase 19")
    for name in names:
        check(torch.equal(torch.load(os.path.join(tmp, "precompiled", name)),
                          torch.load(os.path.join(tmp, "b2", name))),
              f"{name} differs from phase 19's")
    print(f"CLI: {summary[0]} in {pre_s:.3f} s (in this process, which loaded the libraries "
          f"already: its misses are copies); the run in a fresh process with no compiler "
          f"reachable: rc 0, {run_s:.3f} s, {len(names)} files bitwise equal to phase 19's",
          flush=True)

    # (e): --aot-prune after a planted orphan
    orphan = os.path.join(cli_store, "fp-0000000000000000")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "stale.so"), "wb") as f:
        f.write(b"not a library")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = command_line.main(argv + ["--aot-prune"])
    check(rc == 0 and "1 orphan(s) swept" in out.getvalue() and not os.path.exists(orphan),
          f"--aot-prune: rc {rc}, {out.getvalue()!r}")
    print(f"CLI --aot-prune: {out.getvalue().strip()}", flush=True)
    return counted


def compat_phase(dev, smi, host):
    """Phase 21: the compatibility layer (``speech_tpu_torch.torch``) and
    ``log32`` on the card."""
    import torch

    import speech_tpu_torch.torch as ttorch
    from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
    from speech_tpu_torch.ops.xmath import log32

    sig = host[0]
    x = torch.tensor(sig, device=dev)
    comp = STFTFrameComputer(dict(BANK), device=dev, **MAIN)
    mod = ttorch.PyTorchSTFTFrameComputer.from_stft_frame_computer(comp)
    check({p.device.type for p in mod.parameters()} == {"cuda"}, "parameters off the card")
    got = mod(x)
    want = comp.compute_full(sig)
    check(tuple(got.shape) == want.shape, f"STFT module shape {tuple(got.shape)} vs {want.shape}")
    err = np.abs(got.detach().cpu().numpy() - want).max()
    check(err <= TOL_FLOAT, f"PyTorchSTFTFrameComputer vs compute_full: {err}")
    got.mean().backward()
    grads = {n: p.grad for n, p in mod.named_parameters()}
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values()),
          "non-finite or missing gradients")
    fwd_ms = cuda_ms(lambda: mod(x))
    si = SIFrameComputer(dict(SI_BANKS["gammatone"]), frame_shift_ms=10, include_energy=True,
                         device=dev, dtype="float32")
    si_mod = ttorch.PyTorchSIFrameComputer.from_si_frame_computer(si)
    si_got = si_mod(x).detach().cpu().numpy()
    si_want = si.compute_full(sig)
    check(si_got.shape == si_want.shape, f"SI module shape {si_got.shape} vs {si_want.shape}")
    si_err = np.abs(si_got - si_want).max()
    check(si_err <= TOL_FLOAT, f"PyTorchSIFrameComputer vs compute_full: {si_err}")
    grid = torch.logspace(-6, 6, 1 << 20, device=dev, dtype=torch.float32)
    a = log32(grid).view(torch.int32).long()
    b = torch.log(grid).view(torch.int32).long()
    ulps = (a - b).abs().max().item()
    check(ulps <= 2, f"log32 vs torch.log on the card: {ulps} ulp")
    print(f"compat: PyTorchSTFTFrameComputer (main config, 1 x {SECONDS} s) vs compute_full: "
          f"max abs {err:.3e} (tol {TOL_FLOAT:g}), forward {fwd_ms:.3f} ms, gradients finite "
          f"({', '.join(sorted(grads))}); PyTorchSIFrameComputer gammatone-40 vs compute_full: "
          f"max abs {si_err:.3e}; log32 vs torch.log on [1e-6, 1e6] (2^20 points): {ulps} ulp "
          f"[{smi}]", flush=True)
    print("vis: not run here (no matplotlib on this machine); tests/test_torch_vis.py holds "
          "speech_tpu_torch.vis against speech_tpu.vis on the CPU", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start-child"]:
        cold_start_child(sys.argv[2], sys.argv[3], float(sys.argv[4]))
    else:
        main()
