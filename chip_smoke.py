"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero):

1. build the hand-written kernels from ``speech_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build seconds;
2. print the card's name and power limit (``nvidia-smi``);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (128 x 15 s at 16 kHz; the fbank 40 config of
   ``bench.py``) and time both with CUDA events;
4. drive the main path, ``STFTFrameComputer.compute_batch`` on 128 x 15 s,
   for every tier (and the ragged, int16 and 10.25 ms-shift variants),
   with every launch counter set to 0 before and read after: each kernel
   must have been launched;
5. hold 'double' on the card against a float64 CPU run of the port on
   ``tests/audio/test.wav``;
6. print the kernels line and, last, the device line.

It imports torch, numpy and ``speech_tpu_torch`` only.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import wave

import numpy as np

# published H100 SXM peaks, dense (NVIDIA data sheet), at a 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
MAIN = dict(frame_length_ms=25, frame_shift_ms=10, include_energy=True, dtype="float32")
BATCH, SECONDS, RATE = 128, 15, 16000
LOG_SPEC = dict(use_log=True, use_power=False, include_energy=True, log_floor=1e-5)
TOL_FLOAT = 1e-4  # f32 reduction order (tests/test_pallas.py:55)
TOL_INT8 = 2e-6  # the digit tiers' exactness class (tests/test_pallas.py:175)
TOL_F64 = 1e-5  # 'double' vs float64 on speech (tests/test_pallas.py:250)
SOURCE = "speech_tpu_torch/csrc/stft_kernels.cu"


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
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.ops import _build
    from speech_tpu_torch.ops import framing as F
    from speech_tpu_torch.ops import stft_kernels as K

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
    rows_kw = dict(num_frames=mf, frame_length=fl, frame_shift=fs, **LOG_SPEC)
    got = K.stft_feats_rows(padded, c.params, **rows_kw)
    want = K.stft_feats_rows_plain(padded, c.params, **rows_kw)
    frames_total = BATCH * mf
    float_ops = 2 * frames_total * (2 * fl * half + half * nf)
    entries["stft_feats_rows"] = dict(
        replaces="speech_tpu/ops/pallas_stft.py:850 stft_feats_pallas (_rows_kernel :159)",
        err=(got - want).abs().max().item(), tol=TOL_FLOAT,
        ms=cuda_ms(lambda: K.stft_feats_rows(padded, c.params, **rows_kw)),
        plain_ms=cuda_ms(lambda: K.stft_feats_rows_plain(padded, c.params, **rows_kw)),
        ops=[(float_ops, PEAK_FP32_FLOPS)],
        nbytes=bytes_of(padded, got, *consts),
    )
    del got, want

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
        ops=[(2 * BATCH * mf3 * (2 * fl * half + half * nf), PEAK_FP32_FLOPS)],
        nbytes=bytes_of(frames3, got, *consts),
    )
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
        print(f"stft_feats_int8 [{precision}]: {int8_ms[precision]:.3f} ms", flush=True)
        if precision == "double":
            n_pairs = sum(len(xs) for _, xs, _, _ in p["i8k_offsets"])
            nb = p["i8k_mask"].shape[0]
            tail = [p["i8k_" + k] for k in ("gmats", "mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")]
            entries["stft_feats_int8"] = dict(
                replaces="speech_tpu/ops/pallas_stft.py:703 stft_feats_pallas_int8 (_int8_rows_kernel :573)",
                err=err, tol=TOL_INT8, ms=int8_ms[precision],
                plain_ms=cuda_ms(lambda: K.stft_feats_int8_plain(padded, p, **i8_kw), reps=3),
                ops=[
                    (2 * frames_total * fl * 2 * nb * n_pairs, PEAK_INT8_OPS),
                    (2 * frames_total * nb * nf * 2, PEAK_FP32_FLOPS),
                ],
                nbytes=bytes_of(padded, got, *tail),
            )
        del got, want
    for name, e in entries.items():
        print(f"{name} vs plain: max abs {e['err']:.3e} (tol {e['tol']:g}); "
              f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms", flush=True)
        check(e["err"] <= e["tol"], f"{name} disagrees with its plain version: {e['err']}")
    del padded
    torch.cuda.empty_cache()

    # 4. the main path at full size; counts from 0 just before, read after
    paths = [
        ("double (auto)", computer(precision="double"), sigs, full),
        ("accurate (auto)", computer(precision="accurate"), sigs, full),
        ("pallas highest", computer(fft_mode="pallas"), sigs, full),
        ("pallas highest 10.25 ms", computer(fft_mode="pallas", frame_shift_ms=10.25), sigs, full),
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
    launches = K.launch_counts()
    print(f"main path launches: {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the main path")
    for label, (comp, feats, counts) in results.items():
        want_frames = F.frame_count_np(n, comp.frame_length, comp.frame_shift)
        check(tuple(feats.shape) == (BATCH, want_frames, 41), f"{label}: shape {tuple(feats.shape)}")
        valid = torch.arange(feats.shape[1], device=dev)[None, :] < counts[:, None].long()
        check(bool(torch.isfinite(feats[valid]).all()), f"{label}: non-finite features")
    ref = results["highest (plain matmul)"][1]
    for label in ("double (auto)", "accurate (auto)", "pallas highest"):
        diff = (results[label][1] - ref).abs().max().item()
        print(f"{label} vs highest (plain matmul): max abs {diff:.3e}", flush=True)
        check(diff <= TOL_FLOAT, f"{label} disagrees with the plain path: {diff}")
    rc, rf, rn = results["double ragged"]
    expect = torch.tensor([F.frame_count_np(int(v), fl, fs) for v in ragged], device=dev)
    check(bool((rn == expect).all()), "ragged counts")
    del results
    audio_s = BATCH * SECONDS
    for label, comp, x, lengths in paths:
        ms = cuda_ms(lambda: comp.compute_batch(x, lengths))
        print(f"compute_batch {label}: {ms:.3f} ms median, "
              f"{audio_s / (ms / 1e3):.0f} audio-s/s", flush=True)

    # 5. 'double' on the card vs a float64 run of the port on the CPU
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

    # 6. the kernels line, the card, the device line
    kernels = []
    for name, e in entries.items():
        t_ops = sum(ops / peak for ops, peak in e["ops"]) * 1e3
        t_bytes = e["nbytes"] / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": e["replaces"],
            "launches": launches[name], "max_abs_err": e["err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    print(f"stft_feats_int8 accurate ms: {int8_ms['accurate']:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
