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
   TOL_DEFAULT;
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
    tones ``bench.py:310-320`` builds), timed, its Viterbi loop timed
    apart, against a float64 CPU run of the port;
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
14. print the kernels line and, last, the device line.

B2 and B4 also run on banks wider than one filter group (phases 3-4):
B2 at 1,489 and 2,978 filters, both tiers, on 16 x 15 s.

It imports torch, numpy and ``speech_tpu_torch`` only.
"""

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
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
DOUBLE_SOURCE = "speech_tpu_torch/csrc/double_kernels.cu"  # B4
COMPUTE_PATH = ("stft_feats_rows", "stft_feats_frames", "stft_feats_int8")


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


def bound_ms(entry):
    """The least time for an entry's work: the larger of its operations
    over their peak rates and its bytes over the memory rate; and which."""
    t_ops = sum(ops / peak for ops, peak in entry["ops"]) * 1e3
    t_bytes = entry["nbytes"] / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
    feats_p, counts_p = pitch.pitch_feats(p_sigs, RATE, lengths=p_len, return_valid=True)
    torch.cuda.synchronize()
    pitch_ms = cuda_ms(lambda: pitch.pitch_feats(p_sigs, RATE, lengths=p_len))
    # the Viterbi loop alone, on the same NCCFs
    work_rate, up, down, window, shift, tables = pitch._work_geometry(
        RATE, 50.0, 400.0, 25.0, 10.0, 4000.0, 0.1, 0.01)
    low = pitch._lowpass(resample.resample(p_sigs, up, down), work_rate, 1000.0)
    full_len = torch.full((16,), low.shape[-1], device=dev)
    nccf_p = torch.cat([pitch._nccf_1d(low[i : i + 16], full_len, window, shift, tables, 1.0)[0]
                        for i in range(0, PITCH_BATCH, 16)])
    tmat = pitch._const(tables[4], nccf_p)
    nc = torch.movedim(nccf_p, -2, 0).contiguous()
    viterbi_ms = cuda_ms(lambda: pitch._viterbi(nc, tmat))
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
    print(f"pitch Viterbi loop ({nc.shape[0]} frames, [{PITCH_BATCH}, {nc.shape[-1]}, "
          f"{nc.shape[-1]}] a step): {viterbi_ms:.3f} ms, {100 * viterbi_ms / pitch_ms:.1f}% "
          f"of pitch_feats", flush=True)
    check(tuple(feats_p.shape) == (PITCH_BATCH, track64.f0.shape[-1], 3),
          f"pitch_feats: shape {tuple(feats_p.shape)}")
    check(bool(torch.isfinite(feats_p).all()), "pitch_feats: non-finite values")
    check(torch.equal(counts_p.cpu(), track64.valid.sum(-1)), "pitch frame counts differ")
    check(share >= 0.99, f"pitch f0 within rtol {TOL_PITCH:g} on only {100 * share:.2f}%")
    check(pov_err <= TOL_PITCH, f"pitch POV column vs float64: {pov_err}")
    del p_sigs, feats_p, low, nccf_p, nc, track32
    torch.cuda.empty_cache()

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

    # 14. the kernels line, the card, the device line
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


if __name__ == "__main__":
    main()
