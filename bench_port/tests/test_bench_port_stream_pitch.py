"""The stream pitch cell (``kinds/stream_replay.py``) and its plain online
reference (``reference/pitch_online.py``) on the CPU: the reference
against the program's float64 streamer and its own offline Viterbi, the
cell at a test's size with ``correct`` and its readers, the readers on
hand-made intervals, both controls and every planted fault failing the
cell's limits."""

import json
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import common
from bench_port.kinds.corpus_pitch import synth
from bench_port.kinds.stream_replay import readings
from bench_port.reference.fbank import FbankSpec
from bench_port.reference.pitch import PitchSpec
from bench_port.reference.pitch_online import OnlinePitchSpec
from bench_port.run import _reader
from bench_port.trace import Trace
from bench_port.trace_pitch import kernels_in
from bench_port.trace_stream import STREAM_PITCH_RANGE, kernels_within, ticks_within

import small

CELL_NAME = "fbank40-pitch-kaldi-online.stream-replay"
# the mix at a test's size (the traffic's shape kept)
small.SMALL.setdefault("stream-pitch-replay", {
    "sessions": 4, "pool": 8, "seconds_min": 0.5, "seconds_max": 2.0, "check_sessions": 4,
    "trace_seconds": 0.5, "ramp_s": 0.5, "settle_s": 30.0})

CELL = common.cell(CELL_NAME)
CONFIG, PITCH, LIMITS = CELL["config"], CELL["config"]["pitch"], CELL["cell"]["limits"]
RATE, CHUNK = 16000, 1600
SPEC = FbankSpec(CONFIG["computer"])
NF = SPEC.num_coeffs


def _signals(lengths, seed=20261019):
    return synth(lengths, seed, "test", CELL["mix"]["audio"], RATE, "cpu")


def _streamer(dtype="float32", **pitch):
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer
    from speech_tpu_torch.streaming import StreamingAppendPitch

    comp = alias_factory_subclass_from_arg(
        FrameComputer, {**CONFIG["computer"], "device": "cpu", "dtype": dtype})
    return StreamingAppendPitch(comp, {**PITCH, **pitch}, CHUNK)


def _verdict(fbank_rows, pitch_rows, sigs):
    """The cell's verdict on rows in the program's place."""
    from bench_port import check

    pspec = OnlinePitchSpec(PITCH, RATE, CHUNK)
    got = readings(SPEC, pspec, [(s, r, None) for s, r in zip(sigs, fbank_rows)],
                   list(zip(sigs, pitch_rows)), "cpu")
    return check.verdict(got, LIMITS)


@pytest.fixture(scope="module")
def sessions():
    """Two voiced sessions, 12 s and 3 s, with the program's float32 rows."""
    sigs = _signals([12 * RATE + 777, 3 * RATE])
    stream = _streamer()
    return sigs, [stream.transform(s) for s in sigs]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import bench_port.reference.pitch_online; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"speech_tpu_torch", "speech_tpu", "jax", "jaxlib"}


def test_the_reference_is_the_programs_float64_streamer():
    """Two independent statements of the online semantics: the program's
    streamer in float64 and the reference agree to float64 rounding."""
    sig = _signals([2 * RATE + 345])[0]
    got = _streamer("float64").transform(sig)
    want = OnlinePitchSpec(PITCH, RATE, CHUNK).features(sig, got.shape[0])
    np.testing.assert_allclose(got[:, NF:], want, rtol=0, atol=1e-9)


def test_with_a_lookahead_past_the_session_the_track_is_the_offline_viterbi():
    """With no emission before ``finalize``, the online track is the offline
    Viterbi path over the same local scores: the reference's own min-plus
    step and backtrack against ``PitchSpec._viterbi``."""
    sig = _signals([2 * RATE])[0]
    ref = OnlinePitchSpec({**PITCH, "lookahead_frames": 10**6}, RATE, CHUNK)
    calls = ref.track_calls(sig)
    assert all(f.size == 0 for f, _ in calls[:-1])
    captured = {}

    def viterbi(nc, precision):
        captured["path"] = PitchSpec._viterbi(ref, nc, precision)
        return captured["path"]

    # the same scores through the offline Viterbi: the frames the online
    # reference absorbs with each absorption's ballast
    x = torch.as_tensor(np.asarray(sig, np.float64))
    x = ref._lowpass(ref._resample(x))
    scores, voicings, done = [], [], 0
    for _, work, frames in ref.absorptions(len(sig)):
        if frames > done:
            p, v = ref._nccf_at(x, done, frames, (x[:work] ** 2).mean(), "float64")
            scores.append(p)
            voicings.append(v)
            done = frames
    lags = torch.tensor(ref.lags)
    nc = torch.cat(scores) * (1.0 - torch.clamp(ref.soft_min_f0 * lags / ref.work_rate, max=1.0))
    f0, nccf = ref._refine(torch.cat(voicings), torch.as_tensor(viterbi(nc, "float64")))
    np.testing.assert_allclose(calls[-1][0], f0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(calls[-1][1], nccf.numpy(), rtol=0, atol=1e-12)


def test_the_stream_cell_runs_on_the_cpu_and_is_correct():
    ctx, out = small.cpu_run(CELL_NAME, seconds=2.0, trace=True)
    assert out["correct"], out["checks"]
    # every lane is checked on a session opened in the window, after its
    # first; the ramp before the window is not set-up
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert ctx.run.setup_s <= ctx.run.t0 - ctx.t_start - 0.5
    assert set(LIMITS) <= set(out["checks"])
    m = out["metrics"]
    # the program's spans and counters; the device's readers are silent on the CPU
    assert m["stream.pitch_ms"]["value"] > 0 and m["stream.step_ms"]["value"] > 0
    c = ctx.run.counters
    assert m["stream.pitch_useful_share"]["value"] == pytest.approx(
        100.0 * c["pitch_frames_tracked"] / c["pitch_frames_stepped"])
    for name in ("kernel.stream_pitch_roofline", "stream.pitch_launches_per_tick",
                 "device.idle.stream", "stream.launches_per_tick"):
        assert name not in m
    assert ctx.run.values["rows"] > 0


def test_kernels_within_is_kernels_in():
    """The bisection finds the kernels the pitch cell's scan finds."""
    rng = random.Random(3)
    ranges, at = [], 0.0
    for _ in range(40):
        a = at + rng.random()
        ranges.append((a, a + rng.random()))
        at = ranges[-1][1]
    ops = []
    for _ in range(500):
        s = rng.random() * at
        ops.append((s, s + rng.random() * 0.3, "k"))
    tr = Trace(0.0, at, ops)
    tr.ranges = {STREAM_PITCH_RANGE: ranges}
    assert kernels_within(tr) == kernels_in(tr, STREAM_PITCH_RANGE)
    tr.ranges = {}
    assert kernels_within(tr) is None


def test_the_device_readers_on_hand_made_intervals():
    """Kernels inside ``"stream.pitch"`` over the ticks, and the pitch
    roofline's least time for the traced window's tracked frames over
    their device time."""
    from bench_port.roofline import bound_s
    from bench_port.roofline_pitch import pitch_work

    run = common.Run(CONFIG, CELL["mix"], SPEC)
    tr = Trace(0.0, 10.0, [(1.0, 1.5, "k"), (1.6, 2.0, "k"), (2.1, 2.2, "Memcpy HtoD"),
                           (3.0, 4.0, "fbank"), (5.0, 5.25, "k"), (5.3, 5.5, "k")])
    tr.ranges = {STREAM_PITCH_RANGE: [(1.0, 2.0), (5.0, 5.6)]}
    for a in (0.9, 4.9, 7.0, 9.0, 9.99):
        run.spans.add("stream.step", a, a + 0.05)
    run.trace, run.work = tr, {"pitch_frames": 10**6, "launches": 4}
    # the tick cut by the window's end counts no more than its range does
    assert len(ticks_within(run.spans, tr)) == 4
    assert _reader("stream.pitch_launches_per_tick")(run) == 1.0
    least, _ = bound_s(*pitch_work(PitchSpec(PITCH, RATE), 10**6, 4))
    assert _reader("kernel.stream_pitch_roofline")(run) == pytest.approx(100.0 * least / 1.35)
    run.t0, run.t1 = 0.0, 10.0
    run.spans.add("stream.pitch", 1.0, 1.004)
    run.spans.add("stream.pitch", 2.0, 2.002)
    assert _reader("stream.pitch_ms")(run) == pytest.approx(3.0)
    run.counters = {"pitch_frames_tracked": 30, "pitch_frames_stepped": 40}
    assert _reader("stream.pitch_useful_share")(run) == pytest.approx(75.0)
    # a record outside the window adds no device time
    tr.ops.append((-50.0, -49.0, "k"))
    tr.ranges[STREAM_PITCH_RANGE].insert(0, (-50.0, -48.0))
    assert _reader("kernel.stream_pitch_roofline")(run) == pytest.approx(100.0 * least / 1.35)
    tr.ranges = {}
    assert _reader("stream.pitch_launches_per_tick")(run) is None
    assert _reader("kernel.stream_pitch_roofline")(run) is None


def test_the_program_passes_the_limits(sessions):
    sigs, rows = sessions
    ok, checks = _verdict([r[:, :NF] for r in rows], [r[:, NF:] for r in rows], sigs)
    assert ok, checks


@pytest.mark.parametrize("control", ["tf32", "viterbi32"])
def test_the_controls_fail_the_limits(sessions, control):
    """Each control in the program's place (the filter bank too at TF32)
    fails a limit."""
    sigs, rows = sessions
    pspec = OnlinePitchSpec(PITCH, RATE, CHUNK)
    fb = [SPEC.features(s, "cpu", "tf32") if control == "tf32" else r[:, :NF]
          for s, r in zip(sigs, rows)]
    pitch = [pspec.features(s, r.shape[0], "cpu", control) for s, r in zip(sigs, rows)]
    ok, checks = _verdict(fb, pitch, sigs)
    assert not ok, checks


def _fault(name, sigs, rows):
    """The program's pitch rows with fault ``name`` planted."""
    out = []
    for s, r in zip(sigs, rows):
        p = r[:, NF:].astype(np.float64).copy()
        if name == "no_cost_shift":
            # a float32 tracker without the per-step shift
            p = OnlinePitchSpec(PITCH, RATE, CHUNK).features(s, p.shape[0], "cpu", "viterbi32")
        elif name == "frozen_ballast":
            # the whole session's mean square from the first frame on
            ms = float(np.mean(np.asarray(s, np.float64) ** 2)) / 16.0
            p = _streamer(ballast_ms=ms).transform(s)[:, NF:]
        elif name == "next_row":
            p[1:] = p[:-1].copy()
        elif name == "window_past_emitted":
            # every frame's normalisation window reads the whole track
            ref = OnlinePitchSpec(PITCH, RATE, CHUNK)
            calls = ref.track_calls(s)
            whole = [(np.concatenate([c[0] for c in calls]), np.concatenate([c[1] for c in calls]))]
            cols = ref.columns(whole)
            p[: cols.shape[0], 1] = cols[:, 1]
        elif name == "zero_tail":
            T = PitchSpec(PITCH, RATE).frame_count(len(s))
            p[T:] = 0.0
        out.append(p)
    return out


@pytest.mark.parametrize("fault", ["no_cost_shift", "frozen_ballast", "next_row",
                                   "window_past_emitted", "zero_tail"])
def test_a_planted_fault_is_not_correct(sessions, fault):
    sigs, rows = sessions
    ok, checks = _verdict([r[:, :NF] for r in rows], _fault(fault, sigs, rows), sigs)
    assert not ok, checks


def test_control_stream_pitch_reads_the_program_and_both_controls(monkeypatch):
    """``control_stream_pitch.py`` at a test's size: the program's readings
    pass the cell's limits, and the TF32 control fails one (the sessions
    are too short for the unshifted float32 tracker to stray)."""
    from bench_port import control_stream_pitch

    cell = small.small_cell(CELL_NAME)
    monkeypatch.setattr(control_stream_pitch.common, "cell", lambda name: cell)
    (seed, got), = control_stream_pitch.readings(CELL_NAME, [20261021], 1.0, torch.device("cpu"))
    assert seed == 20261021 and set(got) == {"program", *control_stream_pitch.CONTROLS}
    assert all(got["program"][k] <= v for k, v in LIMITS.items()), got["program"]
    assert any(got["tf32"][k] > v for k, v in LIMITS.items() if k in got["tf32"]), got["tf32"]
