"""The pitch cell (``kinds/corpus_pitch.py``) and its plain reference
(``reference/pitch.py``) on the CPU: the reference against the program's
tracker, the cell at a test's size with ``correct`` and its readers, both
controls and every planted fault failing its limits, and the four-card
corpus draft found by name with its readers."""

import inspect
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import common
from bench_port.kinds.corpus_pitch import COLUMNS, numbers, synth
from bench_port.reference.pitch import PitchSpec
from bench_port.run import _reader
from bench_port.trace import Trace
from bench_port.trace_pitch import PITCH_RANGE

import small

PITCH_CELL, FOUR = "fbank80-pitch-espnet.corpus", "fbank40-kaldi-double.corpus-4card"

CELL = common.cell(PITCH_CELL)
PITCH = CELL["config"]["pitch"]
LIMITS = CELL["cell"]["limits"]
RATE = 16000


def _signals(lengths, seed=20261019):
    return synth(lengths, seed, "test", CELL["mix"]["audio"], RATE, "cpu")


def _program(sig, frames, dtype=torch.float32):
    """The program's tracker on one utterance, its track pasted to
    ``frames`` rows as the extractor pastes it."""
    from speech_tpu_torch.ops.pitch import pitch_feats

    p3 = pitch_feats(torch.from_numpy(sig.astype(np.float64)).to(dtype), RATE, device="cpu",
                     **PITCH).double().numpy()
    out = np.zeros((frames, 3))
    out[: p3.shape[0]] = p3[:frames]
    out[p3.shape[0]:] = p3[-1]
    return out


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import bench_port.reference.pitch, bench_port.kinds.corpus_pitch; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"speech_tpu_torch", "speech_tpu", "jax", "jaxlib"}


@pytest.mark.parametrize("voiced", [True, False], ids=["voiced", "noise"])
def test_the_reference_is_the_tracker_in_float64(voiced):
    """The program's tracker in float64 is the reference to rounding; in
    float32, as the cell runs it, it passes the cell's pitch limits."""
    from speech_tpu_torch.ops.pitch import pitch_feats

    audio = CELL["mix"]["audio"]
    if not voiced:
        audio = {**audio, "voiced": {**audio["voiced"], "level_db": -200.0}}
    pspec = PitchSpec(PITCH, RATE)
    sigs = synth([9000, 23000, 41000], 20261020, "ref", audio, RATE, "cpu")
    items = []
    for sig in sigs:
        T = pspec.frame_count(sig.size)
        want = pspec.features(sig, T + 4)
        got = pitch_feats(torch.from_numpy(sig.astype(np.float64)), RATE, device="cpu",
                          **PITCH).numpy()
        assert got.shape == (T, 3)
        np.testing.assert_allclose(got, want[:T], rtol=0, atol=1e-9)
        items.append((sig, _program(sig, T + 4)))
    got = numbers(pspec, items, "cpu")
    assert all(got[k] <= limit for k, limit in LIMITS.items() if k in got), got


def test_the_pitch_cell_runs_on_the_cpu_and_is_correct():
    ctx, out = small.cpu_run(PITCH_CELL, trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(LIMITS) <= set(out["checks"])
    m = out["metrics"]
    # the program's span and counter; the device's readers are silent on the CPU
    assert m["extract.pitch_ms"]["value"] > 0
    c = ctx.run.counters
    assert m["pitch.useful_share"]["value"] == pytest.approx(
        100.0 * c["pitch_valid_frames"] / c["pitch_frames"])
    assert "kernel.pitch_roofline" not in m and "pitch.launches_per_batch" not in m


def test_the_device_readers_on_hand_made_intervals():
    """Kernels inside the program's ``"extract.pitch"`` ranges over the
    ranges; the pitch roofline's least time over their device time, and
    the filter bank's over the compute kernels outside them."""
    from bench_port.reference.fbank import FbankSpec
    from bench_port.roofline import bound_s, feature_work
    from bench_port.roofline_pitch import pitch_work

    spec = FbankSpec(CELL["config"]["computer"])
    run = common.Run(CELL["config"], CELL["mix"], spec)
    tr = Trace(0.0, 10.0, [(1.0, 1.5, "k"), (1.6, 2.0, "k"), (2.1, 2.2, "Memcpy HtoD"),
                           (3.0, 4.0, "b1"), (5.0, 5.25, "k"), (5.3, 5.5, "k"), (5.6, 5.8, "k")])
    tr.ranges = {PITCH_RANGE: [(1.0, 2.0), (5.0, 5.8)]}
    work = {"frames": 10**6, "samples": 10**8, "launches": 2, "pitch_frames": 10**6}
    run.trace, run.work = tr, work
    assert _reader("pitch.launches_per_batch")(run) == 2.5
    pspec = PitchSpec(PITCH, RATE)
    L, n_int, W = len(pspec.lags), len(pspec.int_lags), pspec.window
    assert L == 418
    least, bound = bound_s(*pitch_work(pspec, 10**6, 2))
    # the NCCF's products and the min-plus step, each at the float32 rate
    flops = 2 * 10**6 * (2 * n_int * W + W + 2 * n_int * L) + 2 * 10**6 * L * L
    assert bound == "operations" and least == pytest.approx(flops / 67e12)
    # bytes: local costs and int16 back-pointers a frame, the table a launch
    assert pitch_work(pspec, 10**6, 2)[1] == 10**6 * L * 6 + 2 * L * L * 4
    assert _reader("kernel.pitch_roofline")(run) == pytest.approx(100.0 * least / 1.55)
    fb, _ = bound_s(*feature_work(spec, "B1", "highest", 10**6, 10**8, 2))
    assert _reader("kernel.fbank_roofline")(run) == pytest.approx(100.0 * fb / 1.0)
    tr.ranges = {}
    assert _reader("pitch.launches_per_batch")(run) is None
    assert _reader("kernel.pitch_roofline")(run) is None
    assert _reader("kernel.fbank_roofline")(run) is None


@pytest.mark.parametrize("control", ["tf32", "viterbi32"])
def test_the_controls_fail_the_limits(control):
    """Each control in the program's place, on utterances as long as the
    cell's longest, fails a limit that the program passes."""
    pspec = PitchSpec(PITCH, RATE)
    sigs = _signals([20 * RATE, 14 * RATE])
    frames = [pspec.frame_count(s.size) + 4 for s in sigs]
    prog = numbers(pspec, [(s, _program(s, f)) for s, f in zip(sigs, frames)], "cpu")
    ctrl = numbers(pspec, [(s, pspec.features(s, f, "cpu", control)) for s, f in zip(sigs, frames)],
                   "cpu")
    pitch_limits = {k: v for k, v in LIMITS.items() if k in prog}
    assert all(prog[k] <= v for k, v in pitch_limits.items()), prog
    assert any(ctrl[k] > v for k, v in pitch_limits.items()), ctrl


@pytest.mark.parametrize("column,number,by", [("pov", "pitch_pov_utt_p99", 1e-4),
                                              ("lnp", "pitch_lnp_utt_p50", 5e-4)])
def test_a_fault_in_one_short_utterance_fails_its_own_numbers(column, number, by):
    """A column off by ``by`` (the log pitch by under a fifth of a lag
    step) in one utterance of under 1% of the checked rows passes the
    numbers over all rows; that utterance's own fails."""
    pspec = PitchSpec(PITCH, RATE)
    sigs = _signals([20 * RATE, 20 * RATE, 20 * RATE, RATE // 2])
    items = [(s, _program(s, pspec.frame_count(s.size) + 4)) for s in sigs]
    assert items[-1][1].shape[0] < 0.01 * sum(r.shape[0] for _, r in items)
    pooled = {k: v for k, v in LIMITS.items() if k.startswith("pitch_") and "_utt_" not in k}
    sound = numbers(pspec, items, "cpu")
    assert all(sound[k] <= v for k, v in LIMITS.items() if k in sound), sound
    items[-1][1][:, COLUMNS.index(column)] += by
    got = numbers(pspec, items, "cpu")
    assert all(got[k] <= v for k, v in pooled.items()), got
    assert got[number] > LIMITS[number]


def _no_penalty(monkeypatch):
    from speech_tpu_torch.ops import pitch

    geometry = pitch._work_geometry

    def free(*args, **kw):
        bound = inspect.signature(geometry).bind(*args, **kw)
        bound.arguments["penalty_factor"] = 0.0
        return geometry(*bound.args, **bound.kwargs)

    monkeypatch.setattr(pitch, "_work_geometry", free)


def _no_soft_min(monkeypatch):
    from speech_tpu_torch.ops import pitch

    monkeypatch.setattr(pitch, "_soft_discount", lambda fine, rate, soft: np.ones(len(fine)))


def _extractor_fault(monkeypatch, fault):
    from speech_tpu_torch.parallel.extract import ShardedExtractor

    with_pitch = ShardedExtractor._with_pitch

    def faulty(self, feats, rows, lens):
        out = with_pitch(self, feats, rows, lens)
        return fault(out, lens)

    monkeypatch.setattr(ShardedExtractor, "_with_pitch", faulty)


def _swapped_rows(monkeypatch):
    """Each row's pitch columns pasted onto the next row."""
    def swap(out, lens):
        out = out.clone()
        out[..., -3:] = out[..., -3:].roll(1, dims=0)
        return out

    _extractor_fault(monkeypatch, swap)


def _no_tail(monkeypatch):
    """The rows past the track left at zero, not repeating its last row."""
    from speech_tpu_torch.ops.pitch import pitch_frame_counts

    def cut(out, lens):
        out = out.clone()
        _, valid = pitch_frame_counts(out.shape[1] * 160, lens.numpy(), RATE, **PITCH)
        for i, v in enumerate(valid):
            out[i, v:, -3:] = 0.0
        return out

    _extractor_fault(monkeypatch, cut)


def _one_row_pov(monkeypatch):
    """The POV of one row of each batch, and of no other, off by 1e-4."""
    def nudge(out, lens):
        out = out.clone()
        out[0, :, -3] += 1e-4
        return out

    _extractor_fault(monkeypatch, nudge)


FAULTS = {"no_penalty": _no_penalty, "no_soft_min": _no_soft_min,
          "swapped_rows": _swapped_rows, "no_tail": _no_tail, "one_row_pov": _one_row_pov}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_planted_pitch_fault_is_not_correct(monkeypatch, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    _, out = small.cpu_run(PITCH_CELL, seconds=1.0)
    assert out["correct"] is (fault is None), out["checks"]


def test_the_four_card_draft_resolves_with_its_readers():
    """The four-card corpus cell stays a draft (its spread is over half the
    bound of ``audio_s_per_s``): it resolves through ``common.cell`` from
    ``small.DRAFTS``, not from ``BENCHMARK.json``, and its readers load."""
    assert FOUR not in {w["name"] for w in common.benchmark()["workloads"]}
    cell = common.cell(FOUR, small.DRAFTS[FOUR])
    assert cell["chips"] == 4 and cell["mix"]["kind"] == "corpus"
    assert cell["mix"]["batch"] == 256 and cell["cell"]["limits"] == {"excess_err": 1.5e-06}
    for name in ("audio_s_per_s", "setup_s", "extract.dispatch_ms", "extract.useful_share",
                 "kernel.feats_roofline", "device.idle.corpus", "extract.pad_ms",
                 "extract.launch_ms", "extract.wait_ms", "extract.unpack_ms",
                 "extract.idle_in_pad"):
        assert callable(_reader(name))


def test_control_pitch_reads_the_program_and_both_controls(monkeypatch):
    """``control_pitch.py`` at a test's size: the program's readings pass
    the cell's limits and each control fails one."""
    from bench_port import control_pitch

    cell = small.small_cell(PITCH_CELL)
    monkeypatch.setattr(control_pitch.common, "cell", lambda name: cell)
    (seed, got), = control_pitch.readings(PITCH_CELL, [20261021], 1.0, torch.device("cpu"))
    assert seed == 20261021 and set(got) == {"program", *control_pitch.CONTROLS}
    assert all(got["program"][k] <= v for k, v in LIMITS.items()), got["program"]
    for name in control_pitch.CONTROLS:
        assert any(got[name][k] > v for k, v in LIMITS.items() if k in got[name]), got[name]
