"""``ShardedExtractor(pitch=...)`` on the CPU: each row is the computer's
features of the utterance alone with ``pitch_feats`` of the utterance
alone pasted on by the CLIs' paste rule (``command_line._paste_pitch``:
rows past the track repeat its last frame, no track gives zeros), through
``extract_iter``, ``extract`` and ``extract_batch``, over int16 and float32
input, batch padding, both bucketings, rows too short to track and a
two-rank gloo mesh; the stats count the tracker's frames; without
``pitch`` nothing changes.  The same arithmetic runs on the card in
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from speech_tpu_torch import parallel as tpar
from speech_tpu_torch.command_line import _paste_pitch
from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops.pitch import pitch_feats, pitch_frame_counts

import torch_dist_worker as W

RATE = 16000
BANK = {"name": "fbank", "num_filts": 12, "sampling_rate": RATE}
# Kaldi's lag grid (delta-pitch 0.005), as the ESPnet configuration runs it
PITCH = {"lag_resolution": 0.005}
# two batches, the second shorter (min_batch pads it): 700 samples track
# no frame (a frame spans 752), 400 is the computer's shortest row
LENGTHS = [(24000, 9000, 700, 16000, 30500), (12000, 400, 20000)]


def _computer(dtype="float32"):
    return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10, dtype=dtype,
                             device="cpu")


def _voiced(n, f0, dtype, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / RATE
    x = np.sign(np.sin(2 * np.pi * f0 * (1.0 + 0.2 * np.sin(2 * np.pi * t))))
    x = 3000.0 * (x + 0.2 * rng.randn(n))
    return x.astype(dtype)


def _batches(dtype, lengths=LENGTHS):
    return [[_voiced(n, 95.0 + 11.0 * k, dtype, 7 * b + k) for k, n in enumerate(lens)]
            for b, lens in enumerate(lengths)]


def _alone(comp, sig, pitch):
    """The row of ``sig`` run alone: its features with its pitch pasted on."""
    x = torch.as_tensor(sig.astype(np.float64)).to(comp._dtype)[None]
    feats, n = comp.compute_batch(x, [sig.size])
    feats = feats[0, : int(n[0])].numpy()
    kw = {"frame_shift_ms": comp.frame_shift_ms, **pitch}
    try:
        p3 = pitch_feats(x[0], RATE, device="cpu", **kw).numpy()
    except ValueError:  # too short for one frame
        p3 = np.zeros((0, 3), feats.dtype)
    return _paste_pitch(feats, p3)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("bucket", ["pow2", "fine"])
def test_rows_are_the_features_with_their_own_pitch(dtype, bucket):
    comp = _computer()
    ex = tpar.ShardedExtractor(comp, bucket=bucket, pitch=PITCH)
    batches = _batches(dtype)
    got = list(ex.extract_iter(batches, min_batch=6))
    frames = valid = 0
    for sigs, rows in zip(batches, got):
        assert len(rows) == len(sigs)
        for sig, row in zip(sigs, rows):
            want = _alone(comp, sig, PITCH)
            assert row.shape == want.shape == (want.shape[0], comp.num_coeffs + 3)
            np.testing.assert_allclose(row, want, rtol=0, atol=1e-5)
        lens = np.array([s.size for s in sigs] + [comp.frame_length] * (6 - len(sigs)))
        T, v = pitch_frame_counts(ex.bucket_len(max(s.size for s in sigs)), lens, RATE,
                                  frame_shift_ms=10, **PITCH)
        frames += 6 * T
        valid += int(v.sum())
    assert ex.stats["pitch_frames"] == frames
    assert ex.stats["pitch_valid_frames"] == valid > 0
    assert ex.stats["rows"] == 12 and ex.stats["batches"] == 2


def test_the_tail_repeats_the_last_tracked_frame():
    """Rows past the track (the NCCF's span runs a few frames past the
    features' last frame) repeat its last frame; a row with no track is
    zeros."""
    comp = _computer()
    ex = tpar.ShardedExtractor(comp, pitch=PITCH)
    sigs = _batches(np.int16)[0]
    rows = ex.extract(sigs)
    for sig, row in zip(sigs, rows):
        _, (v,) = pitch_frame_counts(sig.size, [sig.size], RATE, **PITCH)
        if v == 0:
            assert not row[:, -3:].any()
        else:
            assert 0 < v < row.shape[0]
            assert (row[v:, -3:] == row[v - 1, -3:]).all()


def test_a_bucket_too_short_to_track_gives_zeros():
    """Every row shorter than a pitch frame, in a bucket the tracker cannot
    frame at all: the columns are zeros and nothing is tracked."""
    comp = _computer()
    ex = tpar.ShardedExtractor(comp, pitch=PITCH)
    sigs = [_voiced(n, 120.0, np.float32, n) for n in (450, 512)]
    rows = ex.extract(sigs, min_batch=3)
    for sig, row in zip(sigs, rows):
        assert row.shape[1] == comp.num_coeffs + 3 and not row[:, -3:].any()
        np.testing.assert_allclose(row, _alone(comp, sig, PITCH), rtol=0, atol=1e-5)
    assert ex.stats["pitch_frames"] == ex.stats["pitch_valid_frames"] == 0


def test_extract_batch_joins_the_pitch_columns():
    comp = _computer("float64")
    ex = tpar.ShardedExtractor(comp, pitch={})
    sigs = _batches(np.float32)[1]
    n = max(s.size for s in sigs)
    padded = np.zeros((len(sigs), n), np.float64)
    for i, s in enumerate(sigs):
        padded[i, : s.size] = s
    feats, counts = ex.extract_batch(padded, torch.tensor([s.size for s in sigs]))
    for i, s in enumerate(sigs):
        row = feats[i, : int(counts[i])].numpy()
        np.testing.assert_allclose(row, _alone(comp, s, {}), rtol=0, atol=1e-9)


def test_without_pitch_nothing_changes(monkeypatch):
    comp = _computer()
    batches = _batches(np.int16)
    with_pitch = list(tpar.ShardedExtractor(comp, pitch=PITCH).extract_iter(batches, min_batch=6))
    ex = tpar.ShardedExtractor(comp)
    monkeypatch.setattr(ex, "_with_pitch", None)  # a call would raise
    got = list(ex.extract_iter(batches, min_batch=6))
    assert set(ex.stats) == {"batches", "rows", "samples", "kernel_samples"}
    for a, b in zip(got, with_pitch):
        for x, y in zip(a, b):
            assert x.shape[1] == comp.num_coeffs and np.array_equal(x, y[:, : comp.num_coeffs])


@pytest.mark.parametrize("bad,exc", [({"min_f0": -1.0}, ValueError), ({"max_f": 300.0}, TypeError)])
def test_bad_pitch_arguments_fail_when_built(bad, exc):
    with pytest.raises(exc):
        tpar.ShardedExtractor(_computer(), pitch=bad)


def test_a_mesh_of_two_ranks_tracks_each_block(tmp_path):
    """Two gloo ranks, each tracking its own row block of every batch
    (``tests/torch_dist_worker.py extract_pitch``), give every row of one
    process without a mesh; rank 0 counts its own rows' frames."""
    procs, out = W.launch(2, str(tmp_path), "extract_pitch")
    mesh = W.wait(procs, out)
    import speech_tpu_torch as stt

    comp = W.stft_computer(stt)
    ex = tpar.ShardedExtractor(comp, pitch={})
    batches = W.pitch_signals()
    for b, rows in enumerate(ex.extract_iter(batches, min_batch=8)):
        want = W._ragged(f"pitch{b}", rows)
        for k, v in want.items():
            np.testing.assert_allclose(mesh[k], v, rtol=0, atol=1e-9)
    frames = valid = 0
    for sigs in batches:  # rank 0's rows: the first four of eight
        lens = np.array([s.size for s in sigs] + [comp.frame_length] * (8 - len(sigs)))[:4]
        T, v = pitch_frame_counts(ex.bucket_len(max(s.size for s in sigs)), lens,
                                  W.PITCH_RATE, frame_shift_ms=comp.frame_shift_ms)
        frames += 4 * T
        valid += int(v.sum())
    assert mesh["stats"].tolist() == [8, frames, valid]
    assert valid > 0



RAGGED = [(24000, 9000, 700, 16000), (12000, 400, 20000)]


def _viterbi_spy(monkeypatch, whole=False):
    """Record the ``(frames, steps)`` each call of the tracker's Viterbi is
    asked for; with ``whole``, run it over every frame, as lengths on the
    card do."""
    from speech_tpu_torch.ops import pitch as TP

    viterbi = TP._viterbi
    asked = []

    def spy(nc, tmat, counts=None, steps=None):
        asked.append((nc.shape[0], steps))
        return viterbi(nc, tmat, counts, None if whole else steps)

    monkeypatch.setattr(TP, "_viterbi", spy)
    return asked


def test_bounded_tracker_gives_the_unbounded_columns(monkeypatch):
    """``extract_iter`` hands the tracker host lengths, which end its
    Viterbi at each batch's longest row, well short of the bucket here; the
    rows equal, bit for bit, those of the tracker over every frame."""
    comp = _computer()
    batches = _batches(np.int16, RAGGED)
    got = list(tpar.ShardedExtractor(comp, pitch=PITCH).extract_iter(batches, min_batch=6))
    asked = _viterbi_spy(monkeypatch, whole=True)
    want = list(tpar.ShardedExtractor(comp, pitch=PITCH).extract_iter(batches, min_batch=6))
    assert len(asked) == len(batches)
    for (T, steps), g, w, sigs in zip(asked, got, want, batches):
        assert steps < 0.9 * T
        assert len(g) == len(w) == len(sigs)
        for a, b in zip(g, w):
            assert a.shape == b.shape and np.array_equal(a, b)


def test_pitch_steps_count_the_rows_times_the_longest_row(monkeypatch):
    """``stats["pitch_steps"]``: the rows times the largest tracked count,
    batch by batch, the bound the tracker was given."""
    comp = _computer()
    ex = tpar.ShardedExtractor(comp, pitch=PITCH)
    asked = _viterbi_spy(monkeypatch)
    for sigs in _batches(np.int16, RAGGED):
        before = dict(ex.stats)
        ex.extract(sigs, min_batch=6)
        lens = [s.size for s in sigs] + [comp.frame_length] * (6 - len(sigs))
        _, valid = pitch_frame_counts(ex.bucket_len(max(lens)), lens, RATE,
                                      frame_shift_ms=10, **PITCH)
        assert ex.stats["pitch_steps"] - before["pitch_steps"] == 6 * valid.max() == 6 * asked[-1][1]
        assert (ex.stats["pitch_valid_frames"] - before["pitch_valid_frames"]
                == valid.sum() > 0)


def test_pitch_kernel_steps_count_only_the_kernels_steps(monkeypatch):
    """``stats["pitch_kernel_steps"]`` stays 0 on a CPU extractor, whose
    Viterbi runs its loops, while ``pitch_steps`` counts as before; where
    ``viterbi_on_kernel`` takes the computer's device, type and lags (here
    a stand-in that runs the loops), it counts every one of those steps,
    and the rows stay the same."""
    from speech_tpu_torch.ops import pitch as TP
    from speech_tpu_torch.ops import stft_kernels as K

    comp = _computer()
    batches = _batches(np.int16, RAGGED)
    ex = tpar.ShardedExtractor(comp, pitch=PITCH)
    want = list(ex.extract_iter(batches, min_batch=6))
    assert ex.stats["pitch_steps"] > 0 and ex.stats["pitch_kernel_steps"] == 0
    asked = []
    loops = TP._viterbi

    def kernel(nc, tmat, counts, steps):
        asked.append(steps)
        with monkeypatch.context() as m:
            m.setattr(TP, "viterbi_on_kernel", lambda *a: False)
            return loops(nc, tmat, counts, steps)

    seen = []

    def on_kernel(device, dtype, lags):
        seen.append((torch.device(device).type, dtype, lags))
        return True

    monkeypatch.setattr(TP, "viterbi_on_kernel", on_kernel)
    monkeypatch.setattr(K, "viterbi_path", kernel)
    ex = tpar.ShardedExtractor(comp, pitch=PITCH)
    got = list(ex.extract_iter(batches, min_batch=6))
    assert len(asked) == len(batches)
    assert ex.stats["pitch_kernel_steps"] == ex.stats["pitch_steps"] == 6 * sum(asked) > 0
    assert set(seen) == {("cpu", torch.float32, 418)}
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
