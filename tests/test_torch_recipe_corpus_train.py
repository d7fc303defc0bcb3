"""Corpus -> training integration recipe on the port, on the CPU.

The twin of ``tests/test_recipe_corpus_train.py``: real-speech wavs on disk
-> the port's ``signals-to-torch-feat-dir`` (batched extraction; its files
within 1e-4 of the JAX command's) ->
:class:`speech_tpu_torch.corpus.FeatureCorpus` in feature-file mode (reads
the CLI's ``.pt`` files back exactly; no re-extraction) ->
:class:`speech_tpu_torch.nn.FeatureFrontend` + a KWS ``make_train_step``
loop -> a mid-run :class:`~speech_tpu_torch.models.TrainCheckpointer`
resume (bitwise equal to the uninterrupted run) -> held-out accuracy of at
least 0.9 on unseen crops, as the reference recipe asks.
"""

import json
import os
import wave

import numpy as np
import torch

from speech_tpu import command_line as jcli

from speech_tpu_torch import command_line as tcli
from speech_tpu_torch.corpus import FeatureCorpus
from speech_tpu_torch.io import read_signal
from speech_tpu_torch.models import TrainCheckpointer, make_train_step
from speech_tpu_torch.models.kws import KWSModel
from speech_tpu_torch.nn import FeatureFrontend
from speech_tpu_torch.ops.resample import resample_np

RATE = 16000
SEG = RATE
NUM_CLASSES = 3
FEATURE_DIM = 40
MAX_FRAMES = 80  # 0.8 s crops -> <= 80 frames at 10 ms shift
TOL = 1e-4  # the float tier (tests/test_pallas.py:55)

COMPUTER = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 40, "sampling_rate": 16000},
    "frame_length_ms": 25,
    "frame_shift_ms": 10,
}


def _segments():
    path = os.path.join(os.path.dirname(__file__), "audio", "test.wav")
    sig = resample_np(read_signal(path, dtype=np.float64), 160, 441)  # 44.1 -> 16 kHz
    sig = sig / np.abs(sig).max()
    return [sig[i * SEG: (i + 1) * SEG] for i in range(NUM_CLASSES)]


def _write_corpus(root, segments, rng, per_class, prefix):
    """Seeded wav crops on disk + the CLI map file; labels ride utt ids."""
    wav_dir = root / f"{prefix}_wavs"
    wav_dir.mkdir()
    map_path = root / f"{prefix}_map.txt"
    with open(map_path, "w") as mf:
        for cls in range(NUM_CLASSES):
            for k in range(per_class):
                n = rng.randint(int(0.6 * RATE * 0.8), int(RATE * 0.8))
                off = rng.randint(0, SEG - n + 1)
                crop = segments[cls][off: off + n] + 0.01 * rng.randn(n)
                pcm = np.clip(np.round(crop * 20000), -32767, 32767)
                utt = f"c{cls}_{prefix}{k}"
                path = str(wav_dir / f"{utt}.wav")
                with wave.open(path, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(RATE)
                    w.writeframes(pcm.astype(np.int16).tobytes())
                mf.write(f"{utt} {path}\n")
    return str(map_path)


def _extract(cli, map_path, out_dir, cfg):
    assert cli.signals_to_torch_feat_dir(
        [map_path, json.dumps(cfg), str(out_dir), "--batch-size", "8"]) == 0


def _corpus_batches(out_dir, batch_size, seed):
    """CLI feat dir -> FeatureCorpus feature-file mode -> fixed-shape
    padded batches ``(feats, counts, labels)``."""
    utt2path = sorted(
        (name[: -len(".pt")], os.path.join(out_dir, name))
        for name in os.listdir(out_dir)
        if name.endswith(".pt")
    )
    order = np.random.RandomState(seed).permutation(len(utt2path))
    utt2path = [utt2path[i] for i in order]
    corpus = FeatureCorpus(None, utt2path, batch_size=batch_size, sort_by_length=False)
    batches = []
    for utts, feats in corpus:
        b = len(feats)
        arr = np.zeros((b, MAX_FRAMES, FEATURE_DIM), np.float32)
        counts = np.zeros((b,), np.int64)
        labels = np.zeros((b,), np.int64)
        for i, (u, f) in enumerate(zip(utts, feats)):
            # feature-file mode reads the CLI's float32 files back exactly
            np.testing.assert_array_equal(
                f, torch.load(os.path.join(out_dir, u + ".pt")).numpy())
            t = min(len(f), MAX_FRAMES)
            arr[i, :t] = f[:t]
            counts[i] = t
            labels[i] = int(u[1])  # utt id "c<cls>_..."
        batches.append((torch.from_numpy(arr), torch.from_numpy(counts),
                        torch.from_numpy(labels)))
    return batches


def _model():
    model = KWSModel(FeatureFrontend(FEATURE_DIM, device="cpu"), num_classes=NUM_CLASSES,
                     channels=(16, 16), kernel_width=5,
                     generator=torch.Generator().manual_seed(3))
    return model, torch.optim.Adam(model.parameters(), lr=3e-3)


def _run(model, opt, batches, n_steps, start=0):
    step = make_train_step(model, opt)
    metrics = None
    for s in range(start, n_steps):
        metrics = step(*batches[s % len(batches)])
    return metrics


def test_cli_corpus_to_training_with_resume(tmp_path):
    segments = _segments()
    rng = np.random.RandomState(77)
    train_map = _write_corpus(tmp_path, segments, rng, 12, "train")
    held_map = _write_corpus(tmp_path, segments, rng, 4, "held")
    port_cfg = dict(COMPUTER, device="cpu")
    train_dir, held_dir = tmp_path / "train_feats", tmp_path / "held_feats"
    _extract(tcli, train_map, train_dir, port_cfg)
    _extract(tcli, held_map, held_dir, port_cfg)
    assert len(os.listdir(train_dir)) == NUM_CLASSES * 12
    jax_dir = tmp_path / "train_feats_jax"
    _extract(jcli, train_map, jax_dir, COMPUTER)
    for name in os.listdir(jax_dir):
        np.testing.assert_allclose(torch.load(train_dir / name).numpy(),
                                   torch.load(jax_dir / name).numpy(), rtol=0, atol=TOL)

    train_batches = _corpus_batches(str(train_dir), 12, seed=5)
    held_batches = _corpus_batches(str(held_dir), 12, seed=6)
    n_total, n_break = 60, 24

    model, opt = _model()
    metrics = _run(model, opt, train_batches, n_total)
    assert np.isfinite(float(metrics["loss"]))

    # interrupted: checkpoint mid-training, restore into a fresh model and
    # optimizer through a fresh checkpointer, resume: bitwise equal
    part, part_opt = _model()
    _run(part, part_opt, train_batches, n_break)
    ck_dir = str(tmp_path / "ckpt")
    with TrainCheckpointer(ck_dir) as ck:
        ck.save(n_break, part, part_opt)
    resumed, resumed_opt = _model()
    with TrainCheckpointer(ck_dir) as ck2:
        step_no, resumed, resumed_opt, _ = ck2.restore(like=(resumed, resumed_opt))
    assert step_no == n_break
    _run(resumed, resumed_opt, train_batches, n_total, start=n_break)
    for a, b in zip(model.parameters(), resumed.parameters()):
        assert torch.equal(a, b)

    # held-out decode through the same CLI -> loader path
    correct = total = 0
    with torch.no_grad():
        for feats, counts, labels in held_batches:
            pred = torch.argmax(model(feats, counts), dim=-1)
            correct += int((pred == labels).sum())
            total += len(pred)
    acc = correct / total
    assert acc >= 0.9, f"held-out accuracy {acc} ({correct}/{total})"
