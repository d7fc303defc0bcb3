"""speech_tpu_torch.models.checkpoint and .presets.

``TrainCheckpointer`` holds the contract of
``tests/test_models_checkpoint.py`` on torch files: a run interrupted after
step k and resumed from the checkpoint ends bitwise equal to the
uninterrupted run (parameters and optimizer state round-trip exactly), a
chained optimizer (Adam with weight decay, gradient clipping, a cosine LR
schedule) round-trips its state, rotation keeps the newest ``max_to_keep``
steps, writes are atomic, async saves land after ``wait()``, ``extra``
round-trips, and the reference's errors for a missing step and for an
``extra_like`` of a checkpoint saved without one.  The presets equal the
JAX package's table, and each preset's computer gives the JAX preset's
features (float64, within 1e-10).
"""

import os
import threading

import numpy as np
import pytest

import torch

from speech_tpu.models import presets as jpresets

import speech_tpu_torch
from speech_tpu_torch import models as tmodels
from speech_tpu_torch import nn as tnn
from speech_tpu_torch.models import TrainCheckpointer
from speech_tpu_torch.models import presets as tpresets


def _model(seed=0):
    computer = speech_tpu_torch.compute.STFTFrameComputer(
        {"name": "fbank", "num_filts": 8, "sampling_rate": 8000},
        frame_length_ms=25, frame_shift_ms=10, dtype="float64", device="cpu",
    )
    return tmodels.KWSModel(tnn.STFTFrontend(computer, dtype=torch.float64), num_classes=2,
                            channels=(8,), kernel_width=3,
                            generator=torch.Generator().manual_seed(seed))


def _batch(rng, batch=8, max_len=1600, sr=8000):
    signals = np.zeros((batch, max_len))
    lengths = rng.randint(max_len // 2, max_len + 1, size=batch)
    labels = rng.randint(0, 2, size=batch)
    t = np.arange(max_len) / sr
    for i in range(batch):
        freq = rng.uniform(*((200.0, 600.0) if labels[i] == 0 else (1500.0, 3200.0)))
        sig = np.sin(2 * np.pi * freq * t) + 0.1 * rng.randn(max_len)
        sig[lengths[i]:] = 0.0
        signals[i] = sig
    return signals, lengths, labels


def _equal_states(a, b):
    """Bitwise equality of two (nested) state dicts."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _equal_states(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_states(x, y)
    else:
        assert a == b


def _params_equal(m1, m2):
    for (n1, p1), (n2, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def test_resume_matches_uninterrupted_run_bitwise(tmp_path):
    batches = [_batch(np.random.RandomState(100 + i)) for i in range(5)]
    ref = _model()
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-3)
    step = tmodels.make_train_step(ref, ref_opt)
    for b in batches:
        step(*b)

    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = tmodels.make_train_step(model, opt)
    for b in batches[:3]:
        step(*b)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ckpt:
        ckpt.save(3, model, opt, extra={"epoch": 1, "cursor": torch.tensor([3, 4])})

    fresh = _model(seed=99)  # a different init
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ckpt:
        at, p2, o2, extra = ckpt.restore(like=(fresh, fresh_opt), extra_like={"epoch": 0})
    assert at == 3 and p2 is fresh and o2 is fresh_opt
    assert extra["epoch"] == 1 and extra["cursor"].tolist() == [3, 4]
    step2 = tmodels.make_train_step(fresh, fresh_opt)
    for b in batches[3:]:
        step2(*b)
    _params_equal(ref, fresh)
    _equal_states(ref_opt.state_dict(), fresh_opt.state_dict())


def test_chained_optimizer_state_roundtrip(tmp_path):
    """Adam with weight decay, gradient clipping and a cosine schedule: the
    schedule's count and every moment survive the round trip, and one more
    step from each is bitwise equal."""
    model = _model(4)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=100)
    b = _batch(np.random.RandomState(7))

    def step(m, o, s):
        loss, _ = m.loss(*b)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(m.parameters(), 1.0)
        o.step()
        o.zero_grad()
        s.step()

    for _ in range(3):
        step(model, opt, sched)
    with TrainCheckpointer(str(tmp_path / "chain")) as ckpt:
        ckpt.save(3, model, {"optimizer": opt, "schedule": sched})
        twin = _model(8)
        twin_opt = torch.optim.AdamW(twin.parameters(), lr=1e-3, weight_decay=1e-4)
        twin_sched = torch.optim.lr_scheduler.CosineAnnealingLR(twin_opt, T_max=100)
        ckpt.restore(like=(twin, {"optimizer": twin_opt, "schedule": twin_sched}))
    _params_equal(model, twin)
    _equal_states(opt.state_dict(), twin_opt.state_dict())
    assert twin_sched.last_epoch == 3 and twin_sched.get_last_lr() == sched.get_last_lr()
    step(model, opt, sched)
    step(twin, twin_opt, twin_sched)
    _params_equal(model, twin)
    _equal_states(opt.state_dict(), twin_opt.state_dict())


def test_rotation_and_latest(tmp_path):
    model = _model(1)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2) as ckpt:
        assert ckpt.latest_step() is None
        for s in (1, 2, 3):
            ckpt.save(s, model, opt)
        assert ckpt.latest_step() == 3
        assert ckpt.all_steps() == [2, 3]
        assert sorted(os.listdir(ckpt.directory)) == ["2", "3"]  # no temporaries left
        at, *_ = ckpt.restore(like=(model, opt), step=2)
        assert at == 2
        with pytest.raises(FileNotFoundError):
            ckpt.restore(like=(model, opt), step=1)  # rotated away


def test_a_failed_write_leaves_no_step(tmp_path, monkeypatch):
    """Atomic writes: a save that fails part way leaves neither the step
    nor its temporary directory."""
    model = _model(1)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "atomic")) as ckpt:
        ckpt.save(1, model, opt)

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(torch, "save", boom)
        with pytest.raises(OSError, match="disk full"):
            ckpt.save(2, model, opt)
        assert ckpt.all_steps() == [1]
        assert os.listdir(ckpt.directory) == ["1"]


def test_async_save_overlaps_then_restores(tmp_path):
    """``async_save=True`` copies the state to host memory and returns; the
    training loop may then move the parameters; ``wait()`` makes the step
    durable, and it holds the values at the save."""
    model = _model(5)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tmodels.make_train_step(model, opt)(*_batch(np.random.RandomState(3)))
    saved = _model(5)
    saved.load_state_dict(model.state_dict())
    saved_opt = {k: v for k, v in opt.state_dict().items()}
    with TrainCheckpointer(str(tmp_path / "async"), async_save=True) as ckpt:
        ckpt.save(11, model, opt)
        with torch.no_grad():  # the next step's in-place update
            for p in model.parameters():
                p.add_(1.0)
        ckpt.wait()
        assert ckpt.latest_step() == 11
        twin = _model(6)
        twin_opt = torch.optim.Adam(twin.parameters(), lr=1e-3)
        at, *_ = ckpt.restore(like=(twin, twin_opt))
    assert at == 11
    _params_equal(saved, twin)
    _equal_states(saved_opt, twin_opt.state_dict())


def test_async_save_error_reaches_wait(tmp_path, monkeypatch):
    model = _model(1)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    ckpt = TrainCheckpointer(str(tmp_path / "err"), async_save=True)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    ckpt.save(1, model, opt)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.close()
    assert ckpt.all_steps() == []


def test_restore_without_extra_template_still_works(tmp_path):
    model = _model(10)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "ne")) as ckpt:
        ckpt.save(2, model, opt, extra={"epoch": 4})
        at, _, _, extra = ckpt.restore(like=(_model(11), torch.optim.SGD(
            _model(11).parameters(), lr=1e-2)))
    assert at == 2 and extra == {"epoch": 4}


def test_restore_state_dicts_onto_a_device(tmp_path):
    """A template without stateful objects gets the saved state dicts back,
    moved to ``device``."""
    model = _model(12)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "sd")) as ckpt:
        ckpt.save(1, model.state_dict(), opt.state_dict(), extra={"t": torch.ones(2)})
        at, params, opt_state, extra = ckpt.restore(like=(None, None), device="cpu")
    _equal_states(params, model.state_dict())
    _equal_states(opt_state, opt.state_dict())
    assert torch.equal(extra["t"], torch.ones(2))


def test_restore_params_only_without_optimizer(tmp_path):
    model = _model(6)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    b = _batch(np.random.RandomState(11))
    tmodels.make_train_step(model, opt)(*b)
    with TrainCheckpointer(str(tmp_path / "po")) as ckpt:
        ckpt.save(1, model, opt, extra={"epoch": 3})
    fresh = _model(12)
    with TrainCheckpointer(str(tmp_path / "po")) as ckpt:
        assert ckpt.restore_params(like=fresh) is fresh
    _params_equal(model, fresh)
    assert torch.isfinite(fresh(b[0], b[1])).all()


def test_restore_extra_like_against_extraless_checkpoint_raises(tmp_path):
    model = _model(14)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "xl")) as ckpt:
        ckpt.save(1, model, opt)
        with pytest.raises(ValueError, match="saved without an 'extra'"):
            ckpt.restore(like=(model, opt), extra_like={"epoch": 0})


def test_restore_missing_raises(tmp_path):
    model = _model(2)
    with TrainCheckpointer(str(tmp_path / "empty")) as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore(like=(model, torch.optim.SGD(model.parameters(), lr=1e-2)))
        with pytest.raises(FileNotFoundError):
            ckpt.restore_params(like=model)


def test_extra_refuses_numpy_on_load(tmp_path):
    """``weights_only`` loading: numpy arrays in ``extra`` are refused (the
    docstring's contract: tensors and Python scalars)."""
    model = _model(2)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "np")) as ckpt:
        ckpt.save(1, model, opt, extra={"rng": np.arange(3)})
        with pytest.raises(Exception, match="[Ww]eights only load failed"):
            ckpt.restore(like=(model, opt))


def test_concurrent_saves_from_threads_land(tmp_path):
    model = _model(3)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with TrainCheckpointer(str(tmp_path / "thr"), max_to_keep=None) as ckpt:
        threads = [threading.Thread(target=ckpt.save, args=(s, model, opt)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert ckpt.all_steps() == [0, 1, 2, 3]


# --- presets -------------------------------------------------------------------


def test_presets_table_is_the_reference_table():
    assert tpresets.PRESETS == jpresets.PRESETS
    cfg = tpresets.preset_config("fbank-40-16k")
    cfg["bank"]["num_filts"] = 3
    assert tpresets.PRESETS["fbank-40-16k"]["bank"]["num_filts"] == 40  # a deep copy
    with pytest.raises(KeyError, match="unknown preset"):
        tpresets.preset_config("nope")


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_preset_computers_match_jax(name):
    rng = np.random.RandomState(sorted(jpresets.PRESETS).index(name))
    rate = 8000 if name.endswith("8k") else 16000
    sig = rng.randn(rate // 4)
    want = jpresets.create(name, dtype="float64").compute_full(sig)
    computer = tpresets.create(name, dtype="float64", device="cpu")
    assert type(computer).__name__ == type(jpresets.create(name)).__name__
    got = computer.compute_full(sig)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float64), rtol=0, atol=1e-10)


def test_models_package_surface():
    import speech_tpu.models as jmodels

    assert set(jmodels.__all__) <= set(tmodels.__all__)
    for name in jmodels.__all__:
        assert hasattr(tmodels, name), name
