"""speech_tpu_torch.models.ctc against speech_tpu.models.ctc, on the CPU in
float64.

The port's model is loaded with the JAX model's parameters
(``params_from_jax``) and both run the same numpy inputs: the encoder and
the log probabilities within 1e-10; the CTC loss per example, an
infeasible row (more labels than frames can align) included, within 1e-10
of ``optax.ctc_loss``; gradients within rtol 1e-8; one SGD and one Adam
step against optax's within 1e-10; ``greedy_decode`` and
``beam_search_decode`` against the JAX package's outputs; and the cases of
``tests/test_models_ctc.py`` on the port (padding invariance, the decoders'
semantics, freezing, a few training steps).
"""

import itertools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import speech_tpu
from speech_tpu import nn as jnn
from speech_tpu.models import ctc as jctc

import speech_tpu_torch
from speech_tpu_torch import models as tmodels
from speech_tpu_torch import nn as tnn
from speech_tpu_torch.models import ctc as tctc

TOL = 1e-10
RTOL_GRAD = 1e-8
LR = 1e-2
SR = 8000
SEG = 800  # samples per symbol segment
TONES = {1: 500.0, 2: 2000.0}  # symbol id -> tone frequency
KW = dict(model_dim=32, num_layers=1, num_heads=2, ffn_dim=64, subsample_strides=(2,))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _frontends():
    kw = dict(frame_length_ms=25, frame_shift_ms=10, dtype="float64")
    bank = {"name": "fbank", "num_filts": 8, "sampling_rate": SR}
    jc = speech_tpu.compute.STFTFrameComputer(dict(bank), **kw)
    tc = speech_tpu_torch.compute.STFTFrameComputer(dict(bank), device="cpu", **kw)
    return jnn.STFTFrontend(jc, dtype=jnp.float64), tnn.STFTFrontend(tc, dtype=torch.float64)


def _tone_sequence_batch(rng, batch, max_syms=3):
    """Utterances made of tone segments; labels are the tone ids."""
    max_len = max_syms * SEG
    signals = np.zeros((batch, max_len))
    lengths = np.zeros(batch, dtype=np.int64)
    labels = np.zeros((batch, max_syms), dtype=np.int64)
    label_lengths = np.zeros(batch, dtype=np.int64)
    t = np.arange(SEG) / SR
    for i in range(batch):
        n = rng.randint(1, max_syms + 1)
        seq = rng.randint(1, 3, size=n)
        for j, sym in enumerate(seq):
            signals[i, j * SEG: (j + 1) * SEG] = np.sin(
                2 * np.pi * TONES[sym] * t + rng.uniform(0, 2 * np.pi))
        signals[i, : n * SEG] += 0.05 * rng.randn(n * SEG)
        lengths[i] = n * SEG
        labels[i, :n] = seq
        label_lengths[i] = n
    return signals, lengths, labels, label_lengths


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(seed=0, train_frontend=True):
    jf, tf = _frontends()
    jm = jctc.CTCModel(jf, vocab_size=2, train_frontend=train_frontend, **KW)
    tm = tctc.CTCModel(tf, vocab_size=2, train_frontend=train_frontend, **KW)
    params, consts = jm.init(jax.random.PRNGKey(seed))
    # a non-zero head, so that the log probabilities follow the encoder
    params["head"]["w"] = jax.random.normal(jax.random.PRNGKey(7), params["head"]["w"].shape,
                                            dtype=jnp.float64)
    tmodels.params_from_jax(tm, params)
    return jm, params, consts, tm


def _batch():
    """Four utterances; the last row's labels (five, with a repeat) cannot
    be aligned in its frames: optax's ``log_epsilon`` gives it a large
    finite loss."""
    signals, lengths, labels, label_lengths = _tone_sequence_batch(
        np.random.RandomState(4242), 4)
    labels = np.concatenate([labels, np.zeros((4, 3), np.int64)], axis=1)
    lengths[3] = 560  # 7 frames of 10 ms, 4 after the stride-2 subsampling
    signals[3, lengths[3]:] = 0.0
    labels[3] = [1, 1, 2, 1, 2, 0]
    label_lengths[3] = 5
    return signals, lengths, labels, label_lengths


@pytest.fixture(scope="module")
def ref():
    jm, params, consts, _ = _pair()
    batch = _batch()
    log_probs, counts = jax.jit(lambda p, s, n: jm.apply(p, consts, s, n))(params, *batch[:2])
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, *b: jm.loss(p, consts, *b), has_aux=True))(params, *batch)
    steps = {}
    for name, tx in (("sgd", optax.sgd(LR)), ("adam", optax.adam(LR))):
        updates, _ = tx.update(grads, tx.init(params), params)
        steps[name] = _flat(optax.apply_updates(params, updates))
    return dict(params=params, batch=batch, log_probs=np.asarray(log_probs),
                counts=np.asarray(counts), loss=float(loss),
                per_example=np.asarray(aux["per_example"]), grads=_flat(grads), steps=steps)


def _loaded(ref):
    _, tf = _frontends()
    tm = tctc.CTCModel(tf, vocab_size=2, **KW)
    tmodels.params_from_jax(tm, ref["params"])
    return tm


def test_log_probs_match_jax(ref):
    tm = _loaded(ref)
    log_probs, counts = tm(*ref["batch"][:2])
    assert np.array_equal(_np(counts), ref["counts"])
    assert np.array_equal(_np(tm.out_frame_counts(ref["batch"][1])), ref["counts"])
    got = _np(log_probs)
    for i, c in enumerate(ref["counts"]):
        np.testing.assert_allclose(got[i, :c], ref["log_probs"][i, :c], rtol=0, atol=TOL)


def test_ctc_loss_matches_optax_with_an_infeasible_row(ref):
    tm = _loaded(ref)
    loss, aux = tm.loss(*ref["batch"])
    per = _np(aux["per_example"])
    assert ref["counts"][3] == 4 and per[3] > 1e4  # the infeasible row: finite, about 1e5
    assert np.isfinite(per).all()
    np.testing.assert_allclose(per, ref["per_example"], rtol=0, atol=TOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=0, atol=TOL)


def test_ctc_loss_function_matches_optax_on_random_logits():
    """``ctc_loss`` alone on random logits with ragged paddings, a repeated
    label and a row of all padding."""
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 9, 4)
    logit_pad = (np.arange(9)[None] >= np.array([9, 7, 3, 9, 0])[:, None]).astype(np.float64)
    labels = rng.randint(1, 4, size=(5, 4))
    labels[0, :2] = 2  # a repeat
    label_pad = (np.arange(4)[None] >= np.array([4, 2, 3, 0, 1])[:, None]).astype(np.float64)
    want = optax.ctc_loss(logits, logit_pad, labels, label_pad)
    got = tctc.ctc_loss(torch.tensor(logits), torch.tensor(logit_pad), torch.tensor(labels),
                        torch.tensor(label_pad))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


def test_gradients_match_jax(ref):
    tm = _loaded(ref)
    tm.loss(*ref["batch"])[0].backward()
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        want = ref["grads"][key]
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(_np(p.grad), want, rtol=RTOL_GRAD,
                                   atol=RTOL_GRAD * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_matches_optax(ref, opt):
    tm = _loaded(ref)
    optimizer = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt](tm.parameters(), lr=LR)
    metrics = tctc.make_train_step(tm, optimizer)(*ref["batch"])
    assert "accuracy" not in metrics
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=0, atol=TOL)
    got = {n.replace(".", "/"): _np(p) for n, p in tm.named_parameters()}
    for key, want in ref["steps"][opt].items():
        np.testing.assert_allclose(got[key], want, rtol=0, atol=TOL, err_msg=key)


def test_encoder_matches_jax_and_padding_invariance():
    jenc = jctc.TransformerEncoder(16, num_layers=2, num_heads=2, ffn_dim=32, dtype=jnp.float64)
    params = jenc.init(jax.random.PRNGKey(0))
    tenc = tctc.TransformerEncoder(16, num_layers=2, num_heads=2, ffn_dim=32,
                                   dtype=torch.float64, device="cpu")
    tmodels.params_from_jax(tenc, params)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 12, 16)
    counts = np.array([12, 7, 2])
    base = _np(tenc(x, counts))
    np.testing.assert_allclose(base, np.asarray(jenc.apply(params, x, jnp.asarray(counts))),
                               rtol=0, atol=TOL)
    wide = _np(tenc(np.concatenate([x, 50.0 + rng.randn(3, 5, 16)], axis=1), counts))
    np.testing.assert_allclose(wide[:, :12], base, rtol=0, atol=TOL)
    assert np.abs(wide[1, 7:]).max() == 0.0


def test_float32_encoder_masks_with_a_finite_bias():
    """The float32 key bias is -1e9 (-1e300 would be -inf there)."""
    enc = tctc.TransformerEncoder(8, num_layers=1, num_heads=2, device="cpu")
    out = enc(np.random.RandomState(6).randn(2, 5, 8), [5, 0])
    assert torch.isfinite(out).all() and not out[1].any()


def test_model_padding_invariance():
    _, _, _, tm = _pair()
    signals, lengths, _, _ = _tone_sequence_batch(np.random.RandomState(8), 3)
    base, counts = tm(signals, lengths)
    wide, wide_counts = tm(np.concatenate([signals, 10.0 + np.random.RandomState(9).randn(
        3, 2 * SEG)], axis=1), lengths)
    assert torch.equal(counts, wide_counts)
    for i, c in enumerate(_np(counts)):
        np.testing.assert_allclose(_np(wide[i, :c]), _np(base[i, :c]), rtol=0, atol=1e-9)


def test_decoders_match_jax():
    rng = np.random.RandomState(10)
    logits = rng.randn(3, 7, 4)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    counts = np.array([7, 4, 0])
    for got, want in zip(tctc.greedy_decode(torch.tensor(lp), torch.tensor(counts)),
                         jctc.greedy_decode(lp, counts)):
        assert np.array_equal(got, want)
    for (gs, gl), (ws, wl) in zip(tctc.beam_search_decode(lp, counts, beam_width=5),
                                  jctc.beam_search_decode(lp, counts, beam_width=5)):
        assert np.array_equal(gs, ws) and gl == wl


def test_greedy_decode_collapse_semantics():
    path = [1, 1, 0, 1, 2, 2, 0, 0]
    lp = np.full((1, len(path), 3), -10.0)
    for t, s in enumerate(path):
        lp[0, t, s] = 0.0
    assert tctc.greedy_decode(lp, np.asarray([len(path)]))[0].tolist() == [1, 1, 2]
    assert tctc.greedy_decode(lp, np.asarray([4]))[0].tolist() == [1, 1]
    assert tctc.greedy_decode(lp, np.asarray([2]))[0].tolist() == [1]
    assert tctc.greedy_decode(lp, np.asarray([0]))[0].size == 0


def _exhaustive_ctc_best(lp, count, blank=0):
    totals = {}
    for path in itertools.product(range(lp.shape[1]), repeat=int(count)):
        score = sum(lp[t, s] for t, s in enumerate(path))
        seq, prev = [], None
        for s in path:
            if s != prev:
                seq.append(s)
            prev = s
        seq = tuple(s for s in seq if s != blank)
        if seq in totals:
            hi, lo = max(totals[seq], score), min(totals[seq], score)
            totals[seq] = hi + np.log1p(np.exp(lo - hi))
        else:
            totals[seq] = score
    best = max(totals.items(), key=lambda kv: kv[1])
    return np.asarray(best[0], dtype=np.int64), best[1]


def test_beam_search_matches_exhaustive_and_beats_greedy():
    rng = np.random.RandomState(3)
    for _ in range(3):
        logits = rng.randn(1, 4, 3)
        lp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        want_seq, want_lp = _exhaustive_ctc_best(lp[0], 4)
        ((seq, score),) = tctc.beam_search_decode(lp, np.asarray([4]), beam_width=1000)
        assert np.array_equal(seq, want_seq)
        np.testing.assert_allclose(score, want_lp, atol=1e-12)
    lp = np.log(np.asarray([[0.6, 0.25, 0.15], [0.6, 0.25, 0.15]]))[None]
    assert tctc.greedy_decode(lp, np.asarray([2]))[0].size == 0
    ((seq, score),) = tctc.beam_search_decode(lp, np.asarray([2]), beam_width=8)
    assert seq.tolist() == [1]
    np.testing.assert_allclose(np.exp(score), 0.3625, atol=1e-12)
    with pytest.raises(ValueError):
        tctc.beam_search_decode(lp, np.asarray([2]), beam_width=0)


def test_freeze_frontend_leaves_its_gradients_none():
    _, _, _, tm = _pair(train_frontend=False)
    tm.loss(*_tone_sequence_batch(np.random.RandomState(11), 2))[0].backward()
    assert tm.frontend.window.grad is None and tm.frontend.weights.grad is None
    assert np.abs(_np(tm.head.w.grad)).max() > 0
    assert any(np.abs(_np(p.grad)).max() > 0 for p in tm.encoder.parameters())


def test_init_follows_the_reference_law():
    _, tf = _frontends()
    tm = tctc.CTCModel(tf, vocab_size=28, model_dim=128, ffn_dim=512,
                       generator=torch.Generator().manual_seed(6))
    got = {n.replace(".", "/"): _np(p) for n, p in tm.named_parameters()}
    jm = jctc.CTCModel(_frontends()[0], vocab_size=28, model_dim=128, ffn_dim=512)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in _flat(jparams).items()}
    for key, std in (("encoder/layer0/wq", np.sqrt(1.0 / 128)),
                     ("encoder/layer1/ffn2/w", np.sqrt(1.0 / 512)),
                     ("subsample/conv1/w", np.sqrt(2.0 / (3 * 128)))):
        assert abs(got[key].std() / std - 1) < 0.1, key
    assert not got["head/w"].any() and (got["encoder/ln_out/g"] == 1).all()


def test_loss_falls_over_a_few_adam_steps():
    _, tf = _frontends()
    tm = tctc.CTCModel(tf, vocab_size=2, **KW)
    step = tctc.make_train_step(tm, torch.optim.Adam(tm.parameters(), lr=5e-3))
    batch = _tone_sequence_batch(np.random.RandomState(7), 8)
    losses = [float(step(*batch)["loss"]) for _ in range(8)]
    assert losses[-1] < 0.8 * losses[0], losses


def test_validates_config():
    _, tf = _frontends()
    with pytest.raises(ValueError):
        tctc.CTCModel(tf, vocab_size=0)
    with pytest.raises(ValueError):
        tctc.CTCModel(tf, vocab_size=2, subsample_strides=(0,))
    with pytest.raises(ValueError):
        tctc.CTCModel(tf, vocab_size=2, subsample_width=0)
    with pytest.raises(ValueError):
        tctc.TransformerEncoder(15, num_heads=4, device="cpu")
    with pytest.raises(ValueError):
        tctc.TransformerEncoder(16, num_layers=0, device="cpu")
    enc = tctc.TransformerEncoder(16, max_len=8, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        enc(np.zeros((1, 9, 16)))
