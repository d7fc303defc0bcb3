"""speech_tpu_torch.models.speaker against speech_tpu.models.speaker, on the
CPU in float64.

The port's model is loaded with the JAX model's parameters
(``params_from_jax``) and both run the same numpy inputs: embeddings and
the AAM-softmax loss within 1e-10, gradients within rtol 1e-8, one SGD and
one Adam step against optax's within 1e-10; ``aam_softmax_loss`` (both trig
branches) and ``cosine_scores`` against the JAX functions and a numpy
oracle; and the cases of ``tests/test_models_speaker.py`` on the port
(padding invariance, finite gradients at cosines of exactly +/-1, the
margin-free accuracy, freezing, a few training steps, the stream and its
pool).
"""

import math

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import speech_tpu
from speech_tpu import nn as jnn
from speech_tpu.models import speaker as jspk

import speech_tpu_torch
from speech_tpu_torch import models as tmodels
from speech_tpu_torch import nn as tnn
from speech_tpu_torch.models import speaker as tspk
from speech_tpu_torch.serve import StreamPool

TOL = 1e-10
RTOL_GRAD = 1e-8
TOL_STREAM = 1e-9
LR = 1e-2
RATE = 8000
KW = dict(channels=(16, 16, 16), kernel_widths=(5, 3, 1), embed_dim=16)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _frontends():
    kw = dict(frame_length_ms=25, frame_shift_ms=10, dtype="float64")
    bank = {"name": "fbank", "num_filts": 8, "sampling_rate": RATE}
    jc = speech_tpu.compute.STFTFrameComputer(dict(bank), **kw)
    tc = speech_tpu_torch.compute.STFTFrameComputer(dict(bank), device="cpu", **kw)
    return jnn.STFTFrontend(jc, dtype=jnp.float64), tnn.STFTFrontend(tc, dtype=torch.float64)


def _speaker_batch(rng, batch, num_speakers=4, max_len=2400, sr=RATE):
    """Toy speakers: each speaker is a narrow tone band."""
    signals = np.zeros((batch, max_len))
    lengths = rng.randint(max_len // 2, max_len + 1, size=batch)
    labels = rng.randint(0, num_speakers, size=batch)
    bands = np.linspace(300.0, 3200.0, num_speakers + 1)
    t = np.arange(max_len) / sr
    for i in range(batch):
        lo, hi = bands[labels[i]], bands[labels[i] + 1]
        freq = rng.uniform(lo + 0.2 * (hi - lo), hi - 0.2 * (hi - lo))
        sig = rng.uniform(0.5, 1.5) * np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi))
        sig += 0.05 * rng.randn(max_len)
        sig[lengths[i]:] = 0.0
        signals[i] = sig
    return signals, lengths, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(seed=0, train_frontend=True, **kw):
    jf, tf = _frontends()
    kw = {**KW, **kw}
    jm = jspk.SpeakerModel(jf, num_speakers=4, train_frontend=train_frontend, **kw)
    tm = tspk.SpeakerModel(tf, num_speakers=4, train_frontend=train_frontend, **kw)
    params, consts = jm.init(jax.random.PRNGKey(seed))
    tmodels.params_from_jax(tm, params)
    return jm, params, consts, tm


@pytest.fixture(scope="module")
def ref():
    """The JAX model's embeddings, loss, gradients and optimizer steps on a
    fixed batch (computed once)."""
    jm, params, consts, _ = _pair()
    batch = _speaker_batch(np.random.RandomState(5678), 4)
    emb = jax.jit(lambda p, s, n: jm.embed(p, consts, s, n))(params, *batch[:2])
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, *b: jm.loss(p, consts, *b), has_aux=True))(params, *batch)
    steps = {}
    for name, tx in (("sgd", optax.sgd(LR)), ("adam", optax.adam(LR))):
        updates, _ = tx.update(grads, tx.init(params), params)
        steps[name] = _flat(optax.apply_updates(params, updates))
    return dict(jm=jm, params=params, consts=consts, batch=batch, emb=np.asarray(emb),
                loss=float(loss), acc=float(aux["accuracy"]), grads=_flat(grads), steps=steps)


def _loaded(ref, **kw):
    _, tf = _frontends()
    tm = tspk.SpeakerModel(tf, num_speakers=4, **{**KW, **kw})
    tmodels.params_from_jax(tm, ref["params"])
    return tm


def test_embed_and_loss_match_jax(ref):
    tm = _loaded(ref)
    signals, lengths, labels = ref["batch"]
    np.testing.assert_allclose(_np(tm.embed(signals, lengths)), ref["emb"], rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tm(signals, lengths)), ref["emb"], rtol=0, atol=TOL)
    loss, aux = tm.loss(signals, lengths, labels)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=0, atol=TOL)
    assert float(aux["accuracy"]) == ref["acc"]


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
    metrics = tspk.make_train_step(tm, optimizer)(*ref["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=0, atol=TOL)
    got = {n.replace(".", "/"): _np(p) for n, p in tm.named_parameters()}
    for key, want in ref["steps"][opt].items():
        np.testing.assert_allclose(got[key], want, rtol=0, atol=TOL, err_msg=key)


def test_encoder_matches_jax_and_padding_invariance():
    jenc = jspk.TDNNEncoder(6, channels=(8, 8), kernel_widths=(5, 4), dilations=(1, 2),
                            dtype=jnp.float64)
    params = jenc.init(jax.random.PRNGKey(0))
    tenc = tspk.TDNNEncoder(6, channels=(8, 8), kernel_widths=(5, 4), dilations=(1, 2),
                            dtype=torch.float64, device="cpu")
    tmodels.params_from_jax(tenc, params)
    rng = np.random.RandomState(1)
    feats = rng.randn(4, 20, 6)
    counts = np.array([20, 13, 7, 1])
    base = _np(tenc(feats, counts))
    want = np.asarray(jenc.apply(params, feats, jnp.asarray(counts)))
    np.testing.assert_allclose(base, want, rtol=0, atol=TOL)
    wide = np.concatenate([feats, 100.0 + rng.randn(4, 9, 6)], axis=1)
    got = _np(tenc(wide, counts))
    np.testing.assert_allclose(got[:, :20], base, rtol=0, atol=1e-12)
    assert np.abs(got[1, 13:]).max() == 0.0


def test_embed_padding_invariance():
    _, _, _, tm = _pair()
    signals, lengths, _ = _speaker_batch(np.random.RandomState(2), 3)
    base = _np(tm.embed(signals, lengths))
    wide = np.concatenate([signals, 10.0 + np.random.RandomState(3).randn(3, 800)], axis=1)
    np.testing.assert_allclose(_np(tm.embed(wide, lengths)), base, rtol=0, atol=1e-9)


def _aam_numpy(emb, w, labels, margin, scale, eps=1e-6):
    emb_n = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), eps)
    w_n = w / np.maximum(np.linalg.norm(w, axis=0, keepdims=True), eps)
    cos = emb_n @ w_n
    sin = np.sqrt(np.maximum(1.0 - cos * cos, 0.0))
    phi = cos * math.cos(margin) - sin * math.sin(margin)
    phi = np.where(cos > -math.cos(margin), phi, cos - margin * math.sin(margin))
    logits = cos.copy()
    rows = np.arange(len(labels))
    logits[rows, labels] = phi[rows, labels]
    logits *= scale
    shifted = logits - logits.max(axis=-1, keepdims=True)
    log_p = shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))
    return -log_p[rows, labels].mean(), logits


@pytest.mark.parametrize("margin, scale", [(0.25, 16.0), (0.0, 30.0), (0.5, 30.0)])
def test_aam_loss_matches_jax_and_numpy(margin, scale):
    rng = np.random.RandomState(int(margin * 100))
    emb = rng.randn(6, 8)
    w = rng.randn(8, 5)
    labels = rng.randint(0, 5, size=6)
    # the monotonicity guard's branch for one row: the embedding exactly
    # opposite its class weight (cos = -1 < -cos(m))
    emb[0] = -w[:, labels[0]]
    got_loss, got_logits = tspk.aam_softmax_loss(torch.tensor(emb), torch.tensor(w),
                                                 torch.tensor(labels), margin=margin, scale=scale)
    j_loss, j_logits = jspk.aam_softmax_loss(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels),
                                             margin=margin, scale=scale)
    np.testing.assert_allclose(got_loss.item(), float(j_loss), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(got_logits), np.asarray(j_logits), rtol=0, atol=TOL)
    want_loss, want_logits = _aam_numpy(emb, w, labels, margin, scale)
    np.testing.assert_allclose(got_loss.item(), want_loss, rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(got_logits), want_logits, rtol=0, atol=TOL)


def test_aam_margin_semantics():
    rng = np.random.RandomState(8)
    emb, w, labels = (torch.tensor(rng.randn(6, 8)), torch.tensor(rng.randn(8, 5)),
                      torch.tensor(rng.randint(0, 5, size=6)))
    plain, _ = tspk.aam_softmax_loss(emb, w, labels, margin=0.0, scale=16.0)
    penalized, _ = tspk.aam_softmax_loss(emb, w, labels, margin=0.3, scale=16.0)
    assert penalized.item() > plain.item()


def test_aam_gradient_finite_at_degenerate_cosines():
    """cos == +/-1 (embedding on a class-weight ray) must not NaN the
    gradients, and they equal the JAX package's."""
    rng = np.random.RandomState(9)
    w = rng.randn(8, 5)
    labels = np.array([0, 1, 2])
    emb = np.stack([2.0 * w[:, 0], -3.0 * w[:, 1], rng.randn(8)])
    te, tw = torch.tensor(emb, requires_grad=True), torch.tensor(w, requires_grad=True)
    tspk.aam_softmax_loss(te, tw, torch.tensor(labels), margin=0.2, scale=30.0)[0].backward()
    ge, gw = jax.grad(lambda e, ww: jspk.aam_softmax_loss(e, ww, jnp.asarray(labels),
                                                          margin=0.2, scale=30.0)[0],
                      argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    for got, want in ((te.grad, ge), (tw.grad, gw)):
        assert np.isfinite(_np(got)).all()
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL_GRAD,
                                   atol=RTOL_GRAD * scale)


def test_cosine_scores_match_jax():
    rng = np.random.RandomState(10)
    a, b = rng.randn(5, 7), rng.randn(3, 7)
    b[1] = 0.0  # the eps floor of a zero embedding
    np.testing.assert_allclose(_np(tspk.cosine_scores(a, b)),
                               np.asarray(jspk.cosine_scores(a, b)), rtol=0, atol=TOL)


def test_accuracy_metric_ignores_margin_penalty():
    _, tf = _frontends()
    tm = tspk.SpeakerModel(tf, num_speakers=2, margin=0.5, **KW)
    signals, lengths, _ = _speaker_batch(np.random.RandomState(11), 2, num_speakers=2)
    e = _np(tm.embed(signals, lengths))
    rng = np.random.RandomState(12)
    w = np.stack([e[0] + 0.05 * rng.randn(*e[0].shape), e[1] + 0.05 * rng.randn(*e[1].shape)],
                 axis=1)
    with torch.no_grad():
        tm.head.w.copy_(torch.tensor(w))
    _, aux = tm.loss(signals, lengths, [0, 1])
    assert float(aux["accuracy"]) == 1.0


def test_freeze_frontend_leaves_its_gradients_none():
    signals, lengths, labels = _speaker_batch(np.random.RandomState(13), 4)
    _, _, _, tm = _pair(train_frontend=False)
    tm.loss(signals, lengths, labels)[0].backward()
    assert tm.frontend.window.grad is None and tm.frontend.weights.grad is None
    assert np.abs(_np(tm.embedding.w.grad)).max() > 0
    assert np.abs(_np(tm.head.w.grad)).max() > 0


def test_init_follows_the_reference_law():
    _, tf = _frontends()
    tm = tspk.SpeakerModel(tf, num_speakers=300, embed_dim=192, channels=(128, 128, 128),
                           generator=torch.Generator().manual_seed(4))
    got = {n.replace(".", "/"): _np(p) for n, p in tm.named_parameters()}
    jm = jspk.SpeakerModel(_frontends()[0], num_speakers=300, embed_dim=192,
                           channels=(128, 128, 128))
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in _flat(jparams).items()}
    for key, std in (("encoder/tdnn1/w", np.sqrt(2.0 / (3 * 128))),
                     ("embed/w", np.sqrt(1.0 / 256)), ("head/w", np.sqrt(1.0 / 192))):
        assert abs(got[key].std() / std - 1) < 0.1, key
    for key in ("encoder/tdnn0/b", "encoder/tdnn2/b", "embed/b"):
        assert not got[key].any(), key


def test_loss_falls_over_a_few_adam_steps():
    _, tf = _frontends()
    tm = tspk.SpeakerModel(tf, num_speakers=4, **KW)
    step = tspk.make_train_step(tm, torch.optim.Adam(tm.parameters(), lr=3e-3))
    batch = _speaker_batch(np.random.RandomState(99), 16)
    losses = [float(step(*batch)["loss"]) for _ in range(8)]
    assert losses[-1] < 0.8 * losses[0], losses


def test_streaming_speaker_matches_batch_at_full_window():
    _, _, _, tm = _pair(seed=2)
    signals, lengths, _ = _speaker_batch(np.random.RandomState(14), 1, max_len=3200)
    sig = signals[0][: lengths[0]]
    want = _np(tm.embed(sig[None], [len(sig)]))[0]
    ss = tspk.StreamingSpeaker(tm, window_frames=200, chunk_size=800)
    state = ss.init_state()
    for start in range(0, len(sig), 800):
        chunk = np.zeros(800)
        piece = sig[start: start + 800]
        chunk[: len(piece)] = piece
        state, _ = ss.process(state, chunk, len(piece))
    np.testing.assert_allclose(_np(ss.finalize(state)), want, rtol=0, atol=TOL_STREAM)


def test_streaming_speaker_pools_and_validates():
    jm, params, consts, tm = _pair(seed=2)
    ss = tspk.StreamingSpeaker(tm, window_frames=100, chunk_size=640)
    pool = StreamPool(ss, slots=2)
    sig = _speaker_batch(np.random.RandomState(15), 1, max_len=1920)[0][0]
    h = pool.open()
    pool.feed(h, sig)
    closed = dict(pool.close_many([h]))
    want = np.asarray(jm.embed(params, consts, sig[None], jnp.asarray([len(sig)])))[0]
    np.testing.assert_allclose(closed[h][-1], want, rtol=0, atol=TOL_STREAM)
    with pytest.raises(ValueError):
        tspk.StreamingSpeaker(tm, window_frames=0, chunk_size=640)


def test_validates_config():
    _, tf = _frontends()
    with pytest.raises(ValueError):
        tspk.SpeakerModel(tf, num_speakers=1)
    with pytest.raises(ValueError):
        tspk.SpeakerModel(tf, num_speakers=4, embed_dim=0)
    with pytest.raises(ValueError):
        tspk.SpeakerModel(tf, num_speakers=4, margin=2.0)
    with pytest.raises(ValueError):
        tspk.SpeakerModel(tf, num_speakers=4, scale=0.0)
    with pytest.raises(ValueError):
        tspk.TDNNEncoder(8, channels=(8, 8), kernel_widths=(3,), device="cpu")
    with pytest.raises(ValueError):
        tspk.TDNNEncoder(8, channels=(8,), kernel_widths=(0,), device="cpu")
