"""speech_tpu_torch.models.kws against speech_tpu.models.kws, on the CPU in
float64.

The port's model is loaded with the JAX model's parameters
(``params_from_jax``) and both run the same numpy inputs: logits within
1e-10, gradients of the loss within rtol 1e-8, one SGD and one Adam step
against optax's within 1e-10, ``.npz`` checkpoints across the packages bit
for bit.  Also the cases of ``tests/test_models_kws.py`` on the port
(padding invariance, freezing, a few training steps, the streams and their
pool and server) and the data-parallel step at world size 2, one launch of
``tests/torch_dist_worker.py`` (gloo), against the unsharded JAX step
within 1e-12.
"""

import threading

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import speech_tpu
from speech_tpu import nn as jnn
from speech_tpu.filters import GaborFilterBank as JGabor
from speech_tpu.models import kws as jkws

import speech_tpu_torch
from speech_tpu_torch import models as tmodels
from speech_tpu_torch import nn as tnn
from speech_tpu_torch.filters import GaborFilterBank as TGabor
from speech_tpu_torch.models import kws as tkws
from speech_tpu_torch.serve import StreamPool, StreamServer
from speech_tpu_torch.streaming import _tree_leaves

import torch_dist_worker as W

TOL = 1e-10
RTOL_GRAD = 1e-8
TOL_STREAM = 1e-9
LR = 1e-2
RATE = 8000
CHANNELS = (16, 16)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _frontends(num_filts=8):
    kw = dict(frame_length_ms=25, frame_shift_ms=10, dtype="float64")
    bank = {"name": "fbank", "num_filts": num_filts, "sampling_rate": RATE}
    jc = speech_tpu.compute.STFTFrameComputer(dict(bank), **kw)
    tc = speech_tpu_torch.compute.STFTFrameComputer(dict(bank), device="cpu", **kw)
    return jnn.STFTFrontend(jc, dtype=jnp.float64), tnn.STFTFrontend(tc, dtype=torch.float64)


def _tone_batch(rng, batch, max_len=2400, sr=RATE):
    """Two-class toy task: low-band tone (0) vs high-band tone (1)."""
    signals = np.zeros((batch, max_len))
    lengths = rng.randint(max_len // 2, max_len + 1, size=batch)
    labels = rng.randint(0, 2, size=batch)
    t = np.arange(max_len) / sr
    for i in range(batch):
        lo, hi = (200.0, 600.0) if labels[i] == 0 else (1500.0, 3200.0)
        sig = rng.uniform(0.5, 1.5) * np.sin(
            2 * np.pi * rng.uniform(lo, hi) * t + rng.uniform(0, 2 * np.pi))
        sig += 0.1 * rng.randn(max_len)
        sig[lengths[i]:] = 0.0
        signals[i] = sig
    return signals, lengths, labels


def _pair(seed=0, head_seed=9, train_frontend=True, **kw):
    """The JAX model and its params (with a random head, so that every layer
    gets a gradient), and the port's model holding the same values."""
    jf, tf = _frontends()
    kw.setdefault("channels", CHANNELS)
    jm = jkws.KWSModel(jf, num_classes=2, train_frontend=train_frontend, **kw)
    tm = tkws.KWSModel(tf, num_classes=2, train_frontend=train_frontend, **kw)
    params, consts = jm.init(jax.random.PRNGKey(seed))
    if head_seed is not None:
        params["classifier"]["head"]["w"] = jax.random.normal(
            jax.random.PRNGKey(head_seed), params["classifier"]["head"]["w"].shape,
            dtype=jnp.float64)
    tmodels.params_from_jax(tm, params)
    return jm, params, consts, tm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_params(model):
    return {n.replace(".", "/"): _np(p) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its loss, gradients, and one SGD and one Adam step on
    a fixed batch (computed once: the gradient program compiles for
    seconds)."""
    jm, params, consts, _ = _pair()
    batch = _tone_batch(np.random.RandomState(1234), 4)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, *b: jm.loss(p, consts, *b), has_aux=True))(params, *batch)
    steps = {}
    for name, tx in (("sgd", optax.sgd(LR)), ("adam", optax.adam(LR))):
        updates, _ = tx.update(grads, tx.init(params), params)
        steps[name] = _flat(optax.apply_updates(params, updates))
    return dict(jm=jm, params=params, consts=consts, batch=batch, loss=float(loss),
                logits=np.asarray(aux["logits"]), acc=float(aux["accuracy"]),
                grads=_flat(grads), steps=steps)


def _loaded(ref):
    jf, tf = _frontends()
    tm = tkws.KWSModel(tf, num_classes=2, channels=CHANNELS)
    tmodels.params_from_jax(tm, ref["params"])
    return tm


def test_forward_and_loss_match_jax(ref):
    tm = _loaded(ref)
    signals, lengths, labels = ref["batch"]
    np.testing.assert_allclose(_np(tm(signals, lengths)), ref["logits"], rtol=0, atol=TOL)
    loss, aux = tm.loss(signals, lengths, labels)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=0, atol=TOL)
    assert float(aux["accuracy"]) == ref["acc"]


def test_gradients_match_jax(ref):
    tm = _loaded(ref)
    loss, _ = tm.loss(*ref["batch"])
    loss.backward()
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        want = ref["grads"][key]
        got = _np(p.grad)
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(got, want, rtol=RTOL_GRAD,
                                   atol=RTOL_GRAD * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_matches_optax(ref, opt):
    tm = _loaded(ref)
    optimizer = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt](tm.parameters(), lr=LR)
    metrics = tkws.make_train_step(tm, optimizer)(*ref["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=0, atol=TOL)
    assert float(metrics["accuracy"]) == ref["acc"]
    got = _port_params(tm)
    for key, want in ref["steps"][opt].items():
        np.testing.assert_allclose(got[key], want, rtol=0, atol=TOL, err_msg=key)
    assert all(p.grad is None for p in tm.parameters())  # zero_grad ran


def test_classifier_matches_jax_and_padding_invariance():
    jclf = jkws.ConvClassifier(6, 3, channels=(8, 8), kernel_width=4, dtype=jnp.float64)
    params = jclf.init(jax.random.PRNGKey(0))
    params["head"]["w"] = jax.random.normal(jax.random.PRNGKey(1), params["head"]["w"].shape,
                                            dtype=jnp.float64)
    tclf = tkws.ConvClassifier(6, 3, channels=(8, 8), kernel_width=4, dtype=torch.float64,
                               device="cpu")
    tmodels.params_from_jax(tclf, params)
    rng = np.random.RandomState(3)
    feats = rng.randn(4, 21, 6)
    counts = np.array([21, 13, 7, 1])
    base = _np(tclf(feats, counts))
    np.testing.assert_allclose(base, np.asarray(jclf.apply(params, feats, jnp.asarray(counts))),
                               rtol=0, atol=TOL)
    # junk rows past the counts (and more of them) must not move the logits
    wide = np.concatenate([feats, 100.0 + rng.randn(4, 9, 6)], axis=1)
    np.testing.assert_allclose(_np(tclf(wide, counts)), base, rtol=0, atol=1e-12)


@pytest.mark.parametrize("width, stride, dilation", [(5, 2, 1), (4, 2, 1), (3, 1, 2), (4, 1, 3),
                                                     (1, 3, 1)])
def test_masked_conv_block_centres_like_jax(width, stride, dilation):
    """``out[j]`` centred at ``in[j * stride]`` for odd and even widths,
    with dilation, as the JAX block's explicit padding puts it."""
    from speech_tpu.models import _common as jcommon
    from speech_tpu_torch.models import _common as tcommon

    rng = np.random.RandomState(width * 10 + stride)
    x = rng.randn(3, 17, 4)
    block = {"w": rng.randn(width, 4, 5), "b": rng.randn(5)}
    counts = np.array([17, 9, 2])
    want, want_n = jcommon.masked_conv_block(jnp.asarray(x), block, jnp.asarray(counts),
                                             stride=stride, dilation=dilation)
    got, got_n = tcommon.masked_conv_block(
        torch.tensor(x), {k: torch.tensor(v) for k, v in block.items()}, torch.tensor(counts),
        stride=stride, dilation=dilation)
    assert np.array_equal(_np(got_n), np.asarray(want_n))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


def test_init_follows_the_reference_law():
    """Random init cannot match jax.random's draws; it follows the law:
    He-normal conv kernels (std within 10% of sqrt(2 / (W I)) on a wide
    layer), zero biases and head, deterministic for a seed."""
    _, tf = _frontends(num_filts=40)
    gen = torch.Generator().manual_seed(3)
    tm = tkws.KWSModel(tf, num_classes=4, channels=(128, 64), generator=gen)
    jm = jkws.KWSModel(_frontends(num_filts=40)[0], num_classes=4, channels=(128, 64))
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    shapes = {k: v.shape for k, v in _flat(jparams).items()}
    got = _port_params(tm)
    assert {k: v.shape for k, v in got.items()} == shapes
    w = got["classifier/conv1/w"]  # 5 x 128 x 64
    want_std = np.sqrt(2.0 / (5 * 128))
    assert abs(w.std() / want_std - 1) < 0.1
    for key in ("classifier/conv0/b", "classifier/conv1/b", "classifier/head/w",
                "classifier/head/b"):
        assert not got[key].any(), key
    again = tkws.KWSModel(_frontends(num_filts=40)[1], num_classes=4, channels=(128, 64),
                          generator=torch.Generator().manual_seed(3))
    assert all(np.array_equal(a, got[k]) for k, a in _port_params(again).items())


def test_zero_head_gives_uniform_logits():
    _, tf = _frontends()
    tm = tkws.KWSModel(tf, num_classes=2, channels=CHANNELS)
    signals, lengths, _ = _tone_batch(np.random.RandomState(2), 3)
    assert not _np(tm(signals, lengths)).any()


def test_freeze_frontend_leaves_its_gradients_none():
    signals, lengths, labels = _tone_batch(np.random.RandomState(4), 4)
    _, _, _, tm = _pair(train_frontend=False)
    tm.loss(signals, lengths, labels)[0].backward()
    assert tm.frontend.window.grad is None and tm.frontend.weights.grad is None
    assert np.abs(_np(tm.classifier.conv0.w.grad)).max() > 0
    _, _, _, tm = _pair(train_frontend=True)
    tm.loss(signals, lengths, labels)[0].backward()
    for name, p in tm.named_parameters():
        assert np.abs(_np(p.grad)).max() > 0, name


def test_feature_frontend_without_statistics_keeps_its_device():
    """A FeatureFrontend with no mean/std holds no tensor: the model takes
    the frontend's own device (here the CPU), not the default GPU."""
    tm = tkws.KWSModel(tnn.FeatureFrontend(6, device="cpu"), num_classes=2, channels=(4,))
    assert tm.device == torch.device("cpu")
    assert {p.device.type for p in tm.parameters()} == {"cpu"}
    feats = np.random.RandomState(9).randn(2, 7, 6).astype(np.float32)
    assert tuple(tm(feats, np.array([7, 4])).shape) == (2, 2)


def test_junk_past_length_does_not_leak():
    _, _, _, tm = _pair()
    signals, lengths, _ = _tone_batch(np.random.RandomState(5), 4)
    base = _np(tm(signals, lengths))
    poisoned = signals.copy()
    for i, n in enumerate(lengths):
        poisoned[i, n:] = 1e6
    np.testing.assert_allclose(_np(tm(poisoned, lengths)), base, rtol=0, atol=1e-9)


def test_loss_falls_over_a_few_adam_steps():
    rng = np.random.RandomState(7)
    _, tf = _frontends()
    tm = tkws.KWSModel(tf, num_classes=2, channels=CHANNELS)
    step = tkws.make_train_step(tm, torch.optim.Adam(tm.parameters(), lr=3e-3))
    batch = _tone_batch(rng, 16)
    losses = [float(step(*batch)["loss"]) for _ in range(8)]
    assert losses[-1] < 0.8 * losses[0], losses


def test_gabor_frontend_composes_and_matches_jax():
    kw = dict(frame_shift_ms=10, filter_size=65, pool_size=33)
    jf = jnn.GaborFrontend(JGabor("mel", num_filts=6, sampling_rate=RATE), dtype=jnp.float64, **kw)
    tf = tnn.GaborFrontend(TGabor("mel", num_filts=6, sampling_rate=RATE), dtype=torch.float64,
                           device="cpu", **kw)
    jm = jkws.KWSModel(jf, num_classes=2, channels=(8,), dtype=jnp.float64)
    tm = tkws.KWSModel(tf, num_classes=2, channels=(8,))
    params, consts = jm.init(jax.random.PRNGKey(0))
    params["classifier"]["head"]["w"] = jax.random.normal(
        jax.random.PRNGKey(2), params["classifier"]["head"]["w"].shape, dtype=jnp.float64)
    tmodels.params_from_jax(tm, params)
    signals, lengths, labels = _tone_batch(np.random.RandomState(6), 3, max_len=1600)
    want = jax.jit(jm.apply)(params, consts, signals, lengths)
    np.testing.assert_allclose(_np(tm(signals, lengths)), np.asarray(want), rtol=0, atol=TOL)
    loss, _ = tm.loss(signals, lengths, labels)
    loss.backward()
    assert all(np.isfinite(_np(p.grad)).all() for p in tm.parameters())


def test_npz_checkpoints_cross_packages(ref, tmp_path):
    """A ``save_params`` file of either package loads in the other, bit for
    bit, under the same ``"/"`` keys."""
    tm = _loaded(ref)
    from_jax = str(tmp_path / "jax.npz")
    jkws.save_params(from_jax, ref["params"])
    fresh = _loaded(ref)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tkws.load_params(from_jax, fresh)
    assert all(np.array_equal(a, _port_params(tm)[k]) for k, a in _port_params(fresh).items())
    from_port = str(tmp_path / "port.npz")
    tkws.save_params(from_port, tm)
    loaded = jkws.load_params(from_port)
    want = _flat(ref["params"])
    got = _flat(loaded)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # the nested dict form round-trips too
    back = tkws.load_params(from_port)
    assert all(np.array_equal(v, want[k]) for k, v in _flat(back).items())


def test_classifier_rejects_bad_config():
    with pytest.raises(ValueError):
        tkws.ConvClassifier(8, 1, device="cpu")
    with pytest.raises(ValueError):
        tkws.ConvClassifier(8, 2, channels=(8, 8), strides=(2,), device="cpu")
    with pytest.raises(ValueError):
        tkws.ConvClassifier(8, 2, kernel_width=0, device="cpu")
    with pytest.raises(ValueError, match="parameter keys"):
        tmodels.params_from_jax(tkws.ConvClassifier(8, 2, device="cpu"), {"head": {"w": 0}})


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkws.ConvClassifier(8, 2)


# --- streaming -----------------------------------------------------------------


def _stream_pair():
    return _pair(seed=2, head_seed=8)[3]


def test_streaming_kws_matches_batch_at_full_window():
    tm = _stream_pair()
    signals, lengths, _ = _tone_batch(np.random.RandomState(11), 1, max_len=3200)
    sig = signals[0][: lengths[0]]
    want = _np(tm(sig[None], [len(sig)]))[0]
    skws = tkws.StreamingKWS(tm, window_frames=200, chunk_size=800)
    state = skws.init_state()
    for start in range(0, len(sig), 800):
        chunk = np.zeros(800)
        piece = sig[start: start + 800]
        chunk[: len(piece)] = piece
        state, _ = skws.process(state, chunk, len(piece))
    np.testing.assert_allclose(_np(skws.finalize(state)), want, rtol=0, atol=TOL_STREAM)


def test_streaming_kws_mid_stream_window_consistent():
    """Each tick's logits == the classifier over the last-W emitted rows."""
    tm = _stream_pair()
    sig = _tone_batch(np.random.RandomState(12), 1, max_len=4000)[0][0]
    W = 12
    skws = tkws.StreamingKWS(tm, window_frames=W, chunk_size=640)
    state = skws.init_state()
    emitted = []
    for start in range(0, 3840, 640):
        before = state
        state, logits = skws.process(state, sig[start: start + 640])
        _, feats, n = skws._stream.process(before.stft, sig[start: start + 640])
        emitted.extend(_np(feats)[: int(n)])
        tail = np.asarray(emitted[-W:])
        window = np.zeros((W, skws.num_coeffs))
        window[: len(tail)] = tail
        want = _np(tm.classifier(window[None], [len(tail)]))[0]
        np.testing.assert_allclose(_np(logits), want, rtol=0, atol=TOL_STREAM)


def test_streaming_kws_stream_axis_matches_single_streams():
    """Sessions on the leading stream axis tick as the single-stream form
    does, and a 0-valid step leaves a state bitwise unchanged."""
    tm = _stream_pair()
    skws = tkws.StreamingKWS(tm, window_frames=30, chunk_size=400)
    rng = np.random.RandomState(13)
    chunks = rng.randn(3, 400)
    valids = torch.tensor([400, 250, 0])
    wide = skws.init_state(streams=3)
    wide, scores, n = skws._process_impl(wide, chunks, valids)
    assert n.tolist() == [1, 1, 0]
    for s in range(3):
        single, score, _ = skws._process_impl(skws.init_state(), chunks[s], int(valids[s]))
        np.testing.assert_allclose(_np(scores[s]), _np(score), rtol=0, atol=1e-12)
    fresh = skws.init_state()
    same, _, n0 = skws._process_impl(fresh, chunks[2], 0)
    assert int(n0) == 0
    assert all(torch.equal(a, b) for a, b in zip(_tree_leaves(fresh), _tree_leaves(same)))


def test_streaming_kws_validates_config():
    tm = _stream_pair()
    with pytest.raises(ValueError):
        tkws.StreamingKWS(tm, window_frames=0, chunk_size=800)
    gabor = tnn.GaborFrontend(TGabor("mel", num_filts=8, sampling_rate=RATE), frame_shift_ms=10,
                              filter_size=65, pool_size=33, dtype=torch.float64, device="cpu")
    model = tkws.KWSModel(gabor, num_classes=2, channels=(8,))
    with pytest.raises(ValueError, match="export_computer"):
        tkws.StreamingKWS(model, window_frames=10, chunk_size=800)


def test_streaming_kws_pools_in_streampool():
    """N concurrent KWS sessions tick through one call on the stream axis,
    and each session's close row equals the batch model (and the JAX
    model) on its full signal."""
    jm, params, consts, tm = _pair(seed=2, head_seed=8)
    skws = tkws.StreamingKWS(tm, window_frames=200, chunk_size=640)
    pool = StreamPool(skws, slots=4)
    rng = np.random.RandomState(31)
    sigs = [rng.randn(n) for n in (1920, 1280, 2560)]
    handles = [pool.open() for _ in sigs]
    for h, sig in zip(handles, sigs):
        pool.feed(h, sig[: len(sig) // 2])
    ticks = dict(pool.step(max_chunks=4))
    for h, sig in zip(handles, sigs):
        pool.feed(h, sig[len(sig) // 2:])
    closed = dict(pool.close_many(handles))
    for h, sig in zip(handles, sigs):
        want = _np(tm(sig[None], [len(sig)]))[0]
        jwant = np.asarray(jm.apply(params, consts, sig[None], jnp.asarray([len(sig)])))[0]
        rows = [r for r in (ticks.get(h), closed.get(h)) if r is not None]
        final = np.concatenate(rows, axis=0)[-1]
        np.testing.assert_allclose(final, want, rtol=0, atol=TOL_STREAM)
        np.testing.assert_allclose(final, jwant, rtol=0, atol=TOL_STREAM)
    assert all(r.shape[1] == tm.num_classes for r in ticks.values())


def test_streaming_kws_behind_stream_server():
    tm = _stream_pair()
    skws = tkws.StreamingKWS(tm, window_frames=200, chunk_size=640)
    rng = np.random.RandomState(77)
    sigs = [rng.randn(n) for n in (1920, 1280)]
    with StreamServer(skws, slots=4, tick_chunks=4) as server:
        handles = [server.open_session() for _ in sigs]

        def feeder(h, sig):
            for s in range(0, len(sig), 500):
                server.feed(h, sig[s: s + 500])

        threads = [threading.Thread(target=feeder, args=(h, sig)) for h, sig in zip(handles, sigs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for h, sig in zip(handles, sigs):
            server.close_session(h)
            rows = np.concatenate(list(server.iter_results(h)), axis=0)
            want = _np(tm(sig[None], [len(sig)]))[0]
            assert rows.shape[1] == tm.num_classes
            np.testing.assert_allclose(rows[-1], want, rtol=0, atol=TOL_STREAM)


# --- data parallelism ----------------------------------------------------------


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    return W.wait(*W.launch(2, str(tmp_path_factory.mktemp("kws_dp")), cases="models_train"))


def test_data_parallel_step_matches_unsharded_jax(dp_step):
    """World size 2 (gloo): each rank steps on its half of the batch with the
    gradients averaged over the group; the result equals the JAX step on
    the whole batch."""
    x = W.model_inputs()
    jf, _ = _frontends(num_filts=10)
    jm = jkws.KWSModel(jf, num_classes=3, channels=W.MODEL_CHANNELS)
    params = {}
    for key, v in dp_step.items():
        if key.startswith("before/"):
            node = params
            *parents, leaf = key[len("before/"):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
    _, consts = jm.init(jax.random.PRNGKey(0))
    tx = optax.sgd(W.MODEL_LR)
    step = jkws.make_train_step(jm, consts, tx)
    new, _, metrics = step(params, tx.init(params), x["signals"], jnp.asarray(x["lengths"]),
                           jnp.asarray(x["labels"]))
    np.testing.assert_allclose(dp_step["metric/loss"], float(metrics["loss"]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(dp_step["metric/accuracy"], float(metrics["accuracy"]), atol=1e-12)
    for key, want in _flat(new).items():
        np.testing.assert_allclose(dp_step[f"after/{key}"], want, rtol=0, atol=1e-12, err_msg=key)
