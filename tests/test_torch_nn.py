"""speech_tpu_torch.nn against speech_tpu.nn, on the CPU in float64.

Each frontend of the port is loaded with the JAX frontend's parameters
(``params_from_jax``) and run on the same numpy inputs: forwards within
1e-10, gradients of a scalar loss within rtol 1e-8, one SGD step against
optax's within 1e-10.  Also: initial parameters equal to the JAX ``init()``
bit for bit (float32), checkpoints across packages, ``export_computer``,
XLA's ``"SAME"`` padding at an even tap count, and the frontend cases of
``tests/test_parallel.py`` -- among them the data x filter sharded train
step, run as one launch each at world sizes 2 and 4 of
``tests/torch_dist_worker.py`` (gloo) against the unsharded JAX step.
"""

import functools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import speech_tpu
from speech_tpu import nn as jnn
from speech_tpu.filters import GaborFilterBank as JGabor

import speech_tpu_torch
from speech_tpu_torch import nn as tnn
from speech_tpu_torch.filters import GaborFilterBank as TGabor

import torch_dist_worker as W

TOL = 1e-10
RTOL_GRAD = 1e-8
LR = 1e-2
RATE = 8000


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _signals(batch=3, n=1600, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, n)
    lengths = np.full(batch, n)
    lengths[1:] = (n * 5 // 8, n * 3 // 4)[: batch - 1]
    for i, k in enumerate(lengths):
        x[i, k:] = 0.0  # zero-padded rows: all-zero frames reach sqrt(0)
    return x, lengths


# --- the frontends of both packages, paired ---------------------------------

STFT_VARIANTS = {
    "log-mag": dict(),
    "energy-log-mag": dict(include_energy=True),
    "energy-power-linear": dict(include_energy=True, use_power=True, use_log=False),
    "causal": dict(frame_style="causal", include_energy=True),
}


def _stft_pair(dtype="float64", **kw):
    jc = W.stft_computer(speech_tpu, dtype=dtype, **kw)
    tc = W.stft_computer(speech_tpu_torch, dtype=dtype, **kw)
    jf = jnn.STFTFrontend(jc, dtype=jnp.dtype(dtype))
    tf = tnn.STFTFrontend(tc, dtype=dtype)
    return jf, tf


def _gabor_pair(filter_size=None, use_log=True, dtype="float64"):
    kw = dict(frame_shift_ms=10, filter_size=filter_size, use_log=use_log)
    jf = jnn.GaborFrontend(JGabor("mel", num_filts=6, sampling_rate=RATE),
                           dtype=jnp.dtype(dtype), **kw)
    tf = tnn.GaborFrontend(TGabor("mel", num_filts=6, sampling_rate=RATE), dtype=dtype,
                           device="cpu", **kw)
    return jf, tf


def _sinc_pair(filter_size=None, pooling="avg", dtype="float64"):
    kw = dict(num_filts=6, sampling_rate=RATE, filter_size=filter_size, pooling=pooling)
    return (jnn.SincFrontend(dtype=jnp.dtype(dtype), **kw),
            tnn.SincFrontend(dtype=dtype, device="cpu", **kw))


def _pcen_pair(learn_smooth=False, dtype="float64"):
    return (jnn.PCEN(6, learn_smooth=learn_smooth, dtype=jnp.dtype(dtype)),
            tnn.PCEN(6, learn_smooth=learn_smooth, dtype=dtype, device="cpu"))


def _perturbed(params, scale=0.05, seed=3):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v) * (1 + scale * rng.randn(*np.shape(v))) for k, v in params.items()}


def _jax_init(jf):
    out = jf.init()
    return (out, {}) if isinstance(jf, jnn.PCEN) else out


def _jax_apply(jf, params, consts, x, lengths=None):
    """The JAX frontend's apply, jitted (op by op, its pooling's slices
    take seconds to dispatch)."""
    if isinstance(jf, jnn.PCEN):
        fn = lambda p, c, x, n: jf.apply(p, x)
    elif isinstance(jf, jnn.STFTFrontend):
        fn = jf.apply
    else:
        fn = lambda p, c, x, n: jf.apply(p, c, x)
    return jax.jit(fn)(params, consts, x, lengths)


def _port_apply(tf, x, lengths=None):
    if isinstance(tf, tnn.PCEN):
        return tf(x)
    if isinstance(tf, tnn.STFTFrontend):
        return tf(x, lengths)
    return tf(x)


def _input(jf):
    if isinstance(jf, jnn.PCEN):
        return np.abs(np.random.RandomState(5).randn(3, 40, 6)) + 0.1, None
    return _signals()


PAIRS = {
    **{f"stft-{k}": (lambda dtype="float64", kw=kw: _stft_pair(dtype, **kw))
       for k, kw in STFT_VARIANTS.items()},
    "gabor-odd": lambda dtype="float64": _gabor_pair(81, dtype=dtype),
    "gabor-odd-narrow-linear": lambda dtype="float64": _gabor_pair(41, False, dtype),
    "gabor-default-width": lambda dtype="float64": _gabor_pair(dtype=dtype),
    "sinc-avg": lambda dtype="float64": _sinc_pair(dtype=dtype),
    "sinc-max": lambda dtype="float64": _sinc_pair(pooling="max", dtype=dtype),
    "sinc-odd-narrow-max": lambda dtype="float64": _sinc_pair(31, "max", dtype),
    "pcen": lambda dtype="float64": _pcen_pair(dtype=dtype),
    "pcen-learn-smooth": lambda dtype="float64": _pcen_pair(True, dtype),
}
# the default Gabor width (641 taps at 8 kHz) is held at init only: XLA's
# float64 convolution at that width takes seconds on the CPU
RUN = sorted(k for k in PAIRS if k != "gabor-default-width")


def _loaded_pair(name, perturb=True):
    """A pair with the JAX frontend's (perturbed) parameters in both."""
    jf, tf = PAIRS[name]()
    params, consts = _jax_init(jf)
    if perturb:
        params = {k: jnp.asarray(v) for k, v in _perturbed(params).items()}
    tnn.params_from_jax(tf, {k: np.asarray(v) for k, v in params.items()})
    return jf, tf, params, consts


def _loss_jax(jf, consts, x, lengths):
    return lambda p: jnp.mean(_jax_apply(jf, p, consts, x, lengths) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """The JAX gradients of the mean squared features at the loaded
    parameters (computed once: the gradient program compiles for
    seconds)."""
    jf, _, params, consts = _loaded_pair(name)
    x, lengths = _input(jf)
    return jax.jit(jax.grad(_loss_jax(jf, consts, x, lengths)))(params)


@pytest.mark.parametrize("name", RUN)
def test_forward_matches_jax(name):
    jf, tf, params, consts = _loaded_pair(name)
    x, lengths = _input(jf)
    want = np.asarray(_jax_apply(jf, params, consts, x, lengths))
    got = _np(_port_apply(tf, x, lengths))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", RUN)
def test_gradients_match_jax(name):
    jf, tf, params, consts = _loaded_pair(name)
    x, lengths = _input(jf)
    want = _jax_grads(name)
    (_port_apply(tf, x, lengths) ** 2).mean().backward()
    for key, g in want.items():
        got = _np(getattr(tf, key).grad)
        assert np.all(np.isfinite(got)), key
        scale = np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(got, np.asarray(g), rtol=RTOL_GRAD, atol=RTOL_GRAD * scale,
                                   err_msg=key)


@pytest.mark.parametrize("name", RUN)
def test_sgd_step_matches_optax(name):
    jf, tf, params, consts = _loaded_pair(name)
    x, lengths = _input(jf)
    tx = optax.sgd(LR)
    grads = _jax_grads(name)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    opt = torch.optim.SGD(tf.parameters(), lr=LR)
    opt.zero_grad()
    (_port_apply(tf, x, lengths) ** 2).mean().backward()
    opt.step()
    for key, v in want.items():
        np.testing.assert_allclose(_np(getattr(tf, key)), np.asarray(v), rtol=0, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_init_bitwise_float32(name):
    """Initial parameters and buffers equal the JAX init(), bit for bit."""
    jf, tf = PAIRS[name]("float32")
    params, consts = _jax_init(jf)
    own = dict(tf.named_parameters())
    assert set(own) == set(params)
    for key, v in {**params, **consts}.items():
        mine = own[key] if key in own else getattr(tf, key)
        assert mine.dtype == torch.float32
        assert np.array_equal(_np(mine), np.asarray(v)), key


@pytest.mark.parametrize("name", ["stft-energy-log-mag", "gabor-odd", "sinc-max", "pcen-learn-smooth"])
def test_checkpoints_across_packages(name, tmp_path):
    jf, tf, params, _ = _loaded_pair(name)
    # the port's checkpoint, read by both packages
    path = str(tmp_path / "port.npz")
    tf.save_params(path)
    fresh = PAIRS[name]()[1]
    loaded = fresh.load_params(path)
    assert set(loaded) == set(params)
    if isinstance(jf, jnn.PCEN):
        with np.load(path) as data:  # jnn.PCEN has no load_params
            from_port = {k: data[k] for k in data.files}
    else:
        from_port = jf.load_params(path)
    for key, v in params.items():
        assert np.array_equal(_np(loaded[key]), np.asarray(v)), key
        assert np.array_equal(np.asarray(from_port[key]), np.asarray(v)), key
    # the JAX package's checkpoint, read by the port
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{k: np.asarray(v) for k, v in params.items()})
    fresh = PAIRS[name]()[1]
    for key, v in fresh.load_params(jpath).items():
        assert np.array_equal(_np(v), np.asarray(params[key])), key


def test_params_from_jax_validates_keys_and_shapes():
    _, tf = _stft_pair()
    with pytest.raises(ValueError, match="keys"):
        tnn.params_from_jax(tf, {"window": np.zeros(200)})
    with pytest.raises(ValueError, match="shape"):
        tnn.params_from_jax(tf, {"window": np.zeros(7), "weights": _np(tf.weights)})


# --- "SAME" padding, odd and even widths ------------------------------------


@pytest.mark.parametrize("width", [4, 5, 8, 31])
def test_same_conv_matches_xla(width):
    """XLA's "SAME" puts (W - 1) // 2 zeros before the signal, the rest
    after: at an even width the split is uneven."""
    rng = np.random.RandomState(width)
    x = rng.randn(2, 1, 50)
    taps = rng.randn(3, 1, width)
    want = jax.lax.conv_general_dilated(x, taps, (1,), "SAME",
                                        precision=jax.lax.Precision.HIGHEST)
    got = tnn._same_conv(torch.tensor(x), torch.tensor(taps))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["gabor", "sinc"])
def test_even_widths_rejected_by_both(kind):
    make = {"gabor": lambda pkg, fs, **kw: (
        pkg[0].GaborFrontend(pkg[1]("mel", num_filts=4, sampling_rate=RATE), filter_size=fs, **kw)),
            "sinc": lambda pkg, fs, **kw: pkg[0].SincFrontend(4, RATE, filter_size=fs, **kw)}[kind]
    with pytest.raises(ValueError, match="odd"):
        make((jnn, JGabor), 40)
    with pytest.raises(ValueError, match="odd"):
        make((tnn, TGabor), 40, device="cpu")


# --- export_computer --------------------------------------------------------


def _exported_pair(**kw):
    jf, tf = _stft_pair(**kw)
    params, _ = jf.init()
    # in the frontend's dtype, so that both packages export the same values
    trained = {k: jnp.asarray(v, params[k].dtype) for k, v in _perturbed(params).items()}
    tnn.params_from_jax(tf, {k: np.asarray(v) for k, v in trained.items()})
    return jf, tf, trained


def test_export_computer_matches_jax():
    jf, tf, trained = _exported_pair(include_energy=True)
    want = jf.export_computer(trained)
    got = tf.export_computer()
    sig = np.random.RandomState(8).randn(4000)
    np.testing.assert_allclose(got.compute_full(sig), want.compute_full(sig), rtol=0, atol=TOL)
    # and the trained frontend itself
    np.testing.assert_allclose(got.compute_full(sig), _np(tf(sig[None]))[0], rtol=0, atol=1e-8)


def test_export_rederives_digits_at_double():
    """At 'double' the exported computer's digit planes are derived from the
    trained weights: equal to the JAX exported computer's, unequal to the
    original's."""
    jf, tf, trained = _exported_pair(dtype="float32", precision="double")
    original = tf._computer
    before = {k: v.clone() for k, v in original.params.items() if isinstance(v, torch.Tensor)}
    got = tf.export_computer().params
    want = jf.export_computer(trained).params
    for key in ("i8k_gmats", "i8k_w_hi", "dft_group_mats", "weights"):
        assert np.array_equal(_np(got[key]), np.asarray(want[key], dtype=_np(got[key]).dtype)), key
    assert not torch.equal(got["i8k_w_hi"], before["i8k_w_hi"])
    assert got["i8k_offsets"] == tuple(
        (int(s), tuple(int(i) for i in xs), int(o), int(n)) for s, xs, o, n in want["i8k_offsets"])
    for key, v in before.items():
        assert torch.equal(original.params[key], v), key


def test_export_leaves_original_untouched():
    jf, tf, trained = _exported_pair()
    computer = tf._computer
    sig = np.random.RandomState(9).randn(2000)
    before = computer.compute_full(sig)
    cached = computer._params
    out = tf.export_computer()
    assert computer._params is cached and out is not computer
    assert out._params is None
    np.testing.assert_array_equal(computer.compute_full(sig), before)


def test_export_validates_shapes():
    _, tf = _stft_pair()
    with pytest.raises(ValueError, match="window"):
        tf.export_computer({"window": np.zeros(7), "weights": _np(tf.weights)})
    with pytest.raises(ValueError, match="weights"):
        tf.export_computer({"window": _np(tf.window), "weights": np.zeros((3, 3))})


# --- PCEN, FeatureFrontend --------------------------------------------------


@pytest.mark.parametrize("learn_smooth", [False, True])
def test_pcen_streams_with_state(learn_smooth):
    jf, tf = _pcen_pair(learn_smooth=learn_smooth)
    params = jf.init()
    feats = np.abs(np.random.RandomState(6).randn(2, 30, 6)) + 0.1
    want, want_state = jf.apply(params, feats[:, :13], return_state=True)
    want2 = jf.apply(params, feats[:, 13:], init_state=want_state)
    got, state = tf(feats[:, :13], return_state=True)
    got2 = tf(feats[:, 13:], init_state=state)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(got2), np.asarray(want2), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(torch.cat([got, got2], 1)), _np(tf(feats)), rtol=0, atol=1e-12)


def test_pcen_rejects_degenerate_smooth():
    for module in (jnn, tnn):
        with pytest.raises(ValueError, match="learn_smooth"):
            module.PCEN(4, smooth=1.0, learn_smooth=True)
        with pytest.raises(ValueError):
            module.PCEN(4, smooth=0.0)


@pytest.mark.parametrize("stats", [False, True])
def test_feature_frontend_matches_jax(stats):
    rng = np.random.RandomState(7)
    mean, std = (rng.randn(5), np.abs(rng.randn(5)) + 0.5) if stats else (None, None)
    feats = rng.randn(3, 11, 5)
    lengths = np.array([11, 4, 7])
    jf = jnn.FeatureFrontend(5, mean=mean, std=std, dtype=jnp.float64)
    tf = tnn.FeatureFrontend(5, mean=mean, std=std, dtype=torch.float64, device="cpu")
    params, consts = jf.init()
    assert params == {} and not list(tf.parameters())
    want = np.asarray(jf.apply(params, consts, feats, lengths))
    np.testing.assert_allclose(_np(tf(feats, lengths)), want, rtol=0, atol=TOL)
    assert np.array_equal(_np(tf.frame_counts(lengths)), np.asarray(jf.frame_counts(lengths)))
    with pytest.raises(ValueError):
        tnn.FeatureFrontend(5, mean=np.zeros(4), device="cpu")


@pytest.mark.parametrize("kind", ["stft", "gabor", "sinc"])
def test_frame_counts_match_jax(kind):
    jf, tf = {"stft": _stft_pair, "gabor": _gabor_pair, "sinc": _sinc_pair}[kind]()
    lengths = np.array([0, 1, 99, 100, 1600, 1639])
    assert np.array_equal(_np(tf.frame_counts(lengths)), np.asarray(jf.frame_counts(lengths)))


# --- the frontend cases of tests/test_parallel.py ---------------------------


def test_frontend_matches_computer():
    computer = W.stft_computer(speech_tpu_torch)
    frontend = tnn.STFTFrontend(computer, dtype=torch.float64)
    rng = np.random.RandomState(9)
    signals = rng.randn(4, 3200)
    lengths = np.array([3200, 3000, 2500, 3200])
    feats = _np(frontend(signals, lengths))
    counts = _np(frontend.frame_counts(lengths))
    for i in range(4):
        want = computer.compute_full(signals[i, : lengths[i]])
        assert counts[i] == want.shape[0]
        np.testing.assert_allclose(feats[i, : counts[i]], want, rtol=0, atol=1e-8)


def test_frontend_f32_gradients_track_f64():
    signals = np.random.RandomState(12).randn(2, 1600)
    grads = {}
    for dtype in ("float32", "float64"):
        frontend = tnn.STFTFrontend(W.stft_computer(speech_tpu_torch), dtype=dtype)
        (frontend(signals) ** 2).mean().backward()
        grads[dtype] = {k: _np(p.grad).astype(np.float64) for k, p in frontend.named_parameters()}
    for key, g64 in grads["float64"].items():
        assert np.abs(g64).max() > 0
        scale = np.abs(g64).max()
        assert np.abs(grads["float32"][key] - g64).max() < 1e-3 * scale, key


def test_frontend_training_converges():
    """A few Adam steps on the learnable frontend reduce a feature-matching
    loss (the trainable frontend end to end)."""
    frontend = tnn.STFTFrontend(W.stft_computer(speech_tpu_torch), dtype=torch.float64)
    signals = torch.tensor(np.random.RandomState(14).randn(4, 1600))
    with torch.no_grad():
        target = tnn.STFTFrontend(W.stft_computer(speech_tpu_torch), dtype=torch.float64)
        target.window.mul_(1.05)
        target.weights.mul_(0.9)
        targets = target(signals)
    opt = torch.optim.Adam(frontend.parameters(), lr=1e-4)
    losses = []
    for _ in range(50):
        opt.zero_grad()
        loss = ((frontend(signals) - targets) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def test_frontend_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tnn.PCEN(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnn.STFTFrontend({"name": "stft", "bank": dict(W.STFT_CFG[0])})


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_train"))
    launches = {w: W.launch(w, tmp, cases="train") for w in (2, 4)}
    return {w: W.wait(*launches[w]) for w in launches}


@pytest.mark.parametrize("world", [2, 4])
def test_frontend_sharded_train_step(sharded_steps, world):
    """A data x filter sharded SGD step (the filter columns of ``weights``
    split over 'filt', the batch over 'data') equals the unsharded JAX
    step."""
    jf = jnn.STFTFrontend(W.stft_computer(speech_tpu), dtype=jnp.float64)
    params, consts = jf.init()
    signals = jnp.asarray(W.inputs()["train"])
    loss, grads = jax.value_and_grad(lambda p: jnp.mean(jf.apply(p, consts, signals) ** 2))(params)
    got = sharded_steps[world]
    np.testing.assert_allclose(got["train_loss"], float(loss), rtol=1e-12, atol=0)
    for key in ("window", "weights"):
        want = np.asarray(params[key] - W.TRAIN_LR * grads[key])
        np.testing.assert_allclose(got[f"train_{key}"], want, rtol=0, atol=TOL, err_msg=key)
