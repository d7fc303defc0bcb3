"""speech_tpu_torch.ops.postops against speech_tpu.ops.postops in float64,
including the ragged ``lengths=`` forms and the device post chain."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speech_tpu.post as jpost
from speech_tpu.ops import postops as J

import speech_tpu_torch.post as tpost
from speech_tpu_torch.ops import postops as T

# float64 throughout; sums are taken in other orders (the PCEN prefix scan
# in log depth, reductions over several axes), so allow a few roundings
TOL = 1e-10
LENGTHS = [37, 20, 1]


def _feats(shape=(3, 37, 5), seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape)
    return np.abs(x) + 0.1 if positive else x


def _check(got, want, lengths=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if lengths is None:
        assert np.abs(got - want).max() <= TOL
        return
    for row, n in enumerate(lengths):  # rows past a row's count are garbage
        assert np.abs(got[row, :n] - want[row, :n]).max(initial=0.0) <= TOL, row


def test_delta_filters_equal():
    for order, width in ((1, 2), (2, 2), (3, 1)):
        for a, b in zip(J.delta_filters(order, width), T.delta_filters(order, width)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("concatenate", [True, False])
def test_deltas(concatenate, ragged):
    x = _feats()
    filts = J.delta_filters(2)
    lens = LENGTHS if ragged else None
    want = J.deltas(jnp.asarray(x), filts, concatenate, lengths=lens)
    got = T.deltas(torch.tensor(x), filts, concatenate, lengths=lens)
    _check(got, want, lens)


def test_deltas_time_axis_0():
    x = _feats((37, 5))
    filts = J.delta_filters(1, 3)
    _check(T.deltas(torch.tensor(x), filts, time_axis=0), J.deltas(jnp.asarray(x), filts, time_axis=0))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("num_vectors", [1, 3, 4])
def test_stack(num_vectors, pad, ragged):
    x = _feats()
    lens = LENGTHS if ragged else None
    want = J.stack(jnp.asarray(x), num_vectors, pad=pad, lengths=lens)
    got = T.stack(torch.tensor(x), num_vectors, pad=pad, lengths=lens)
    counts = None
    if ragged:
        counts = [-(-n // num_vectors) if pad else n // num_vectors for n in lens]
    _check(got, want, counts)


def test_stack_axes():
    x = _feats((5, 37))
    want = J.stack(jnp.asarray(x), 3, time_axis=1, feat_axis=0, pad=True)
    _check(T.stack(torch.tensor(x), 3, time_axis=1, feat_axis=0, pad=True), want)
    with pytest.raises(RuntimeError):
        T.stack(torch.tensor(x), 3, time_axis=0, feat_axis=0)


@pytest.mark.parametrize("norm_var", [True, False])
@pytest.mark.parametrize("feat_axis", [-1, 1])
def test_standardize(norm_var, feat_axis):
    x = _feats()
    x[..., 2] = 4.0  # a zero-variance coefficient scales by 1
    want = J.standardize(jnp.asarray(x), norm_var, feat_axis)
    _check(T.standardize(torch.tensor(x), norm_var, feat_axis), want)


@pytest.mark.parametrize("norm_var", [True, False])
def test_standardize_with_stats(norm_var):
    x = _feats()
    flat = x.reshape(-1, 5)
    stats = np.zeros((2, 6))
    stats[0, :-1] = flat.sum(0)
    stats[1, :-1] = (flat ** 2).sum(0)
    stats[0, -1] = len(flat)
    want = J.standardize_with_stats(jnp.asarray(x), stats, norm_var)
    _check(T.standardize_with_stats(torch.tensor(x), stats, norm_var), want)


@pytest.mark.parametrize("num_ceps,lifter", [(None, 0.0), (13, 22.0), (1, 0.0)])
def test_dct(num_ceps, lifter):
    x = _feats((2, 9, 23))
    assert np.array_equal(J.dct_matrix(23, num_ceps, lifter), T.dct_matrix(23, num_ceps, lifter))
    want = J.dct(jnp.asarray(x), num_ceps, lifter)
    _check(T.dct(torch.tensor(x), num_ceps, lifter), want)
    want0 = J.dct(jnp.asarray(x.swapaxes(1, 2)), num_ceps, lifter, feat_axis=1)
    _check(T.dct(torch.tensor(x.swapaxes(1, 2)), num_ceps, lifter, feat_axis=1), want0)
    with pytest.raises(ValueError):
        T.dct_matrix(5, 6)


@pytest.mark.parametrize("affine", [False, True])
def test_transform(affine):
    x = _feats()
    mat = np.random.RandomState(9).randn(4, 5 + int(affine))
    _check(T.transform(torch.tensor(x), mat), J.transform(jnp.asarray(x), mat))
    with pytest.raises(ValueError):
        T.transform(torch.tensor(x), np.ones((4, 7)))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize(
    "params",
    [
        {},
        {"smooth": 0.3, "alpha": np.linspace(0.5, 1.0, 5), "delta": 1.5, "power": 0.25},
    ],
)
def test_pcen(params, ragged):
    x = _feats(positive=True)
    lens = LENGTHS if ragged else None
    want = J.pcen(jnp.asarray(x), lengths=lens, **params)
    _check(T.pcen(torch.tensor(x), lengths=lens, **params), want, lens)


def test_pcen_streams_with_state():
    x = _feats((2, 40, 5), positive=True)
    whole = T.pcen(torch.tensor(x))
    first, state = T.pcen(torch.tensor(x[:, :17]), return_state=True)
    second = T.pcen(torch.tensor(x[:, 17:]), init_state=state)
    _check(torch.cat([first, second], dim=1), whole.numpy())
    jstate = J.pcen(jnp.asarray(x[:, :17]), return_state=True)[1]
    _check(state, jstate)
    xt = x.swapaxes(0, 1)  # time on axis 0
    _check(T.pcen(torch.tensor(xt), time_axis=0), J.pcen(jnp.asarray(xt), time_axis=0))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("center,norm_var", [(True, False), (True, True), (False, True)])
def test_sliding_cmvn(center, norm_var, ragged):
    x = _feats()
    lens = LENGTHS if ragged else None
    kw = dict(window=9, center=center, norm_var=norm_var, min_window=4)
    want = J.sliding_cmvn(jnp.asarray(x), lengths=lens, **kw)
    _check(T.sliding_cmvn(torch.tensor(x), lengths=lens, **kw), want, lens)


def test_sliding_cmvn_time_axis_0():
    x = _feats((37, 2, 5))
    kw = dict(window=6, center=False, norm_var=True, min_window=3, time_axis=0)
    _check(T.sliding_cmvn(torch.tensor(x), **kw), J.sliding_cmvn(jnp.asarray(x), **kw))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("left,right", [(4, 4), (0, 2), (3, 0)])
def test_splice(left, right, ragged):
    x = _feats()
    lens = LENGTHS if ragged else None
    want = J.splice(jnp.asarray(x), left, right, lengths=lens)
    _check(T.splice(torch.tensor(x), left, right, lengths=lens), want, lens)


def _chains():
    stats = np.zeros((2, 6))
    stats[0, :-1], stats[1, :-1], stats[0, -1] = 3.0, 20.0, 5.0
    mat = np.random.RandomState(3).randn(7, 6)  # affine

    def build(post):
        return [
            post.Deltas(2),
            post.Stack(2, pad_mode="edge"),
            post.SlidingCMVN(window=7, norm_var=True, min_window=3),
            post.Splice(1, 1),
            post.DCT(num_ceps=20),
            post.Stack(3),
        ], [
            post.PCEN(smooth=0.2),
            post.Standardize.from_stats(stats),
            post.Transform(matrix=mat),
        ]

    return build(jpost), build(tpost)


def test_device_post_chain_matches_jax():
    x = _feats((3, 37, 5))
    pos = _feats((3, 37, 5), positive=True)
    (jchain, jlin), (tchain, tlin) = _chains()
    for data, jc, tc in ((x, jchain, tchain), (pos, jlin, tlin)):
        jf, jn = J.device_post_chain(jc)(jnp.asarray(data), np.asarray(LENGTHS))
        tf, tn = T.device_post_chain(tc)(torch.tensor(data), LENGTHS)
        assert tn.tolist() == np.asarray(jn).tolist()
        _check(tf, jf, tn.tolist())


def test_device_post_chain_refusals():
    with pytest.raises(ValueError):
        T.device_post_chain([tpost.Standardize()])
    with pytest.raises(ValueError):
        T.device_post_chain([tpost.Deltas(1, concatenate=False)])
    doubled = T.device_post_chain([lambda f, n: (2 * f, n)])
    out, n = doubled(torch.ones(1, 2, 3), [2])
    assert out.eq(2).all() and n.tolist() == [2]
