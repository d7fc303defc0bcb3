"""speech_tpu_torch.ops.framing against speech_tpu.ops.framing, float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_tpu.ops import framing as JF
from speech_tpu_torch.ops import framing as TF

# (frame_style, kaldi_shift, frame_length, frame_shift)
STYLES = [
    ("causal", False, 400, 160),
    ("centered", False, 400, 160),
    ("centered", True, 400, 160),
    ("centered", False, 405, 135),
    ("centered", True, 25, 40),  # shift longer than the frame
]
STYLE_IDS = ["causal", "centered", "kaldi", "odd", "sparse"]


@pytest.mark.parametrize("style,kaldi,fl,fs", STYLES, ids=STYLE_IDS)
def test_left_pad_and_frame_count(style, kaldi, fl, fs):
    assert TF.left_pad_width(style, fl, fs, kaldi) == JF.left_pad_width(
        style, fl, fs, kaldi
    )
    lengths = np.array([0, 1, fl // 2, fl // 2 + 1, fl - 1, fl, 2 * fl + 3, 5000])
    for n in lengths:
        assert TF.frame_count_np(int(n), fl, fs) == JF.frame_count_np(int(n), fl, fs)
    want = np.asarray(JF.frame_count(jnp.asarray(lengths), fl, fs))
    got = TF.frame_count(torch.tensor(lengths), fl, fs)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_reflect_index_any_depth():
    pos = np.arange(-40, 60)
    for length in (1, 3, 7):
        want = np.asarray(JF.reflect_index(jnp.asarray(pos), length))
        got = TF.reflect_index(torch.tensor(pos), length)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("style,kaldi,fl,fs", STYLES, ids=STYLE_IDS)
def test_pad_signal_full_and_frames(style, kaldi, fl, fs):
    rng = np.random.RandomState(5)
    sigs = rng.randn(3, 1200)
    pad_left = JF.left_pad_width(style, fl, fs, kaldi)
    mf = JF.frame_count_np(1200, fl, fs)
    for min_len in (0, 2500):
        want = np.stack(
            [np.asarray(JF.pad_signal_full(jnp.asarray(s), fl, pad_left, min_len)) for s in sigs]
        )
        got = TF.pad_signal_full(torch.tensor(sigs), fl, pad_left, min_len)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want)
        want_frames = np.asarray(
            jax.vmap(lambda p: JF.frame_padded(p, mf, fl, fs))(jnp.asarray(want))
        )
        got_frames = TF.frame_padded(got, mf, fl, fs)
        assert got_frames.shape == want_frames.shape
        assert np.array_equal(got_frames.numpy(), want_frames)


@pytest.mark.parametrize("style,kaldi,fl,fs", STYLES, ids=STYLE_IDS)
def test_pad_signal_ragged(style, kaldi, fl, fs):
    """Per-row lengths, including signals shorter than a frame and an
    empty row: equal to the JAX padding everywhere the frames read."""
    rng = np.random.RandomState(6)
    buf = 1000
    sigs = rng.randn(6, buf)
    lengths = np.array([buf, 999, fl // 2 + 1, fl - 7, 3, 0])
    pad_left = JF.left_pad_width(style, fl, fs, kaldi)
    want = np.asarray(
        jax.vmap(lambda s, n: JF.pad_signal(s, n, fl, fs, pad_left))(
            jnp.asarray(sigs), jnp.asarray(lengths)
        )
    )
    got = TF.pad_signal(torch.tensor(sigs), torch.tensor(lengths), fl, fs, pad_left)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # one row with a scalar length, as compute_full pads it
    one = TF.pad_signal(torch.tensor(sigs[2]), int(lengths[2]), fl, fs, pad_left)
    assert np.array_equal(one.numpy(), want[2])
    mf = JF.frame_count_np(buf, fl, fs)
    want_frames = np.asarray(
        jax.vmap(lambda p: JF.frame_padded(p, mf, fl, fs))(jnp.asarray(want))
    )
    assert np.array_equal(TF.frame_padded(got, mf, fl, fs).numpy(), want_frames)


def test_frame_padded_short_buffer_pads_with_zeros():
    x = np.arange(10.0)
    want = np.asarray(JF.frame_padded(jnp.asarray(x), 4, 5, 3))
    got = TF.frame_padded(torch.tensor(x), 4, 5, 3)
    assert np.array_equal(got.numpy(), want)
    assert TF.frame_padded(torch.tensor(x), 0, 5, 3).shape == (0, 5)
