"""speech_tpu_torch's polyphase resampler (ops/resample.py) against
speech_tpu's on the same inputs (float64 on the CPU)."""

import numpy as np
import pytest
import torch

from speech_tpu.ops import resample as JR

from speech_tpu_torch.ops import resample as TR

RATIOS = [(2, 1), (1, 2), (3, 2), (2, 3), (441, 160), (16, 7), (4, 4), (1, 4)]
TOL = 1e-12  # float64 roundoff (tests/test_resample.py:29,136)


@pytest.fixture
def signal():
    return np.random.RandomState(5).randn(4800)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("up,down", [(3, 2), (1, 2), (441, 160), (1, 1), (2, 5), (1, 160)])
def test_host_builders_bit_equal(up, down):
    for hw, beta in ((10, 5.0), (4, 8.0)):
        phi_t, k_t = TR.resample_matrices(up, down, hw, beta)
        phi_j, k_j = JR.resample_matrices(up, down, hw, beta)
        assert k_t == k_j and np.array_equal(phi_t, phi_j)
    h = tuple(np.random.RandomState(up + down).randn(2 * 17).tolist())
    for P, stride, G, D in ((1, 1, 128, 2), (2, 3, 64, 3), (1, 160, 4, 2)):
        assert np.array_equal(
            TR._toeplitz_block(h, P, stride, G, D), JR._toeplitz_block(h, P, stride, G, D)
        )


@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_matches_jax(signal, up, down):
    want = np.asarray(JR.resample(signal, up, down))
    got = TR.resample(signal, up, down, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.allclose(_np(got), want, atol=TOL), np.abs(_np(got) - want).max()
    np.testing.assert_allclose(
        TR.resample_np(signal, up, down), JR.resample_np(signal, up, down), rtol=0, atol=0
    )


def test_resample_batched_tensor_stays_on_its_device(signal):
    batch = np.stack([signal, signal[::-1], 0 * signal]).reshape(3, 1, -1)
    got = TR.resample(torch.tensor(batch), 3, 2)
    assert got.device.type == "cpu" and got.shape == (3, 1, 7200)
    for i in range(3):
        want = np.asarray(JR.resample(batch[i, 0], 3, 2))
        assert np.allclose(_np(got[i, 0]), want, atol=TOL)


def test_resample_float32_close_to_float64(signal):
    f64 = np.asarray(JR.resample(signal, 2, 3))
    f32 = TR.resample(signal.astype(np.float32), 2, 3, device="cpu")
    assert f32.dtype == torch.float32
    assert np.abs(_np(f32) - f64).max() < 1e-5
    # every precision name of the reference is taken; on the CPU each is
    # IEEE float32
    for precision in ("highest", "high", "default", "HIGHEST"):
        again = TR.resample(signal.astype(np.float32), 2, 3, precision=precision,
                            device="cpu")
        assert torch.equal(again, f32)
    with pytest.raises(ValueError, match="precision"):
        TR.resample(signal, 2, 3, precision="fastest", device="cpu")


def test_resample_int16_upcasts(signal):
    pcm = (signal * 1000).astype(np.int16)
    out = TR.resample(pcm, 2, 1, device="cpu")
    assert out.dtype == torch.float32
    want = TR.resample(pcm.astype(np.float32), 2, 1, device="cpu")
    assert torch.equal(out, want)
    # float32 sums in another order than XLA's
    assert np.allclose(_np(out), np.asarray(JR.resample(pcm, 2, 1)), rtol=1e-6, atol=1e-4)


def test_resample_identity_and_validation():
    x = np.random.RandomState(6).randn(100).astype(np.float32)
    assert np.array_equal(_np(TR.resample(x, 7, 7, device="cpu")), x)
    for up, down in ((0, 2), (2, 0), (-1, 2)):
        with pytest.raises(ValueError, match="positive"):
            TR.resample(x, up, down, device="cpu")
        with pytest.raises(ValueError, match="positive"):
            TR.resample_np(x, up, down)


def test_numpy_input_without_device_needs_gpu(signal, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.resample(signal, 3, 2)


@pytest.mark.parametrize("stride,width", [(1, 65), (4, 81), (4, 7), (3, 1), (1, 4000)])
def test_fir_conv_matmul_matches_jax(stride, width):
    rng = np.random.RandomState(width * 7 + stride)
    x = rng.randn(2, 1234)
    h = rng.randn(width)
    K = (width - 1) // 2
    n_out = -(-x.shape[-1] // stride)
    kw = dict(stride=stride, pad_left=K, n_out=n_out)
    for group in (128, 1024):
        want = np.asarray(JR.fir_conv_matmul(x, h, group=group, **kw))
        got = _np(TR.fir_conv_matmul(x, h, group=group, device="cpu", **kw))
        assert got.shape == want.shape
        assert np.allclose(got, want, atol=TOL), np.abs(got - want).max()


@pytest.mark.parametrize("up,down", [(3, 2), (2, 1), (441, 160)])
def test_fir_conv_matmul_polyphase_matches_jax(signal, up, down):
    phi, k_min = TR.resample_matrices(up, down)
    n_out = -(-signal.shape[-1] * up // down)
    kw = dict(stride=down, pad_left=-k_min, n_out=n_out)
    want = np.asarray(JR.fir_conv_matmul(signal, phi, **kw))
    got = _np(TR.fir_conv_matmul(signal, phi, device="cpu", **kw))
    assert np.allclose(got, want, atol=TOL), np.abs(got - want).max()
