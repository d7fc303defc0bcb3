"""The pitch tracker's Viterbi kernel on the CPU: which inputs
``ops/pitch.py:viterbi_on_kernel`` sends to it, what its wrapper
``stft_kernels.viterbi_path`` refuses before launching, and how
``_viterbi`` hands it its scores.  The kernel itself runs on the card only
(``tests/test_torch_gpu.py``: its path against the loops', bit for bit)."""

import numpy as np
import pytest
import torch

from speech_tpu_torch.ops import pitch as TP
from speech_tpu_torch.ops import stft_kernels as K

MAX = K.VITERBI_MAX_LAGS


@pytest.mark.parametrize(
    "device,dtype,lags,takes",
    [
        ("cuda", torch.float32, 418, True),
        ("cuda:1", torch.float32, 210, True),
        ("cuda", torch.float32, 1, True),
        ("cuda", torch.float32, MAX, True),
        ("cpu", torch.float32, 418, False),
        ("cuda", torch.float64, 418, False),
        ("cuda", torch.float16, 418, False),
        ("cuda", torch.float32, MAX + 1, False),
        ("cuda", torch.float32, 0, False),
    ],
)
def test_viterbi_on_kernel_takes_cuda_float32_up_to_the_limit(device, dtype, lags, takes):
    assert TP.viterbi_on_kernel(torch.device(device), dtype, lags) is takes
    assert TP.viterbi_on_kernel(device, dtype, lags) is takes


def _inputs(T=5, rows=3, L=7):
    nc = torch.zeros((T, rows, L), dtype=torch.float32)
    tmat = torch.zeros((L, L), dtype=torch.float32)
    counts = torch.full((rows,), T, dtype=torch.int64)
    return nc, tmat, counts


REFUSED = {
    "float64 scores": lambda nc, tmat, counts: (nc.double(), tmat, counts),
    "float64 table": lambda nc, tmat, counts: (nc, tmat.double(), counts),
    "2-D scores": lambda nc, tmat, counts: (nc[:, 0], tmat, counts),
    "no frames": lambda nc, tmat, counts: (nc[:0], tmat, counts),
    "strided lags": lambda nc, tmat, counts: (
        torch.zeros((5, 3, 14))[..., ::2], tmat, counts),
    "too many lags": lambda nc, tmat, counts: (
        torch.zeros((2, 1, MAX + 1)), torch.zeros((MAX + 1, MAX + 1)), None),
    "table shape": lambda nc, tmat, counts: (nc, tmat[:, :6], counts),
    "int32 counts": lambda nc, tmat, counts: (nc, tmat, counts.int()),
    "counts shape": lambda nc, tmat, counts: (nc, tmat, counts[:2]),
    "cpu device": lambda nc, tmat, counts: (nc, tmat, counts),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_viterbi_path_refuses_before_launching(case, monkeypatch):
    """Wrong dtypes, shapes or a CPU device raise ``ValueError`` before
    the wrapper asks for its library (a CPU build has none) or counts a
    launch."""
    def no_library(*args):
        raise AssertionError("the wrapper reached for its library")

    monkeypatch.setattr(K, "_launcher", no_library)
    K.reset_launch_counts()
    nc, tmat, counts = REFUSED[case](*_inputs())
    with pytest.raises(ValueError):
        K.viterbi_path(nc, tmat, counts, steps=3)
    assert K.launch_counts()["viterbi_path"] == 0


def _scores(shape, L, seed):
    rng = np.random.RandomState(seed)
    # a quarter of the scores on a grid of four values: exact ties
    nc = rng.rand(*shape, L).astype(np.float32)
    nc[..., ::4] = np.round(nc[..., ::4] * 4) / 4
    return torch.from_numpy(nc)


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)], ids=["one", "rows", "grid"])
@pytest.mark.parametrize("ragged", [False, True])
def test_viterbi_hands_the_kernel_flat_rows(batch, ragged, monkeypatch):
    """Where :func:`viterbi_on_kernel` takes the scores, ``_viterbi`` calls
    the wrapper once with ``(T, rows, L)`` scores flattened over its batch
    axes (no copy), the counts flattened alike and the clamped ``steps``,
    and gives its ``(T, rows)`` path the batch's shape: here the wrapper is
    the loops themselves, so the path is the loops'."""
    T, L = 9, 6
    nc = torch.movedim(_scores(batch + (T,), L, 3), -2, 0)  # (T, *batch, L), as _choose_lags
    tmat = torch.from_numpy(TP._lag_tables(4000.0, 50.0, 400.0, 0.1, 0.2)[4][:L, :L]
                            .astype(np.float32))
    counts = None
    if ragged:
        counts = torch.from_numpy(
            np.random.RandomState(4).randint(0, T + 1, size=batch).astype(np.int64))
    want = TP._viterbi(nc, tmat, counts, steps=7)
    loops, calls = TP._viterbi, []

    def wrapper(flat, tmat_, counts_, steps_):
        calls.append((flat, counts_, steps_))
        with monkeypatch.context() as m:
            m.setattr(TP, "viterbi_on_kernel", lambda *a: False)
            return loops(flat, tmat_, counts_, steps_)

    monkeypatch.setattr(TP, "viterbi_on_kernel", lambda device, dtype, lags: True)
    monkeypatch.setattr(K, "viterbi_path", wrapper)
    got = TP._viterbi(nc, tmat, counts, steps=7)
    assert len(calls) == 1
    flat, flat_counts, steps = calls[0]
    rows = int(np.prod(batch))
    assert flat.shape == (T, rows, L) and flat.stride(-1) == 1
    assert flat.data_ptr() == nc.data_ptr()
    assert steps == 7
    assert (flat_counts is None) == (counts is None)
    if counts is not None:
        assert torch.equal(flat_counts, counts.reshape(-1))
    assert got.shape == want.shape == (T,) + batch and torch.equal(got, want)
