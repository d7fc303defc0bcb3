"""Rational-ratio polyphase resampling as framing + one matmul, in PyTorch.

The counterpart of :mod:`speech_tpu.ops.resample`.  With reduced ratio
``L/M`` and a centered odd FIR ``h`` of half-width ``K``, output ``i = j*L
+ p`` is ``y[i] = sum_k h[p*M + K - L*k] x[j*M + k]``: block ``j`` reads
one window of the input at stride ``M``, and phase ``p`` dots it with a
fixed row of the phase matrix, so ``Y = frames @ Phi^T``.  Long windows
(decimation, strong upsampling) go through :func:`fir_conv_matmul`, a
banded-Toeplitz block product over overlapping hop-sized blocks.

The FIR is the Kaiser-windowed sinc at cutoff ``1/max(L, M)`` (half-width
``10*max(L, M)``, beta 5.0), scipy's ``resample_poly`` design.  The host
builders are numpy copies of the JAX package's; the products run in IEEE
float32 (or float64) on the signal's device, as the reference runs them at
``Precision.HIGHEST``.
"""

import contextlib
from functools import lru_cache
from math import gcd
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ._device import as_tensor
from .framing import frame_padded
from .stft import ieee_float32

__all__ = ["fir_conv_matmul", "resample", "resample_matrices", "resample_np"]

# the reference's precision names (jax.lax.Precision), as strings
_PRECISION_NAMES = ("default", "high", "highest")


@contextlib.contextmanager
def _tf32():
    matmul = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)


def _products(precision="highest"):
    """The context float32 products run in for a reference precision name:
    IEEE float32 for ``"highest"`` (:func:`.stft.ieee_float32`), TF32 on
    the card for ``"high"`` and ``"default"`` (the reduced tiers; the CPU
    computes every tier in IEEE float32).  A ``jax.lax.Precision`` member's
    name is accepted too."""
    name = str(getattr(precision, "name", precision)).lower()
    if name not in _PRECISION_NAMES:
        raise ValueError(f"precision must be one of {_PRECISION_NAMES}, got {precision!r}")
    return ieee_float32() if name == "highest" else _tf32()


def _signal(signal, device):
    """A float tensor: integer PCM upcasts to float32, as in the reference."""
    signal = as_tensor(signal, device)
    if not signal.is_floating_point():
        signal = signal.to(torch.float32)
    return signal


@lru_cache(maxsize=32)
def _toeplitz_block(h_key, n_phases: int, stride: int, group: int, depth: int = 2):
    """Host precompute of the banded-Toeplitz block ``T`` for
    :func:`fir_conv_matmul`: with ``phi`` the ``(n_phases, W)`` phase
    matrix (``h_key`` row-major), ``T[m, q*n_phases + p] =
    phi[p, m - stride*q]`` (zero outside the taps), shape
    ``(depth*group*stride, group*n_phases)``; ``depth`` is how many
    hop-sized input blocks one output block's window spans."""
    phi = np.asarray(h_key, np.float64).reshape(n_phases, -1)
    W = phi.shape[1]
    rows = depth * group * stride
    m = np.arange(rows)[:, None] - stride * np.arange(group)[None, :]
    band = np.where(
        (m >= 0)[None] & (m < W)[None],
        phi[:, np.clip(m, 0, W - 1)],
        0.0,
    )  # (n_phases, rows, group)
    return band.transpose(1, 2, 0).reshape(rows, group * n_phases)


def fir_conv_matmul(
    signal,
    h,
    stride: int = 1,
    pad_left: int = 0,
    n_out: Optional[int] = None,
    precision="highest",
    group: int = 128,
    device=None,
):
    """Strided polyphase FIR correlation as banded-Toeplitz block matmuls.

    With ``h`` a single ``(W,)`` filter: ``y[i] = sum_t h[t] *
    x[i*stride + t - pad_left]`` (``x`` zero outside its extent).  With
    ``h`` a ``(P, W)`` phase matrix, output phases interleave: ``y[b*P +
    p] = sum_t h[p, t] * x[b*stride + t - pad_left]``.

    The signal is cut into overlapping blocks of ``depth*group*stride``
    samples at hop ``group*stride`` (a strided view) and multiplied by one
    constant ``(depth*group*stride, group*P)`` Toeplitz block; ``depth``
    is the smallest window that covers the taps, so a long FIR (a room
    impulse response) stays one product.  Batched over leading axes.
    """
    signal = _signal(signal, device)
    h = np.asarray(h, np.float64)
    P = 1 if h.ndim == 1 else h.shape[0]
    W = h.shape[-1]
    stride = int(stride)
    N = signal.shape[-1]
    if n_out is None:
        n_out = (-(-N // stride)) * P
    # the Toeplitz block ~512-1024 rows: G output blocks span G*stride
    # input samples, so large strides shrink the group
    G = max(1, min(int(group), -(-512 // stride)))
    # window depth: the smallest D with D*G*stride >= (G-1)*stride + W
    D = max(2, -(-((G - 1) * stride + W) // (G * stride)))
    out_blocks = -(-n_out // P)
    n_blocks = -(-out_blocks // G)
    T = torch.as_tensor(
        _toeplitz_block(tuple(h.ravel().tolist()), P, stride, G, D),
        dtype=signal.dtype,
        device=signal.device,
    )
    padded = TF.pad(signal, (int(pad_left), 0))
    frames = frame_padded(padded, n_blocks, D * G * stride, G * stride)
    with _products(precision):
        out = torch.matmul(frames, T)
    return out.reshape(signal.shape[:-1] + (n_blocks * G * P,))[..., :n_out]


@lru_cache(maxsize=32)
def resample_matrices(up: int, down: int, half_width: int = 10, beta: float = 5.0):
    """Host precompute: ``(Phi, k_min)`` for a reduced ``up/down`` ratio.

    ``Phi`` is the float64 ``(up, W)`` phase-filter matrix; window ``j``
    of the input (``W`` samples starting at ``j*down + k_min``) maps to
    output block ``j`` (phases ``0..up-1``) via ``window @ Phi.T``.
    """
    L, M = int(up), int(down)
    if L < 1 or M < 1:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    K = half_width * max(L, M)
    n = np.arange(-K, K + 1, dtype=np.float64)
    cutoff = 1.0 / max(L, M)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(2 * K + 1, beta)
    h *= L / h.sum()  # unit DC gain, then the interpolation gain L
    # phase p of output block j reads input samples j*M + k for
    # k in [k_min, k_max]; taps outside h's support are zero
    k_min = -(K // L) - 1
    k_max = ((L - 1) * M + K) // L
    W = k_max - k_min + 1
    phi = np.zeros((L, W), dtype=np.float64)
    for p in range(L):
        idx = p * M + K - L * (np.arange(k_min, k_max + 1))
        valid = (idx >= 0) & (idx <= 2 * K)
        phi[p, valid] = h[idx[valid]]
    phi.setflags(write=False)  # lru_cache shares the instance
    return phi, k_min


def resample(
    signal,
    up: int,
    down: int,
    half_width: int = 10,
    beta: float = 5.0,
    precision="highest",
    device=None,
):
    """Resample ``(..., N)`` signals by the rational factor ``up/down``.

    Batched over leading axes.  Returns ``(..., ceil(N*up/down))`` in the
    input's floating dtype (integer PCM becomes float32); the signal is
    zero outside its extent (scipy ``resample_poly`` semantics).  A tensor
    stays on its device; other input goes to ``device`` (the GPU by
    default).
    """
    if int(up) < 1 or int(down) < 1:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = gcd(int(up), int(down))
    L, M = int(up) // g, int(down) // g
    signal = _signal(signal, device)
    N = signal.shape[-1]
    if L == 1 and M == 1:
        return signal
    n_out = -(-N * L // M)
    if L == 1:
        # pure decimation: the L=1 phase matrix is one row [0, h[::-1]],
        # and its tail is the FIR
        K = half_width * M
        phi1, _ = resample_matrices(1, M, half_width, beta)
        return fir_conv_matmul(
            signal, phi1[0, 1:], stride=M, pad_left=K, n_out=n_out, precision=precision
        )
    n_blocks = -(-n_out // L)
    phi, k_min = resample_matrices(L, M, half_width, beta)
    W = phi.shape[1]
    if W > 4 * M:
        # strong upsampling (wide windows): framing would copy each sample
        # W/M times, the Toeplitz block form about twice
        return fir_conv_matmul(
            signal, phi, stride=M, pad_left=-k_min, n_out=n_out, precision=precision
        )
    phi_t = torch.as_tensor(phi.T.copy(), dtype=signal.dtype, device=signal.device)
    pad_left = -k_min
    pad_right = max((n_blocks - 1) * M + k_min + W - N, 0)
    padded = TF.pad(signal, (pad_left, pad_right))
    frames = frame_padded(padded, n_blocks, W, M)
    with _products(precision):
        out = torch.matmul(frames, phi_t)
    return out.reshape(signal.shape[:-1] + (n_blocks * L,))[..., :n_out]


def resample_np(signal, up: int, down: int, half_width: int = 10, beta: float = 5.0):
    """Host (numpy, float64) twin of :func:`resample` for ingestion paths:
    1-D in, 1-D out; the same matrices and framing as its float64 path."""
    if int(up) < 1 or int(down) < 1:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = gcd(int(up), int(down))
    L, M = int(up) // g, int(down) // g
    signal = np.asarray(signal, dtype=np.float64)
    N = signal.shape[-1]
    if L == 1 and M == 1:
        return signal
    n_out = -(-N * L // M)
    n_blocks = -(-n_out // L)
    phi, k_min = resample_matrices(L, M, half_width, beta)
    W = phi.shape[1]
    pad_left = -k_min
    pad_right = max((n_blocks - 1) * M + k_min + W - N, 0)
    padded = np.pad(signal, (pad_left, pad_right))
    frames = np.lib.stride_tricks.sliding_window_view(padded, W)[::M]
    return (frames[:n_blocks] @ phi.T).reshape(n_blocks * L)[:n_out]
