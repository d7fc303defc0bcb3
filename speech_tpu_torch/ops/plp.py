"""Perceptual linear prediction (PLP) cepstra from filter-bank powers, in
PyTorch.

The counterpart of :mod:`speech_tpu.ops.plp` (Kaldi ``compute-plp-feats``;
Hermansky 1990).  The pipeline, applied to *linear power* filter-bank
outputs (a computer built with ``use_log=False, use_power=True``):

1. equal-loudness weighting of each band (:func:`equal_loudness` at the
   bank's center frequencies),
2. intensity -> loudness cube-root compression (``compress``),
3. autocorrelations by an inverse cosine transform of the symmetrised band
   spectrum (one constant ``(B+2, order+1)`` matrix product,
   :func:`autocorr_idft_matrix`),
4. Levinson-Durbin to LPC coefficients,
5. LPC -> cepstrum recursion, ``c[0] = log(residual energy)``,
6. Kaldi-style cepstral liftering of ``c[1:]``.

The host builders and :func:`plp_np` are numpy copies of the JAX
package's.  :func:`plp` is plain tensor code: the Levinson and cepstral
recursions unroll over the static LPC order as elementwise updates over
every frame at once.
"""

from typing import Sequence

import numpy as np
import torch

from .stft import ieee_float32

__all__ = [
    "autocorr_idft_matrix",
    "equal_loudness",
    "plp",
    "plp_np",
]


def equal_loudness(center_hz) -> np.ndarray:
    """Hermansky's 40-dB equal-loudness curve at the given frequencies:
    ``E(f) = (f^2 / (f^2 + 1.6e5))^2 * (f^2 + 1.44e6) / (f^2 + 9.61e6)``.
    Host float64."""
    f2 = np.asarray(center_hz, np.float64) ** 2
    return (f2 / (f2 + 1.6e5)) ** 2 * (f2 + 1.44e6) / (f2 + 9.61e6)


def autocorr_idft_matrix(num_bands: int, order: int) -> np.ndarray:
    """Host ``(num_bands + 2, order + 1)`` inverse-cosine-transform matrix.

    Treats the ``num_bands`` compressed band energies, padded with
    duplicated edge bands, as ``M + 2 = num_bands + 2`` samples of an even
    spectrum of period ``2 (M + 1)``; column ``i`` yields autocorrelation
    lag ``i``:

    ``r_i = (1/(M+1)) [ S_0/2 + sum_{j=1}^{M} S_j cos(pi i j/(M+1))
    + (-1)^i S_{M+1}/2 ]``.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    M = int(num_bands)
    if M < 1:
        raise ValueError(f"num_bands must be >= 1, got {num_bands}")
    j = np.arange(M + 2, dtype=np.float64)
    i = np.arange(order + 1, dtype=np.float64)
    w = np.ones(M + 2)
    w[0] = w[-1] = 0.5
    return (w[:, None] / (M + 1)) * np.cos(
        np.pi * np.outer(j, i) / (M + 1)
    )


def _levinson(r, order: int, maximum, tiny):
    """Levinson-Durbin over ``r[..., 0:order+1]``; static unroll.

    Returns ``(a, err)``: prediction coefficients ``a[0:order]`` (for
    ``x_t ~ sum_i a[i-1] x_{t-i}``, i.e. ``A(z) = 1 - sum a_i z^-i``) and
    the residual energy.  ``maximum`` is ``np.maximum`` or
    ``torch.maximum``-like (``(x, tiny)``)."""
    err = r[..., 0]
    a = []
    for m in range(1, order + 1):
        acc = r[..., m]
        for i in range(1, m):
            acc = acc - a[i - 1] * r[..., m - i]
        k = acc / maximum(err, tiny)
        a = [a[i - 1] - k * a[m - i - 1] for i in range(1, m)] + [k]
        err = err * (1.0 - k * k)
    return a, err


def _lpc_cepstrum(a, num_ceps: int):
    """Cepstra ``c_1..c_{num_ceps-1}`` of the LPC model ``1/A(z)``:
    ``c_n = a_n + sum_{k=1}^{n-1} (k/n) c_k a_{n-k}`` (terms with ``n - k
    > order`` drop).  Static unroll; a list of per-frame arrays."""
    order = len(a)
    c = []
    for n in range(1, num_ceps):
        acc = a[n - 1] if n <= order else 0.0
        for k in range(max(1, n - order), n):
            acc = acc + (k / n) * c[k - 1] * a[n - k - 1]
        c.append(acc)
    return c


def _lifter_weights(num_ceps: int, lifter: float) -> np.ndarray:
    n = np.arange(1, num_ceps, dtype=np.float64)
    if not lifter:
        return np.ones(num_ceps - 1)
    return 1.0 + 0.5 * lifter * np.sin(np.pi * n / lifter)


def _validate(num_bands, order, num_ceps, compress, lifter):
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if not 2 <= num_ceps <= order + 1:
        raise ValueError(
            f"num_ceps must be in [2, order + 1 = {order + 1}], got "
            f"{num_ceps}"
        )
    if order > num_bands + 1:
        raise ValueError(
            f"order ({order}) exceeds the {num_bands + 2}-point spectrum's "
            f"lag range (needs order <= num_bands + 1 = {num_bands + 1})"
        )
    if compress <= 0:
        raise ValueError(f"compress must be positive, got {compress}")
    if lifter < 0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")


def plp(
    bank_power,
    center_hz: Sequence[float],
    *,
    order: int = 12,
    num_ceps: int = 13,
    compress: float = 1.0 / 3.0,
    lifter: float = 22.0,
    eps: float = 1e-10,
):
    """PLP cepstra ``(..., num_ceps)`` from band powers ``(..., B)``.

    ``bank_power`` holds *linear power* filter-bank outputs;
    ``center_hz`` the bank's per-filter peak frequencies
    (``bank.centers_hz``).  Column 0 is the log residual energy (the LPC
    model gain); columns ``1..num_ceps-1`` are liftered LPC cepstra.
    Padded all-zero frames give finite values (the ``eps`` floor).  The
    autocorrelation product runs in IEEE float32 (or float64).
    """
    x = bank_power
    B = x.shape[-1]
    if len(center_hz) != B:
        raise ValueError(
            f"center_hz has {len(center_hz)} entries for {B} bands"
        )
    _validate(B, order, num_ceps, compress, lifter)
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    dt, dev = x.dtype, x.device
    E = torch.tensor(equal_loudness(center_hz), dtype=dt, device=dev)
    S = torch.clamp_min(x * E, eps)
    S = torch.exp(compress * torch.log(S))
    S = torch.cat([S[..., :1], S, S[..., -1:]], dim=-1)
    mat = torch.tensor(autocorr_idft_matrix(B, order), dtype=dt, device=dev)
    with ieee_float32():
        r = torch.matmul(S, mat)
    tiny = float(torch.finfo(dt).tiny)
    a, err = _levinson(r, order, torch.clamp_min, tiny)
    c = _lpc_cepstrum(a, num_ceps)
    lift = _lifter_weights(num_ceps, lifter)
    cols = [torch.log(torch.clamp_min(err, tiny))]
    cols += [ci * torch.tensor(li, dtype=dt, device=dev) for ci, li in zip(c, lift)]
    return torch.stack(cols, dim=-1)


def plp_np(
    bank_power,
    center_hz: Sequence[float],
    *,
    order: int = 12,
    num_ceps: int = 13,
    compress: float = 1.0 / 3.0,
    lifter: float = 22.0,
    eps: float = 1e-10,
) -> np.ndarray:
    """Host float64 twin of :func:`plp` (used by ``post.PLP``)."""
    x = np.asarray(bank_power, np.float64)
    B = x.shape[-1]
    if len(center_hz) != B:
        raise ValueError(
            f"center_hz has {len(center_hz)} entries for {B} bands"
        )
    _validate(B, order, num_ceps, compress, lifter)
    S = np.maximum(x * equal_loudness(center_hz), eps) ** compress
    S = np.concatenate([S[..., :1], S, S[..., -1:]], axis=-1)
    r = S @ autocorr_idft_matrix(B, order)
    tiny = np.finfo(np.float64).tiny
    a, err = _levinson(r, order, np.maximum, tiny)
    c = _lpc_cepstrum(a, num_ceps)
    lift = _lifter_weights(num_ceps, lifter)
    cols = [np.log(np.maximum(err, tiny))]
    cols += [ci * li for ci, li in zip(c, lift)]
    return np.stack(cols, axis=-1)
