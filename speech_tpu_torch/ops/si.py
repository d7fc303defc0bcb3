"""Short-integration features in PyTorch.

The counterpart of :mod:`speech_tpu.ops.si`.  With ``fir_f`` the filter's
impulse response rolled to start at sample 0 and clamped to the largest
support ``T``, and ``conv[m] = sum_k fir_f[k] x[m - k]`` the plain linear
convolution, the filtered stream is ``y_f[n] = conv_f[n + shift_eff]`` and
frame ``k``'s coefficient is one dot product of ``|y_f|^p`` against the
``2*frame_shift``-sample integration window:

    coeff[k] = sum_{t<2s} w[t] * |y_f[k*s + t]|^p

The host builders (:func:`build_si_kernel`, :func:`toeplitz_conv_blocks`)
are numpy and array-equal to the JAX package's.  The device part is plain
tensor code, as the JAX package leaves it to XLA: the banded-Toeplitz
convolution as one batched matrix product (cuBLAS on a GPU), the FFT modes
as ``torch.fft``, the direct mode as ``conv1d``.  Every float32 product and
convolution runs in IEEE float32 (:func:`~.stft.ieee_float32`), so the
float tiers 'highest', 'high' and 'default' all compute the same IEEE
float32 result; the digit tiers 'double' and 'accurate' sum integer digit
products below 2^24, which is exact only in IEEE float32.

:func:`si_feats_from_signal` takes one signal ``(L,)`` or a batch ``(B,
L)``; each signal of a batch has its own length and, in the digit tiers,
its own power-of-two scale, as the JAX package's ``vmap`` of it gives.
"""

import numpy as np
import torch
import torch.nn.functional as TF

from .stft import (
    _DIGIT_BASE,
    _SAK_BASE,
    _SAK_CUTOFF,
    _SAK_KCHUNK,
    _SAK_X_DIGITS,
    _SI_PAIR_CUTOFF,
    _SI_X_DIGITS,
    digit_pair_schedule,
    floor_log,
    ieee_float32,
)

__all__ = [
    "CONV_BLOCK",
    "block_conv_parts",
    "build_si_kernel",
    "si_feats_from_signal",
    "toeplitz_conv_blocks",
]

# block width of conv_mode="matmul" (toeplitz_conv_blocks): work scales with
# (ceil(T/V) + 1) * V
CONV_BLOCK = 128


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


# --- host builders (numpy) ---------------------------------------------------


def build_si_kernel(
    bank,
    frame_shift: int,
    frame_style: str,
    window: np.ndarray,
    include_energy: bool,
) -> dict:
    """Host precompute: FIR matrix, alignment offsets, integration window.

    Impulse responses are materialised in a ``dft_size`` circular buffer,
    rolled so that causal mode places each support at its true acausal
    alignment and centered mode recenters each filter's support midpoint,
    then clamped to the largest support ``T`` (reference:
    compute.py:695-749).
    """
    rate = bank.sampling_rate
    if frame_style == "centered":
        max_support = max(right - left for left, right in bank.supports)
        translation = max_support // 2
    else:
        translation = 0
        max_support = 0
        for left, right in bank.supports:
            translation = max(-left, translation)
            max_support = max(max_support, right)
        max_support += translation
    min_support_hz = min(right - left for left, right in bank.supports_hz)
    frame_length = max_support + frame_shift - 1
    dft_size = max(frame_length, int(np.ceil(2 * rate / min_support_hz)))
    dft_size = _next_pow2(dft_size)

    is_real = bank.is_real
    fir_dtype = np.float64 if is_real else np.complex128
    firs = np.zeros((bank.num_filts, max_support), dtype=fir_dtype)
    for filt_idx in range(bank.num_filts):
        filt = bank.get_impulse_response(filt_idx, dft_size)
        if frame_style == "centered":
            left_samp, right_samp = bank.supports[filt_idx]
            mid_samp = (left_samp + right_samp) // 2
            filt = np.roll(filt, translation - mid_samp + 1)
        else:
            filt = np.roll(filt, translation)
        firs[filt_idx] = filt[:max_support]

    shift_eff = (
        translation - frame_shift if frame_style == "centered" else translation
    )
    return {
        "firs": firs,
        "window": np.asarray(window, dtype=np.float64),
        "shift_eff": shift_eff,
        "translation": translation,
        "max_support": max_support,
        "frame_length": frame_length,
        "frame_shift": frame_shift,
        "dft_size": dft_size,
        "is_real": is_real,
        "include_energy": include_energy,
    }


def toeplitz_conv_blocks(firs: np.ndarray, V: int = CONV_BLOCK) -> np.ndarray:
    """Banded-Toeplitz block matrices expressing linear convolution as
    matrix products: for output block ``i`` of width ``V``, ``y[i*V + t] =
    sum_k (x_block[i - k] @ A[k])[t]`` with ``A[k][u, t] = fir[k*V + t -
    u]`` (zero outside ``[0, T)``).  Returns ``(K + 1, F, V, V)`` with ``K =
    ceil((T - 1) / V)``."""
    F, T = firs.shape
    K = -(-(T - 1) // V) if T > 1 else 0
    diff = np.arange(V)[None, :] - np.arange(V)[:, None]  # t - u
    blocks = np.zeros((K + 1, F, V, V), dtype=firs.dtype)
    for k in range(K + 1):
        j = diff + k * V
        mask = (j >= 0) & (j < T)
        blocks[k][:, mask] = firs[:, j[mask]]
    return blocks


# --- device path (torch) -----------------------------------------------------


def _shifted(flat, nb: int, V: int, lo: int, hi: int):
    """``(hi - lo, B, nb, V)``: the signal blocks of ``flat (B, >= nb*V)``
    shifted down ``k`` blocks for ``k`` in ``[lo, hi)`` (block ``i`` reads
    block ``i - k``, zero before the start)."""
    Xb = flat[:, : nb * V].reshape(flat.shape[0], nb, V)
    return torch.stack([TF.pad(Xb, (0, 0, k, 0))[:, :nb] for k in range(lo, hi)])


def _block_product(Xsh, A):
    """``sum_k Xsh[k] @ A[k]``: ``(K, B, nb, V) x (K, F, V, W) -> (B, F,
    nb, W)``, one batched product contracting the shifts and the block."""
    return torch.einsum("kbnv,kfvw->bfnw", Xsh, A)


def block_conv_parts(x_pad, nb: int, V: int, Kk: int, precision: str):
    """The banded-Toeplitz convolution core of the batch and streaming
    paths.

    Returns ``part(params, name) -> (B, F, nb*V)``: the full linear-conv
    outputs of one FIR part (``name`` ``conv_re`` or ``conv_im``) over the
    padded signals ``x_pad (B, >= nb*V)``, sharing the signal-side work
    (the shifted blocks, or the digit planes and scale of the digit tiers)
    across parts.

    Digit tiers: each signal splits under its own power-of-two scale (a
    margin bit more for 'accurate') into integer digit planes (round half
    to even, as ``jnp.round``), the band matrices likewise (the params'
    ``*_digits`` and ``*_scale``); each kept pair ``(i, j)`` of
    :func:`~.stft.digit_pair_schedule` is one product of integers below
    2^24 (exact in IEEE float32), added with the weight ``base^-(i+j+2)``
    in schedule order.  'double': base 64, 6 x-planes, 21 pairs, all
    shifts at once.  'accurate': base 256, 5 x-planes, 15 pairs, the
    shifts in chunks of at most ``_SAK_KCHUNK`` so that each product stays
    below 2^24.  One pair's product is live at a time, as the reference's
    ``lax.scan`` keeps it.
    """
    if precision not in ("double", "accurate"):
        Xsh = _shifted(x_pad, nb, V, 0, Kk + 1)

        def part(params, name):
            with ieee_float32():
                Y = _block_product(Xsh, params[name + "_blocks"])
            return Y.reshape(Y.shape[0], Y.shape[1], nb * V)

        return part

    if precision == "accurate":
        base, n_x, kchunk, cutoff = _SAK_BASE, _SAK_X_DIGITS, _SAK_KCHUNK, _SAK_CUTOFF
    else:
        base, n_x, kchunk, cutoff = _DIGIT_BASE, _SI_X_DIGITS, None, _SI_PAIR_CUTOFF

    m = torch.amax(torch.abs(x_pad), dim=-1, keepdim=True)
    _, e = torch.frexp(torch.clamp_min(m, 1e-30))
    x_scale = torch.ldexp(torch.ones_like(m), e + (1 if precision == "accurate" else 0))
    v = x_pad / x_scale
    planes = []
    for _ in range(n_x):
        d = torch.round(v * base)  # half to even, as jnp.round
        v = v * base - d
        planes.append(d)

    if kchunk is None or Kk + 1 <= kchunk:
        chunks = [(0, Kk + 1)]
    else:
        chunks = [(lo, min(lo + kchunk, Kk + 1)) for lo in range(0, Kk + 1, kchunk)]

    def part(params, name):
        A_digits = params[name + "_digits"]
        A_scale = params[name + "_scale"]
        pairs = digit_pair_schedule(n_x, A_digits.shape[0], cutoff)
        acc = None
        with ieee_float32():
            for lo, hi in chunks:
                for i, j in pairs:
                    p = _block_product(_shifted(planes[i], nb, V, lo, hi), A_digits[j][lo:hi])
                    p = p * base ** -(i + j + 2)  # a power of two: exact
                    acc = p if acc is None else acc.add_(p)
                    del p
        y = acc * (x_scale.reshape(-1, 1, 1, 1) * A_scale)
        return y.reshape(y.shape[0], y.shape[1], nb * V)

    return part


def _valid(n0: int, ny: int, limit, device):
    """``(B, ny)``: ``n0 + n < limit`` and ``n0 + n >= 0`` for ``n < ny``,
    ``limit (B,)`` a tensor of bounds."""
    n_idx = torch.arange(ny, device=device) + n0
    return (n_idx >= 0)[None, :] & (n_idx[None, :] < limit[:, None])


def si_feats_from_signal(
    signal,
    sig_len,
    num_frames: int,
    params: dict,
    *,
    frame_shift: int,
    shift_eff: int,
    max_support: int,
    is_real: bool,
    include_energy: bool,
    use_log: bool,
    use_power: bool,
    log_floor: float,
    fft_size: int,
    energy_offset: int = 0,
    conv_mode: str = "fft",
    precision: str = "highest",
):
    """The SI pipeline for zero-padded signal buffers.

    ``signal``: ``(L,)`` or ``(B, L)``; ``sig_len``: the true length (an int,
    or a ``(B,)`` tensor), samples at or past it already zero.  ``params``:
    ``firs_re`` ``(F, T)`` (plus ``firs_im`` for complex banks), ``window``
    ``(2*shift,)`` and, for ``conv_mode="matmul"``, the band matrices
    (``conv_*_blocks``, or ``conv_*_digits`` and ``conv_*_scale`` for the
    digit tiers).  Returns ``(num_frames, num_coeffs)`` (or ``(B,
    num_frames, num_coeffs)``), in the signal's dtype.
    """
    single = signal.dim() == 1
    if single:
        signal = signal[None]
    B, L = signal.shape
    device = signal.device
    if isinstance(sig_len, torch.Tensor):
        sig_len = sig_len.to(device=device, dtype=torch.int64).reshape(-1)
    else:
        sig_len = torch.full((B,), int(sig_len), dtype=torch.int64, device=device)
    window = params["window"]
    firs_re = params["firs_re"]
    num_filts = firs_re.shape[0]
    T = max_support
    # the last frame k = num_frames - 1 reads y up to k*shift + 2*shift - 1
    ny = (num_frames + 1) * frame_shift
    valid = _valid(shift_eff, ny, sig_len + T - 1, device)[:, None, :]

    if conv_mode == "direct":
        # conv1d correlates: corr[q] = sum_j pad[q + j] rev[j] with rev the
        # flipped FIR gives conv[m] at q = m - T + 1 in padded coordinates
        pl = max(0, T - 1 - shift_eff)
        q0 = shift_eff + pl - T + 1
        need = q0 + ny - 1 + T
        padded = TF.pad(signal, (pl, max(0, need - pl - L)))

        def conv_part(f):
            with ieee_float32():
                out = TF.conv1d(padded[:, None, :], torch.flip(f, (-1,))[:, None, :])
            return torch.where(valid, out[..., q0 : q0 + ny], 0)

    elif conv_mode == "matmul":
        if precision in ("double", "accurate"):
            V = params["conv_re_digits"].shape[-1]
            Kk = params["conv_re_digits"].shape[1] - 1
        else:
            V = params["conv_re_blocks"].shape[-1]
            Kk = params["conv_re_blocks"].shape[0] - 1
        pl = max(0, -shift_eff)
        nb = max(1, -(-max(shift_eff + ny, 1) // V))
        sig_pad = TF.pad(signal, (0, max(0, nb * V - L)))
        part_fn = block_conv_parts(sig_pad, nb, V, Kk, precision)

        def conv_part(name):
            y = part_fn(params, name)  # (B, F, nb*V): the full conv outputs
            if pl:
                y = TF.pad(y, (pl, 0))
            return torch.where(valid, y[..., shift_eff + pl : shift_eff + pl + ny], 0)

    elif conv_mode == "fft" and fft_size >= 4 * _next_pow2(2 * T):
        # blocked overlap-save: block i gives conv outputs [m0 + i*V, m0 +
        # (i+1)*V) from the signal span [m_block - T + 1, m_block + V)
        Bk = _next_pow2(2 * T)
        V = Bk - T + 1
        nblocks = -(-ny // V)
        pl = max(0, T - 1 - shift_eff)
        need = shift_eff + pl + (nblocks - 1) * V + Bk
        padded = TF.pad(signal, (pl, max(0, need - pl - L)))
        start = shift_eff + pl - (T - 1)
        x_blocks = padded[:, start : start + (nblocks - 1) * V + Bk].unfold(-1, Bk, V)
        Xb = torch.fft.rfft(x_blocks, dim=-1)  # (B, nblocks, Bk//2 + 1)

        def conv_part(f):
            H = torch.fft.rfft(f, n=Bk, dim=-1)  # (F, Bk//2 + 1)
            yb = torch.fft.irfft(Xb[:, None] * H[None, :, None, :], n=Bk, dim=-1)
            y = yb[..., T - 1 :].reshape(B, f.shape[0], nblocks * V)[..., :ny]
            return torch.where(valid, y, 0)

    else:
        X = torch.fft.rfft(signal, n=fft_size, dim=-1)
        # the conv values needed are the run [shift_eff, shift_eff + ny)
        pl = max(0, -shift_eff)
        pr = max(0, shift_eff + ny - fft_size)

        def conv_part(f):
            H = torch.fft.rfft(f, n=fft_size, dim=-1)
            conv = torch.fft.irfft(X[:, None, :] * H[None], n=fft_size, dim=-1)
            if pl or pr:
                conv = TF.pad(conv, (pl, pr))
            return torch.where(valid, conv[..., shift_eff + pl : shift_eff + pl + ny], 0)

    if conv_mode == "matmul":
        conv_re = lambda: conv_part("conv_re")  # noqa: E731
        conv_im = lambda: conv_part("conv_im")  # noqa: E731
    else:
        conv_re = lambda: conv_part(firs_re)  # noqa: E731
        conv_im = lambda: conv_part(params["firs_im"])  # noqa: E731
    if is_real:
        y = conv_re()
        y_mod = y * y if use_power else torch.abs(y)
    else:
        yr = conv_re()
        yi = conv_im()
        y_mod = yr * yr + yi * yi
        del yr, yi
        if not use_power:
            y_mod = torch.sqrt(y_mod)

    if include_energy:
        # the Dirac filter: y_e[n] = x[n + energy_offset], a static slice of
        # the padded signal
        e_valid = _valid(energy_offset, ny, sig_len, device)
        e_pl = max(0, -energy_offset)
        e_pr = max(0, energy_offset + ny - L)
        xe_buf = TF.pad(signal, (e_pl, e_pr)) if (e_pl or e_pr) else signal
        xe = xe_buf[:, energy_offset + e_pl : energy_offset + e_pl + ny]
        xe = torch.where(e_valid, xe, 0)
        e_mod = xe * xe if use_power else torch.abs(xe)
        y_mod = torch.cat([e_mod[:, None, :].to(y_mod.dtype), y_mod], dim=1)
        num_filts += 1

    # frame k <- dot(window, y_mod[:, k*s : k*s + 2s]): with ny = (frames +
    # 1) * shift the windows factor into shift-sized blocks under the
    # window's two halves, two matrix-vector products
    blocks = y_mod.reshape(B, num_filts, num_frames + 1, frame_shift)
    with ieee_float32():
        lo = torch.matmul(blocks, window[:frame_shift])
        hi = torch.matmul(blocks, window[frame_shift:])
    feats = (lo[..., :-1] + hi[..., 1:]).transpose(-1, -2)
    if use_log:
        feats = floor_log(feats, log_floor)
    return feats[0] if single else feats

