"""The STFT feature pipeline in PyTorch: host weight compilers and the plain
tensor path.

The PyTorch counterpart of :mod:`speech_tpu.ops.stft`.  Both reductions the
reference supports are linear in ``|H|`` (magnitude) or ``|H|^2`` (power),
so the reference's per-frame, per-filter walk folds at construction time
into one dense nonnegative weight matrix ``W`` over the half spectrum, and
the whole pipeline becomes

    frames -> window -> rDFT -> |.|^p -> matmul(W) -> log

The host builders below are numpy and array-equal to the JAX package's.
The device part is plain tensor code: it is the oracle the hand-written
kernels of :mod:`speech_tpu_torch.ops.stft_kernels` are held to, and the
path the computer takes where no kernel applies.  Its large products stay
``torch.matmul``; float32 products run in IEEE float32 (TF32 off).

Digit tiers (``precision="double"``/``"accurate"``): operands split into
integer digits so that every product and every sum of a group matmul is an
exact integer in float32, and equal-weight digit pairs run as one matmul
(:func:`digit_group_matrices`).  The int8 kernel layout
(:func:`int8_kernel_matrices`) uses base-128 digits with a margin bit on
both operands (|digit| <= 64) and power-of-two pair weights; 'double' keeps
pairs with ``i + j <= 5``, 'accurate' ``i + j <= 4``.  The base-256 digit
kernel layout (:func:`digit_kernel_matrices`) keeps 4 x 4 planes and one
dot per pair: 13 pairs (``i + j <= 4``) for 'double', 10 (``i + j <= 3``)
for 'accurate'.
"""

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from .. import config as _config

__all__ = [
    "digitize_matrix",
    "digit_pair_schedule",
    "digit_group_schedule",
    "digit_group_matrices",
    "digit_kernel_matrices",
    "int8_kernel_matrices",
    "fold_bank_to_weights",
    "windowed_dft_matrices",
    "power_half_spectrum",
    "stft_feats_from_frames",
]

_DIGIT_BASE = 64.0  # 7-bit signed digits: products <= 64^2, K-sums < 2^24
# base-256 digit kernel: 4 x-planes (31 bits below the frame peak after the
# one-bit scale margin, |x digit| <= 128) x 4 M-planes (32 bits of the
# float64 DFT matrices, no margin: |M digit| <= 256); one dot per pair, so
# a frame's sum stays below K * 2^15 <= 2^24 for K <= 512
_PDK_BASE = 256.0
_PDK_X_DIGITS = 4
_PDK_M_DIGITS = 4
_PDK_CUTOFF = 4  # 'double': i + j <= 4, 13 pairs, truncation ~2^-40
_PAK_X_DIGITS = 4  # 'accurate': the same planes, pairs cut at i + j <= 3
_PAK_M_DIGITS = 4
_PAK_CUTOFF = 3
_I8_BASE = 128.0
_I8_X_DIGITS = 5
_I8_M_DIGITS = 5
_I8_CUTOFF = 5  # 'double'
_I8_ACC_CUTOFF = 4  # 'accurate'
_X_DIGITS = 5  # 30 bits below the frame peak
_M_DIGITS = 6  # 36 bits of the float64 DFT matrices
_PAIR_CUTOFF = 5  # keep i + j <= 5 (weight >= 64^-7 ~ 2^-42 of the scale)
# short integration (ops/si.py): the convolution's digit tiers scale each
# signal as a whole, not each frame, so a loud transient before quiet
# speech needs more planes: 'double' keeps 6 base-64 x-planes and its own
# pair budget i + j <= 5 (21 pairs)
_SI_X_DIGITS = 6
_SI_PAIR_CUTOFF = 5
# SI 'accurate': base-256 digits, 5 x-planes x 5 band-matrix planes, pairs
# cut at i + j <= 4 (15 pairs); both operands carry a one-bit scale margin
# (|digit| <= 128), so a product over up to 8 shifted blocks of 128 sums
# integers below 2^24 (exact in float32), and longer supports split their
# shifts into chunks of at most 8 blocks
_SAK_BASE = 256.0
_SAK_X_DIGITS = 5
_SAK_M_DIGITS = 5
_SAK_CUTOFF = 4
_SAK_KCHUNK = 8


# --- host builders (numpy) ---------------------------------------------------


def digitize_matrix(
    M: np.ndarray,
    ndig: int = _M_DIGITS,
    base: float = _DIGIT_BASE,
    margin: bool = False,
):
    """Host: float64 matrix -> (ndig, *M.shape) integer-valued float32
    digit planes plus the power-of-two scale, ``M ~= scale * sum_i
    digits[i] * base^-(i+1)``.  ``margin`` doubles the scale so every
    digit (including plane 0) stays <= base/2."""
    scale = 2.0 ** np.ceil(np.log2(np.abs(M).max()))
    if margin:
        scale *= 2.0
    v = M / scale
    planes = []
    for _ in range(ndig):
        d = np.round(v * base)
        v = v * base - d
        planes.append(d.astype(np.float32))
    return np.stack(planes), np.float32(scale)


def digit_pair_schedule(n_x: int, n_m: int, cutoff: int = _PAIR_CUTOFF):
    """Kept ``(i, j)`` digit pairs, smallest weight first, so one running
    accumulator sums ascending in magnitude."""
    pairs = [
        (i, j) for i in range(n_x) for j in range(n_m) if i + j <= cutoff
    ]
    return sorted(pairs, key=lambda ij: -(ij[0] + ij[1]))


def digit_group_schedule(n_x: int, n_m: int, K: int, cutoff=_PAIR_CUTOFF):
    """Digit pairs grouped by shared weight ``base^-(s+2)``, ``s = i + j``,
    each group split so that it accumulates below ``2^24`` (exact in
    float32).  Smallest weight first.  Returns a list of (pair-list,
    weight)."""
    cap = max(1, int(2**24 // (K * _DIGIT_BASE * _DIGIT_BASE)))
    by_s = {}
    for i, j in digit_pair_schedule(n_x, n_m, cutoff):
        by_s.setdefault(i + j, []).append((i, j))
    groups = []
    for s in sorted(by_s, reverse=True):
        members = by_s[s]
        for lo in range(0, len(members), cap):
            groups.append(
                (members[lo : lo + cap], _DIGIT_BASE ** -(s + 2))
            )
    return groups


def digit_group_matrices(C: np.ndarray, S: np.ndarray):
    """Host: per-weight-group block matrices for the exact digit tier.

    Equal-weight pairs fold into one matmul against a block matrix, and the
    cos/sin targets share it column-wise (``[cos | sin]``) with sin's
    identically-zero columns dropped.

    Returns ``(mats (G, n_x*K, half + n_im), weights (G,), cos_scale,
    sin_scale, n_im)``; the imaginary part reconstructs as
    ``im[..., 1 : 1 + n_im]`` of the matmul's sin columns.
    """
    K, half = C.shape
    cos_planes, cos_scale = digitize_matrix(C)
    sin_planes, sin_scale = digitize_matrix(S)
    n_m = cos_planes.shape[0]
    im_hi = half - 1 if not np.any(sin_planes[:, :, -1]) else half
    if np.any(sin_planes[:, :, 0]):
        raise ValueError("sin DC column must be zero")
    n_im = im_hi - 1
    groups = digit_group_schedule(_X_DIGITS, n_m, K)
    mats = np.zeros((len(groups), _X_DIGITS * K, half + n_im), np.float32)
    for g, (members, _) in enumerate(groups):
        for i, j in members:
            mats[g, i * K : (i + 1) * K, :half] = cos_planes[j]
            mats[g, i * K : (i + 1) * K, half:] = sin_planes[j][:, 1:im_hi]
    weights = np.asarray([w for _, w in groups], np.float32)
    return mats, weights, cos_scale, sin_scale, n_im


def _combined_layout(C, S, W, ndig: int, base: float, margin: bool):
    """The digit kernels' shared lane layout ``[cos 0..nb-1 | nyq-cos, sin
    1..nb-1]`` with ``nb = dft//2``: the Nyquist cosine column sits in the
    sin block's identically-zero DC slot, so both blocks are exactly
    ``nb`` wide (even DFT sizes only).

    Returns ``mats (ndig, K, 2*nb)`` float32 digit planes and the tail
    arrays: ``mixed_scale (nb,)`` (cos scale at DC, sin scale elsewhere),
    ``mask (nb,)`` (zero at DC, one elsewhere: isolates the imaginary
    part), ``w_hi`` / ``w_lo`` ``(nb, F)`` (filter weights for bins
    0..nb-1, split f32-hi + residual), ``w_nyq (nb, F)`` (the Nyquist
    weight row at DC, zeros elsewhere) and ``cos_scale``.
    """
    K, half = C.shape
    if half % 2 != 1:
        raise ValueError("even DFT sizes only (half = dft//2 + 1)")
    nb = half - 1
    cos_planes, cos_scale = digitize_matrix(C, ndig, base, margin=margin)
    sin_planes, sin_scale = digitize_matrix(S, ndig, base, margin=margin)
    mats = np.zeros((ndig, K, 2 * nb), np.float32)
    for j in range(ndig):
        mats[j, :, :nb] = cos_planes[j][:, :nb]
        mats[j, :, nb] = cos_planes[j][:, nb]  # Nyquist cos in the DC slot
        mats[j, :, nb + 1 :] = sin_planes[j][:, 1:nb]
    mixed_scale = np.full((nb,), sin_scale, np.float32)
    mixed_scale[0] = cos_scale
    mask = np.ones((nb,), np.float32)
    mask[0] = 0.0
    w_hi = W[:nb].astype(np.float32)
    w_lo = (W[:nb] - w_hi.astype(np.float64)).astype(np.float32)
    w_nyq = np.zeros((nb, W.shape[1]), np.float32)
    w_nyq[0] = W[nb].astype(np.float32)
    return mats, {
        "mixed_scale": mixed_scale,
        "mask": mask,
        "w_hi": w_hi,
        "w_lo": w_lo,
        "w_nyq": w_nyq,
        "cos_scale": np.float32(cos_scale),
    }


def digit_kernel_matrices(
    C: np.ndarray,
    S: np.ndarray,
    W: np.ndarray,
    ndig: int = _PDK_M_DIGITS,
):
    """Host: base-256 digit planes for the fused double-tier digit kernel,
    in the combined lane layout of :func:`_combined_layout` (no margin
    bit: |digit| <= 256).  Returns a dict: ``mats (ndig, K, 2*nb)`` and
    the tail arrays ``mixed_scale``, ``mask``, ``w_hi``, ``w_lo``,
    ``w_nyq`` and ``cos_scale``."""
    mats, tail = _combined_layout(C, S, W, ndig, _PDK_BASE, margin=False)
    return {"mats": mats, **tail}


def int8_kernel_matrices(
    C: np.ndarray,
    S: np.ndarray,
    W: np.ndarray,
    cutoff: int = _I8_CUTOFF,
):
    """Host: weight-grouped int8 digit planes for the fused int8 kernel.

    The combined lane layout of :func:`_combined_layout` (needs ``dft % 4
    == 0`` for the kernel), digitized at base 128 with margin bits
    (|digit| <= 64), and the equal-weight pair groups stacked row-wise:
    group ``s = i + j`` multiplies the concatenated x planes ``[x_i ...]``
    against the row stack of the matching M planes in ONE int8 dot with
    exact int32 accumulation.  Returns ``gmats (sum_g m_g*K, 2*nb) int8``,
    the group schedule ``offsets`` (``(s, x_plane_ids, row_offset,
    row_span)`` tuples, ascending weight), and the tail arrays
    ``mixed_scale``, ``mask``, ``w_hi``, ``w_lo``, ``w_nyq`` and
    ``cos_scale``.
    """
    K = C.shape[0]
    n_x, n_m = _I8_X_DIGITS, _I8_M_DIGITS
    mats, tail = _combined_layout(C, S, W, n_m, _I8_BASE, margin=True)
    groups = []
    for s in range(n_x + n_m - 2, -1, -1):  # ascending weight
        if s > cutoff:
            continue
        members = [(i, s - i) for i in range(n_x) if 0 <= s - i < n_m]
        if members:
            groups.append((s, members))
    gmats = np.concatenate(
        [
            np.concatenate([mats[j] for (_, j) in mem], axis=0)
            for _, mem in groups
        ],
        axis=0,
    ).astype(np.int8)
    offsets = []
    off = 0
    for s, mem in groups:
        offsets.append((s, tuple(i for i, _ in mem), off, len(mem) * K))
        off += len(mem) * K
    return {"gmats": gmats, "offsets": tuple(offsets), **tail}


def fold_bank_to_weights(bank, dft_size: int, use_power: bool) -> np.ndarray:
    """Fold a bank's truncated responses into half-spectrum weights.

    Returns a float64 ``(dft_size // 2 + 1, num_filts)`` matrix ``W`` such
    that feature ``f`` of a frame equals ``sum_b W[b, f] * |X_b|^p`` with
    ``p = 2`` (power) or ``1`` (magnitude), reproducing the reference's
    truncated-response walk (reference: compute.py:416-460), including the
    factor of 2 applied to real banks for Hermitian symmetry.
    """
    half_len = dft_size // 2 + 1
    mod = half_len % 2
    p = 2 if use_power else 1
    half_positions = np.arange(half_len)
    weights = np.zeros((half_len, bank.num_filts), dtype=np.float64)
    for filt_idx in range(bank.num_filts):
        start_idx, truncated = bank.get_truncated_response(filt_idx, dft_size)
        magp = np.abs(truncated) ** p
        trunc_len = len(truncated)
        # emulate the reference's alternating direct/conjugate segment walk,
        # accumulating |H|^p at whichever half-spectrum bin each tap lands on
        consumed = 0
        conjugate = False
        while consumed < trunc_len:
            if conjugate:
                seg_len = (
                    min(start_idx + trunc_len - consumed, half_len - 2 + mod)
                    - start_idx
                )
                seg_len = max(0, seg_len)
                if seg_len:
                    bins = half_positions[
                        (-2 + mod - start_idx) : (-2 + mod - start_idx - seg_len) : -1
                    ]
                    np.add.at(
                        weights[:, filt_idx], bins, magp[consumed : consumed + seg_len]
                    )
                start_idx -= half_len - 2 + mod
            else:
                seg_len = min(start_idx + trunc_len - consumed, half_len) - start_idx
                seg_len = max(0, seg_len)
                if seg_len:
                    bins = half_positions[start_idx : start_idx + seg_len]
                    np.add.at(
                        weights[:, filt_idx], bins, magp[consumed : consumed + seg_len]
                    )
                start_idx -= half_len
            conjugate = not conjugate
            consumed += seg_len
            start_idx = max(0, start_idx)
    if bank.is_real:
        weights *= 2
    return weights


def windowed_dft_matrices(window: np.ndarray, dft_size: int):
    """Real cos/sin DFT matrices with the analysis window folded in.

    Returns float64 ``(frame_length, half_len)`` matrices ``C, S`` with
    ``Re X = x @ C`` and ``Im X = x @ S``.
    """
    frame_length = len(window)
    half_len = dft_size // 2 + 1
    t = np.arange(frame_length, dtype=np.float64)[:, None]
    b = np.arange(half_len, dtype=np.float64)[None, :]
    ang = 2 * np.pi * t * b / dft_size
    C = np.cos(ang) * window[:, None]
    S = -np.sin(ang) * window[:, None]
    return C, S


# --- device path (torch) -----------------------------------------------------


# the flags of the float32 modes are process-global: blocks of one mode that
# overlap in different threads (a serving thread beside a training loop)
# share one setting, made on the first entry and given back on the last
# exit; a block of the other mode waits until every open block has exited
_FLOAT32_MODES = {
    # mode: (float32_matmul_precision, cudnn.allow_tf32, cudnn.deterministic),
    # None keeping the caller's setting
    "ieee": ("highest", False, True),
    "tf32": ("high", None, None),
}
_MODE_CHANGE = threading.Condition()
_mode = None  # the mode of the open blocks
_mode_depth = 0
_mode_saved = None
_mode_local = threading.local()  # this thread's open blocks (mode, depth)


@contextlib.contextmanager
def float32_mode(mode: str):
    """Run the block's float32 products and convolutions in ``mode``:
    ``"ieee"`` (IEEE float32, TF32 off for matmuls and cuDNN, and cuDNN's
    deterministic algorithms: with TF32 off it would otherwise pick a
    weight-gradient algorithm that sums with atomics, so that two equal
    training steps differ) or ``"tf32"`` (TF32 matmuls, cuDNN left as the
    caller set it); the caller's settings come back after the block.

    The flags are process-global, so blocks share them across threads:
    the first block to enter saves the caller's settings and sets the
    mode, nested and overlapping blocks of the same mode (in any thread)
    only count, and the last block to exit gives the saved settings back.
    A block of the other mode waits until every open block has exited, so
    no block runs under another block's mode.  Nesting a block of the
    other mode inside one of this thread's own blocks raises
    RuntimeError (it would wait on itself)."""
    global _mode, _mode_depth, _mode_saved
    matmul, cudnn_tf32, cudnn_deterministic = _FLOAT32_MODES[mode]
    held, held_depth = getattr(_mode_local, "held", (None, 0))
    if held_depth and held != mode:
        raise RuntimeError(f"a {mode!r} float32 block inside this thread's {held!r} block")
    with _MODE_CHANGE:
        while _mode_depth and _mode != mode:
            _MODE_CHANGE.wait()
        if _mode_depth == 0:
            _mode_saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
                           torch.backends.cudnn.deterministic)
            torch.set_float32_matmul_precision(matmul)
            if cudnn_tf32 is not None:
                torch.backends.cudnn.allow_tf32 = cudnn_tf32
            if cudnn_deterministic is not None:
                torch.backends.cudnn.deterministic = cudnn_deterministic
            _mode = mode
        _mode_depth += 1
    _mode_local.held = (mode, held_depth + 1)
    try:
        yield
    finally:
        _mode_local.held = (mode, held_depth) if held_depth else (None, 0)
        with _MODE_CHANGE:
            _mode_depth -= 1
            if _mode_depth == 0:
                torch.set_float32_matmul_precision(_mode_saved[0])
                torch.backends.cudnn.allow_tf32 = _mode_saved[1]
                torch.backends.cudnn.deterministic = _mode_saved[2]
                _mode, _mode_saved = None, None
                _MODE_CHANGE.notify_all()


def ieee_float32():
    """Turn TF32 off for the float32 products and convolutions inside the
    block, and give the caller's settings back after it:
    :func:`float32_mode` ``("ieee")``.

    The port's float32 contract is IEEE float32 (the reference's
    'highest'); TF32 keeps about three decimal digits.  Wrapped around
    every feature computation rather than set once at import, so that a
    caller who turns TF32 on for their own model keeps it there and cannot
    change the features.  Safe across threads (see :func:`float32_mode`):
    no block's exit can turn TF32 on under another block that is still
    running."""
    return float32_mode("ieee")


def _resolve_fft_mode(mode: Optional[str], dft_size: int) -> str:
    if mode is None or mode == "auto":
        mode = _config.FFT_MODE
    if mode == "auto":
        mode = "matmul" if dft_size <= 4096 else "fft"
    return mode


def power_half_spectrum(frames, params, dft_size: int, fft_mode: Optional[str]):
    """``|X_b|^2`` over the half spectrum of raw (unwindowed) frames
    ``(..., frame_length)``."""
    mode = _resolve_fft_mode(fft_mode, dft_size)
    if mode == "fft":
        spect = torch.fft.rfft(frames * params["window"], n=dft_size, dim=-1)
        return spect.real**2 + spect.imag**2
    re = torch.matmul(frames, params["dft_cos"])
    im = torch.matmul(frames, params["dft_sin"])
    return re * re + im * im


def _digitize_frames(x):
    """(..., K) float32 -> (..., _X_DIGITS * K) stacked digit planes + po2
    scale.  Every step is exact in float32."""
    m = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    _, e = torch.frexp(torch.clamp_min(m, 1e-30))
    scale = torch.ldexp(torch.ones_like(m), e)
    v = x / scale
    planes = []
    for _ in range(_X_DIGITS):
        d = torch.round(v * _DIGIT_BASE)  # half to even, as jnp.round
        v = v * _DIGIT_BASE - d
        planes.append(d)
    return torch.cat(planes, dim=-1), scale


def _digit_feats(frames, params, use_power: bool, dft_size: int):
    """The exact digit tier: grouped integer-digit matmuls for the DFT
    (exact in float32: integer products, sums below 2^24) plus an
    operand-split (hi + lo) filter-weight matmul."""
    half = dft_size // 2 + 1
    X, scale = _digitize_frames(frames)
    mats = params["dft_group_mats"]  # (G, n_x*K, half + n_im) float32
    gw = params["dft_group_weights"]
    n_im = mats.shape[-1] - half
    acc = None
    for g in range(mats.shape[0]):
        term = torch.matmul(X, mats[g]) * gw[g]  # exact pass, po2 weight
        acc = term if acc is None else acc + term
    re = acc[..., :half] * (scale * params["dft_cos_scale"])
    im_mid = acc[..., half:] * (scale * params["dft_sin_scale"])
    power = re * re
    power[..., 1 : 1 + n_im] += im_mid * im_mid
    spec = power if use_power else torch.sqrt(power)
    return torch.matmul(spec, params["weights"]) + torch.matmul(
        spec, params["weights_lo"]
    )


def _matmul_feats_nyquist_split(frames, params, use_power: bool):
    """Matmul-mode features with the Nyquist bin as a rank-1 correction
    (its imaginary part is identically zero for even DFT sizes)."""
    cos, sin, w = params["dft_cos"], params["dft_sin"], params["weights"]
    re = torch.matmul(frames, cos[:, :-1])
    im = torch.matmul(frames, sin[:, :-1])
    power = re * re + im * im
    spec = power if use_power else torch.sqrt(power)
    feats = torch.matmul(spec, w[:-1])
    x_nyq = torch.matmul(frames, cos[:, -1:])
    nyq = x_nyq * x_nyq if use_power else torch.abs(x_nyq)
    return feats + nyq * w[-1]


def floor_log(feats, log_floor: float):
    """``log(max(feats, log_floor))``."""
    return torch.log(torch.clamp_min(feats, log_floor))


def frame_energy(frames, *, use_log: bool, use_power: bool, log_floor: float):
    """The energy coefficient of raw frames ``(..., K)``: mean square, its
    root for magnitude features, then the log floor."""
    energy = torch.sum(frames * frames, dim=-1) / frames.shape[-1]
    if not use_power:
        energy = torch.sqrt(energy)
    if use_log:
        energy = floor_log(energy, log_floor)
    return energy


def stft_feats_from_frames(
    frames,
    params,
    *,
    dft_size: int,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
    fft_mode: Optional[str] = None,
    precision: Optional[str] = None,
):
    """Features for a batch of raw frames ``(..., frame_length)``; returns
    ``(..., num_coeffs)``.

    Pipeline: [energy from raw frame] ; window -> rDFT -> |.|^2 -> [sqrt
    for magnitude mode] -> matmul with folded filter weights -> [log
    floor].  The float tiers 'highest', 'high' and 'default' all compute in
    IEEE float32 (or float64) here.
    """
    mode = _resolve_fft_mode(fft_mode, dft_size)
    with ieee_float32():
        if precision in ("double", "accurate"):
            feats = _digit_feats(frames, params, use_power, dft_size)
        elif mode != "fft" and dft_size % 2 == 0:
            feats = _matmul_feats_nyquist_split(frames, params, use_power)
        else:
            power_spec = power_half_spectrum(frames, params, dft_size, fft_mode)
            spec = power_spec if use_power else torch.sqrt(power_spec)
            feats = torch.matmul(spec, params["weights"])
    if use_log:
        feats = floor_log(feats, log_floor)
    if include_energy:
        energy = frame_energy(
            frames, use_log=use_log, use_power=use_power, log_floor=log_floor
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats
