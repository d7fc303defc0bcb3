"""Fused STFT -> features kernels: wrappers around the hand-written CUDA
kernels of ``csrc/stft_kernels.cu``, each beside its plain PyTorch version.

The counterpart of :mod:`speech_tpu.ops.pallas_stft`:

- :func:`stft_feats_rows` replaces ``stft_feats_pallas`` (``_rows_kernel``
  + ``_feats_from_pieces``): padded signal rows to features, frames never
  materialised.
- :func:`stft_feats_frames` replaces ``stft_feats_pallas_from_frames``
  (``_frames_kernel``): the same fused tail on materialised frames.
- :func:`stft_feats_int8` replaces ``stft_feats_pallas_int8``
  (``_int8_rows_kernel``): the exact digit tiers 'double' and 'accurate'.

Every wrapper casts its inputs as the JAX function does, checks device,
dtype, shape and contiguity, and then runs its plain version for CPU
tensors or launches its kernel on the current CUDA stream for CUDA tensors
(raising if the launch fails).  It never falls back from the card to a
plain version.  Each wrapper counts its launches in ``.launches``.

The float kernel computes every precision tier ('highest', 'high',
'default') in IEEE fp32; the TPU's bf16 tiers have no counterpart yet.
"""

import ctypes
import functools
import weakref
from typing import Optional

import torch

from . import _build
from .framing import frame_padded
from .stft import floor_log, frame_energy, ieee_float32, _I8_BASE, _I8_X_DIGITS

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "stft_feats_frames",
    "stft_feats_frames_plain",
    "stft_feats_int8",
    "stft_feats_int8_plain",
    "stft_feats_rows",
    "stft_feats_rows_plain",
]

_FLOAT_PRECISIONS = (None, "highest", "high", "default")

_c_int_p = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "stk_float_feats": [
        ctypes.c_void_p,  # x
        ctypes.c_longlong,  # batch
        ctypes.c_longlong,  # row_stride
        ctypes.c_longlong,  # n_valid
        ctypes.c_int,  # frame_stride
        ctypes.c_int,  # num_frames
        ctypes.c_int,  # K
        ctypes.c_int,  # half
        ctypes.c_int,  # C
        ctypes.c_void_p,  # cos
        ctypes.c_void_p,  # sin
        ctypes.c_void_p,  # weights
        ctypes.c_void_p,  # out
        ctypes.c_int,  # use_log
        ctypes.c_int,  # use_power
        ctypes.c_int,  # energy
        ctypes.c_float,  # log_floor
        ctypes.c_void_p,  # stream
    ],
    "stk_int8_feats": [
        ctypes.c_void_p,  # x
        ctypes.c_longlong,  # batch
        ctypes.c_longlong,  # row_stride
        ctypes.c_longlong,  # n_valid
        ctypes.c_int,  # frame_shift
        ctypes.c_int,  # num_frames
        ctypes.c_int,  # K
        ctypes.c_int,  # nb
        ctypes.c_int,  # C
        ctypes.c_void_p,  # g4
        ctypes.c_int,  # n_groups
        _c_int_p,  # members
        _c_int_p,  # xs
        _c_int_p,  # row4
        _c_int_p,  # s
        ctypes.c_float,  # cos_scale
        ctypes.c_void_p,  # mixed_scale
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # w_hi
        ctypes.c_void_p,  # w_lo
        ctypes.c_void_p,  # w_nyq
        ctypes.c_void_p,  # out
        ctypes.c_int,  # use_log
        ctypes.c_int,  # use_power
        ctypes.c_int,  # energy
        ctypes.c_float,  # log_floor
        ctypes.c_void_p,  # stream
    ],
}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load_kernels()["stft_kernels"]
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.stk_error_string.argtypes = [ctypes.c_int]
    lib.stk_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, name: str):
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed ({rc}): "
            + lib.stk_error_string(rc).decode(errors="replace")
        )


def _check_cuda(ref, **tensors):
    """Every tensor on ``ref``'s CUDA device and contiguous."""
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(
                f"{name} is on {t.device}, the signal on {ref.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_precision(precision):
    if precision not in _FLOAT_PRECISIONS:
        raise ValueError(f"Invalid float kernel precision: {precision!r}")


def _float_consts(params):
    return (
        params["dft_cos"].to(torch.float32),
        params["dft_sin"].to(torch.float32),
        params["weights"].to(torch.float32),
    )


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- B1 / B3: the fused float pipeline ---------------------------------------


def stft_feats_frames_plain(
    frames,
    params,
    *,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
    precision: Optional[str] = None,
):
    """Plain version of :func:`stft_feats_frames`, step by step: re/im by
    matmul against the window-folded DFT matrices, |X|^2 (root for
    magnitude), the folded filter weights, log floor, energy first."""
    _check_precision(precision)
    frames = frames.to(torch.float32)
    cos, sin, weights = _float_consts(params)
    with ieee_float32():
        re = torch.matmul(frames, cos)
        im = torch.matmul(frames, sin)
        power = re * re + im * im
        spec = power if use_power else torch.sqrt(power)
        feats = torch.matmul(spec, weights)
    if use_log:
        feats = floor_log(feats, log_floor)
    if include_energy:
        energy = frame_energy(
            frames, use_log=use_log, use_power=use_power, log_floor=log_floor
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


def stft_feats_frames(
    frames,
    params,
    *,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
    precision: Optional[str] = None,
):
    """Fused features for raw frames ``(batch, num_frames, frame_length)``
    -> ``(batch, num_frames, num_coeffs)`` float32.

    Replaces ``speech_tpu/ops/pallas_stft.py:stft_feats_pallas_from_frames``
    (``_frames_kernel``).  Bound on an H100: the fp32 FMAs of the two DFT
    products (``2*F*K*half*2`` operations against the 67 TFLOP/s fp32
    rate); the frames themselves are read once.  Design: one block per
    (row, tile of frames) stages the tile in shared memory and keeps its
    spectrum there for the filter product, so only features reach device
    memory.
    """
    _check_precision(precision)
    frames = frames.to(torch.float32)
    if frames.dim() != 3:
        raise ValueError(f"frames must be (batch, frames, K), got {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        return stft_feats_frames_plain(
            frames,
            params,
            use_log=use_log,
            use_power=use_power,
            include_energy=include_energy,
            log_floor=log_floor,
            precision=precision,
        )
    cos, sin, weights = _float_consts(params)
    batch, num_frames, frame_length = frames.shape
    _check_cuda(frames, frames=frames, dft_cos=cos, dft_sin=sin, weights=weights)
    return _launch_float(
        frames,
        cos,
        sin,
        weights,
        batch=batch,
        row_stride=num_frames * frame_length,
        n_valid=num_frames * frame_length,
        frame_stride=frame_length,
        num_frames=num_frames,
        frame_length=frame_length,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=log_floor,
        counted=stft_feats_frames,
    )


def stft_feats_rows_plain(
    padded,
    params,
    *,
    num_frames: int,
    frame_length: int,
    frame_shift: int,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
    precision: Optional[str] = None,
):
    """Plain version of :func:`stft_feats_rows`: frame the rows, then
    :func:`stft_feats_frames_plain`."""
    frames = frame_padded(
        padded.to(torch.float32), num_frames, frame_length, frame_shift
    )
    return stft_feats_frames_plain(
        frames,
        params,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=log_floor,
        precision=precision,
    )


def stft_feats_rows(
    padded,
    params,
    *,
    num_frames: int,
    frame_length: int,
    frame_shift: int,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
    precision: Optional[str] = None,
):
    """Fused features for padded signals ``(batch, padded_len)`` ->
    ``(batch, num_frames, num_coeffs)`` float32; frame ``k`` of a row is
    samples ``[k*frame_shift, k*frame_shift + frame_length)`` and samples
    past the row's end read as zero.

    Replaces ``speech_tpu/ops/pallas_stft.py:stft_feats_pallas``
    (``_rows_kernel`` + ``_feats_from_pieces``).  Bound on an H100: the
    fp32 FMAs of the two DFT products, ``2*F*(2*K*half + half*C)``
    operations against the 67 TFLOP/s fp32 rate (about 1.2 ms at 128 x
    15 s); its bytes, the signal read once and the features written once,
    take some 0.05 ms.  Design: one block per (row, tile of frames) stages
    ``(tile-1)*shift + K`` samples in shared memory, so frames never reach
    device memory, and keeps the tile's spectrum in shared memory for the
    filter product.  Any frame shift works; the TPU's ``shift % 8`` gate
    does not apply.
    """
    _check_precision(precision)
    padded = padded.to(torch.float32)
    if padded.dim() != 2:
        raise ValueError(f"padded must be (batch, samples), got {tuple(padded.shape)}")
    if padded.device.type == "cpu":
        return stft_feats_rows_plain(
            padded,
            params,
            num_frames=num_frames,
            frame_length=frame_length,
            frame_shift=frame_shift,
            use_log=use_log,
            use_power=use_power,
            include_energy=include_energy,
            log_floor=log_floor,
            precision=precision,
        )
    cos, sin, weights = _float_consts(params)
    if cos.shape[0] != frame_length:
        raise ValueError(f"dft_cos has {cos.shape[0]} rows, frame_length is {frame_length}")
    _check_cuda(padded, padded=padded, dft_cos=cos, dft_sin=sin, weights=weights)
    return _launch_float(
        padded,
        cos,
        sin,
        weights,
        batch=padded.shape[0],
        row_stride=padded.shape[1],
        n_valid=padded.shape[1],
        frame_stride=frame_shift,
        num_frames=num_frames,
        frame_length=frame_length,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=log_floor,
        counted=stft_feats_rows,
    )


def _launch_float(
    x, cos, sin, weights, *, batch, row_stride, n_valid, frame_stride,
    num_frames, frame_length, use_log, use_power, include_energy, log_floor,
    counted,
):
    half = cos.shape[1]
    if sin.shape != cos.shape or weights.shape[0] != half:
        raise ValueError("dft_cos, dft_sin and weights disagree in shape")
    out = torch.empty(
        (batch, num_frames, weights.shape[1] + int(include_energy)),
        dtype=torch.float32,
        device=x.device,
    )
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.stk_float_feats(
            x.data_ptr(), batch, row_stride, n_valid, frame_stride, num_frames,
            frame_length, half, weights.shape[1], cos.data_ptr(), sin.data_ptr(),
            weights.data_ptr(), out.data_ptr(), int(use_log), int(use_power),
            int(include_energy), float(log_floor), _stream(x),
        )
    _raise_on(lib, rc, counted.__name__)
    counted.launches += 1
    return out


# --- B2: the int8 digit tiers --------------------------------------------------


def _int8_tail(acc, scale, params, *, use_power: bool):
    """Digit-tier spectrum -> filter features: rescale, the power
    spectrum with the Nyquist value in the sin block's DC slot, the
    hi/lo-split weights and the rank-1 Nyquist term."""
    mask = params["i8k_mask"]
    nb = mask.shape[0]
    re = acc[..., :nb] * (scale * params["i8k_cos_scale"])
    mixed = acc[..., nb:] * (scale * params["i8k_mixed_scale"])
    im = mixed * mask
    power = re * re + im * im
    spec = power if use_power else torch.sqrt(power)
    nyq = mixed - im
    nyq_spec = nyq * nyq if use_power else torch.abs(nyq)
    return (
        torch.matmul(spec, params["i8k_w_hi"])
        + torch.matmul(spec, params["i8k_w_lo"])
        + nyq_spec[..., 0:1] * params["i8k_w_nyq"][0:1]
    )


def stft_feats_int8_plain(
    padded,
    params,
    *,
    num_frames: int,
    frame_length: int,
    frame_shift: int,
    dft_size: int,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
):
    """Plain version of :func:`stft_feats_int8`, step by step.  Each group
    dot runs in float64, where every sum (at most ``5*K*64^2``) is exact,
    and converts to int64: the same integers as the kernel's int32 dots."""
    frames = frame_padded(
        padded.to(torch.float32), num_frames, frame_length, frame_shift
    )
    m = torch.clamp_min(torch.amax(torch.abs(frames), dim=-1, keepdim=True), 1e-30)
    bits = m.contiguous().view(torch.int32)
    scale = (((bits >> 23) + 2) << 23).view(torch.float32)
    v = frames * (1.0 / scale)
    planes = []
    for _ in range(_I8_X_DIGITS):
        d = torch.round(v * _I8_BASE)  # half to even, as jnp.round
        v = v * _I8_BASE - d
        planes.append(d)
    gmats = params["i8k_gmats"]
    acc = None
    for s, xs, off, span in params["i8k_offsets"]:
        xg = torch.cat([planes[i] for i in xs], dim=-1).to(torch.float64)
        t = torch.matmul(xg, gmats[off : off + span].to(torch.float64))
        t = t.to(torch.int64)
        t_lo = t & 4095
        t_hi = t - t_lo
        w = _I8_BASE ** -(s + 2)
        term = t_hi.to(torch.float32) * w + t_lo.to(torch.float32) * w
        acc = term if acc is None else acc + term
    with ieee_float32():
        feats = _int8_tail(acc, scale, params, use_power=use_power)
    if use_log:
        feats = floor_log(feats, log_floor)
    if include_energy:
        energy = frame_energy(
            frames, use_log=use_log, use_power=use_power, log_floor=log_floor
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


def _pack_groups(gmats, offsets, frame_length: int):
    """The grouped digit matrices packed for ``__dp4a``: each member block
    padded to ``K16 = round_up(K, 16)`` rows, four consecutive rows to an
    int32 (lowest row in the lowest byte), shape ``(rows4, 2*nb)``; plus
    the group table as ctypes arrays."""
    nb2 = gmats.shape[1]
    k16 = -(-frame_length // 16) * 16
    blocks, members, xs_flat, row4, svals = [], [], [], [], []
    row = 0
    for s, xs, off, span in offsets:
        m = len(xs)
        blk = gmats[off : off + span].reshape(m, frame_length, nb2)
        if k16 != frame_length:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, k16 - frame_length))
        blk = blk.reshape(m, k16 // 4, 4, nb2).permute(0, 1, 3, 2).contiguous()
        blocks.append(blk.view(torch.int32).reshape(m * k16 // 4, nb2))
        members.append(m)
        xs_flat.extend(list(xs) + [0] * (_I8_X_DIGITS - m))
        row4.append(row)
        svals.append(s)
        row += m * k16 // 4

    def ints(vals):
        return (ctypes.c_int * len(vals))(*vals)

    return torch.cat(blocks), (
        len(members), ints(members), ints(xs_flat), ints(row4), ints(svals)
    )


_PACKED = {}  # id(gmats) -> (weakref to gmats, key, packed layout)


def _packed_groups(gmats, offsets, frame_length: int):
    """:func:`_pack_groups`, once per gmats tensor: the layout is kept
    while the tensor lives and is unchanged (same version, schedule and
    frame length), so a launch only reads it."""
    key = (gmats._version, tuple(offsets), frame_length)
    hit = _PACKED.get(id(gmats))
    if hit is not None and hit[0]() is gmats and hit[1] == key:
        return hit[2]
    packed = _pack_groups(gmats, offsets, frame_length)
    slot = id(gmats)
    ref = weakref.ref(gmats, lambda r: _PACKED.pop(slot, None))
    _PACKED[slot] = (ref, key, packed)
    return packed


def stft_feats_int8(
    padded,
    params,
    *,
    num_frames: int,
    frame_length: int,
    frame_shift: int,
    dft_size: int,
    use_log: bool,
    use_power: bool,
    include_energy: bool,
    log_floor: float,
):
    """Fused int8 digit-tier features for padded signals ``(batch,
    padded_len)`` -> ``(batch, num_frames, num_coeffs)`` float32.  The
    pair schedule ('double' or 'accurate') comes from
    ``params["i8k_offsets"]``.

    Replaces ``speech_tpu/ops/pallas_stft.py:stft_feats_pallas_int8``
    (``_int8_rows_kernel``).  Bound on an H100: the int8 products,
    ``2*F*K*2nb`` per kept digit pair (19 pairs for 'double'), against the
    1,979 TOP/s int8 tensor-core rate.  Design: one block per (row, tile of
    frames) digitises its frames into shared memory and runs each
    equal-weight group as one exact int32 dot with ``__dp4a`` on the CUDA
    cores, so it runs well above that bound; the exactness (integer sums,
    the 12-bit split, the ascending fp32 adds) is the point of the tier.
    """
    padded = padded.to(torch.float32)
    if padded.dim() != 2:
        raise ValueError(f"padded must be (batch, samples), got {tuple(padded.shape)}")
    if "i8k_gmats" not in params:
        raise ValueError(
            "params carry no int8 kernel layout (needs precision 'double' "
            "or 'accurate' and dft_size % 4 == 0)"
        )
    nb = params["i8k_mask"].shape[0]
    if nb != dft_size // 2:
        raise ValueError(f"int8 layout has nb={nb}, dft_size is {dft_size}")
    if padded.device.type == "cpu":
        return stft_feats_int8_plain(
            padded,
            params,
            num_frames=num_frames,
            frame_length=frame_length,
            frame_shift=frame_shift,
            dft_size=dft_size,
            use_log=use_log,
            use_power=use_power,
            include_energy=include_energy,
            log_floor=log_floor,
        )
    gmats = params["i8k_gmats"]
    if gmats.dtype != torch.int8:
        raise ValueError(f"i8k_gmats must be int8, got {gmats.dtype}")
    tail = {
        k: params["i8k_" + k]
        for k in ("mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")
    }
    _check_cuda(padded, padded=padded, i8k_gmats=gmats, **tail)
    n_filts = tail["w_hi"].shape[1]
    out = torch.empty(
        (padded.shape[0], num_frames, n_filts + int(include_energy)),
        dtype=torch.float32,
        device=padded.device,
    )
    if out.numel() == 0:
        return out
    g4, (n_groups, members, xs, row4, svals) = _packed_groups(
        gmats, params["i8k_offsets"], frame_length
    )
    lib = _lib()
    with torch.cuda.device(padded.device):
        rc = lib.stk_int8_feats(
            padded.data_ptr(), padded.shape[0], padded.shape[1], padded.shape[1],
            frame_shift, num_frames, frame_length, nb, n_filts, g4.data_ptr(),
            n_groups, members, xs, row4, svals,
            float(params["i8k_cos_scale"]), tail["mixed_scale"].data_ptr(),
            tail["mask"].data_ptr(), tail["w_hi"].data_ptr(), tail["w_lo"].data_ptr(),
            tail["w_nyq"].data_ptr(), out.data_ptr(), int(use_log), int(use_power),
            int(include_energy), float(log_floor), _stream(padded),
        )
    _raise_on(lib, rc, "stft_feats_int8")
    stft_feats_int8.launches += 1
    return out


KERNELS = (stft_feats_rows, stft_feats_frames, stft_feats_int8)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0
