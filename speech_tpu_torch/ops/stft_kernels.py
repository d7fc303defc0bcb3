"""Fused STFT -> features kernels: wrappers around the hand-written CUDA
kernels of ``csrc/*.cu``, each beside its plain PyTorch version.

The counterpart of :mod:`speech_tpu.ops.pallas_stft`:

- :func:`stft_feats_rows` replaces ``stft_feats_pallas`` (``_rows_kernel``
  + ``_feats_from_pieces``): padded signal rows to features, frames never
  materialised.
- :func:`stft_feats_frames` replaces ``stft_feats_pallas_from_frames``
  (``_frames_kernel``): the same fused tail on materialised frames.
- :func:`stft_feats_int8` replaces ``stft_feats_pallas_int8``
  (``_int8_rows_kernel``): the exact digit tiers 'double' and 'accurate',
  on the int8 tensor cores (``csrc/int8_kernels.cu``).
- :func:`stft_feats_double` replaces ``stft_feats_pallas_double``
  (``_double_rows_kernel``): the base-256 digit kernel, one dot per digit
  pair, on the bf16 tensor cores (``csrc/double_kernels.cu``).  No
  computer route runs it, as in the JAX package; it is public API on the
  ``pdk_*`` params.
- :func:`layout_rows` replaces no TPU kernel: it lays a packed batch (each
  row's real samples back to back, as ``ShardedExtractor`` sends them) out
  as the zero-padded ``(rows, max_len)`` block the computers take, on the
  card (``csrc/layout_kernels.cu``), so that the host writes and copies no
  padding.

Every wrapper casts its inputs as the JAX function does, checks device,
dtype, shape and contiguity, and then runs its plain version for CPU
tensors or launches its kernel on the current CUDA stream for CUDA tensors
(raising if the launch fails).  It never falls back from the card to a
plain version.  Each wrapper counts its launches in ``.launches``.

The float kernel runs its DFT products on the TF32 tensor cores: 'highest'
(and None) and 'high' as three passes over operands split ``hi + lo``
(about fp32 accuracy: the passes' tensor-core sums go to fp32 registers
after every 2 k-steps), 'default' as one TF32 pass (within the reference's
1.5e-2 of its reduced tier); its filter product is IEEE fp32 in every tier.
On the CPU every tier is IEEE fp32, as in JAX there.

Every kernel keeps fp32 filter sums of its block's frames in shared
memory.  Each splits a bank whose sums do not fit into filter groups (one
grid slice each, walking only the 64-bin chunks its filters touch), so
every kernel takes any bank; :func:`float_launch_plan`,
:func:`int8_launch_plan` and :func:`double_launch_plan` give the split.
"""

import ctypes
import functools
import weakref
from typing import Optional

import torch

from . import _build
from .. import aot as _aot
from .framing import frame_padded
from .stft import (
    _I8_BASE,
    _I8_X_DIGITS,
    _PDK_BASE,
    _PDK_CUTOFF,
    _PDK_X_DIGITS,
    digit_pair_schedule,
    floor_log,
    frame_energy,
    ieee_float32,
    stft_feats_from_frames,
)

__all__ = [
    "double_launch_plan",
    "float_launch_plan",
    "int8_launch_plan",
    "launch_counts",
    "layout_rows",
    "layout_rows_plain",
    "padded_need",
    "reset_launch_counts",
    "stft_feats_double",
    "stft_feats_double_plain",
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
        ctypes.c_int,  # nb
        ctypes.c_int,  # C
        ctypes.c_void_p,  # packed
        ctypes.c_int,  # steps
        ctypes.c_void_p,  # weights
        ctypes.c_void_p,  # spans
        ctypes.c_void_p,  # out
        ctypes.c_int,  # use_log
        ctypes.c_int,  # use_power
        ctypes.c_int,  # energy
        ctypes.c_float,  # log_floor
        ctypes.c_int,  # passes
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
        ctypes.c_void_p,  # packed
        ctypes.c_int,  # steps
        ctypes.c_int,  # n_groups
        _c_int_p,  # members
        _c_int_p,  # xs
        _c_int_p,  # s
        ctypes.c_float,  # cos_scale
        ctypes.c_void_p,  # mixed_scale
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # w_hi
        ctypes.c_void_p,  # w_lo
        ctypes.c_void_p,  # w_nyq
        ctypes.c_void_p,  # spans
        ctypes.c_void_p,  # out
        ctypes.c_int,  # use_log
        ctypes.c_int,  # use_power
        ctypes.c_int,  # energy
        ctypes.c_float,  # log_floor
        ctypes.c_void_p,  # stream
    ],
    "stk_double_feats": [
        ctypes.c_void_p,  # x
        ctypes.c_longlong,  # batch
        ctypes.c_longlong,  # row_stride
        ctypes.c_longlong,  # n_valid
        ctypes.c_int,  # frame_shift
        ctypes.c_int,  # num_frames
        ctypes.c_int,  # K
        ctypes.c_int,  # nb
        ctypes.c_int,  # C
        ctypes.c_void_p,  # packed
        ctypes.c_int,  # n_m
        ctypes.c_int,  # n_pairs
        _c_int_p,  # pair_i
        _c_int_p,  # pair_j
        ctypes.c_float,  # cos_scale
        ctypes.c_void_p,  # mixed_scale
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # w_hi
        ctypes.c_void_p,  # w_lo
        ctypes.c_void_p,  # w_nyq
        ctypes.c_void_p,  # spans
        ctypes.c_void_p,  # out
        ctypes.c_int,  # use_log
        ctypes.c_int,  # use_power
        ctypes.c_int,  # energy
        ctypes.c_float,  # log_floor
        ctypes.c_void_p,  # stream
    ],
    "stk_float_plan": [
        ctypes.c_int,  # frame_stride
        ctypes.c_int,  # K
        ctypes.c_int,  # C
        _c_int_p,  # plan
    ],
    "stk_double_plan": [
        ctypes.c_int,  # frame_shift
        ctypes.c_int,  # K
        ctypes.c_int,  # C
        _c_int_p,  # plan
    ],
    "stk_int8_plan": [
        ctypes.c_int,  # frame_shift
        ctypes.c_int,  # K
        ctypes.c_int,  # C
        _c_int_p,  # plan
    ],
    "stk_layout_rows": [
        ctypes.c_void_p,  # packed
        ctypes.c_longlong,  # packed_len
        ctypes.c_void_p,  # offsets
        ctypes.c_void_p,  # counts
        ctypes.c_longlong,  # rows
        ctypes.c_longlong,  # max_len
        ctypes.c_int,  # elem_bytes
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ],
}
# launcher -> the source (csrc/<stem>.cu) whose library exports it, beside
# that library's own stk_error_string
_LIBRARIES = {
    "stk_float_feats": "stft_kernels",
    "stk_int8_feats": "int8_kernels",
    "stk_double_feats": "double_kernels",
    "stk_float_plan": "stft_kernels",
    "stk_double_plan": "double_kernels",
    "stk_int8_plan": "int8_kernels",
    "stk_layout_rows": "layout_kernels",
}


def _launcher(name: str):
    """``(launch, error_string)`` for the C launcher ``name`` from the
    active store (:func:`speech_tpu_torch.aot.active_store`), with its
    ctypes signature set."""
    return _bound(name, _aot.active_store())


@functools.lru_cache(maxsize=None)
def _bound(name: str, store):
    """:func:`_launcher` of ``name`` from ``store``: each store is asked
    for its libraries once, so it receives (or serves) every one."""
    lib = _build.load_kernels(store)[_LIBRARIES[name]]
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    err = lib.stk_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(name: str, wrapper: str, *args):
    """Call the C launcher ``name``; raise if it reports an error."""
    fn, err = _launcher(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{wrapper} launch failed ({rc}): " + err(rc).decode(errors="replace")
        )


_PLAN_KEYS = ("groups", "group_filters", "stages", "span")


def _plan(
    name: str, device, frame_shift: int, frame_length: int, n_filts: int,
    keys=_PLAN_KEYS,
) -> dict:
    """The launch shape the C launcher's own search settles on ``device``:
    ``groups`` of at most ``group_filters`` filters, ``stages`` of the ring,
    ``span`` (the samples staged once, else slabs or device memory), and
    any further ``keys`` the launcher reports.  The launchers take the
    fewest filter groups whose sums fit in shared memory (one up to some
    hundred filters, so the main path's 40 take one), and raise only where
    not even one filter fits."""
    fn, err = _launcher(name)
    plan = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        rc = fn(frame_shift, frame_length, n_filts, plan)
    if rc != 0:
        raise RuntimeError(f"{name} failed ({rc}): " + err(rc).decode(errors="replace"))
    return dict(zip(keys, plan))


def float_launch_plan(device, *, frame_shift: int, frame_length: int, n_filts: int) -> dict:
    """:func:`_plan` of :func:`stft_feats_rows` (``frame_shift`` is the
    frame stride; :func:`stft_feats_frames` passes ``frame_length``)."""
    return _plan("stk_float_plan", device, frame_shift, frame_length, n_filts)


def double_launch_plan(device, *, frame_shift: int, frame_length: int, n_filts: int) -> dict:
    """:func:`_plan` of :func:`stft_feats_double`."""
    return _plan("stk_double_plan", device, frame_shift, frame_length, n_filts)


def int8_launch_plan(device, *, frame_shift: int, frame_length: int, n_filts: int) -> dict:
    """:func:`_plan` of :func:`stft_feats_int8`, with ``tile`` (frames a
    block: 64, 32 or 16) and ``slab`` (k-steps of 32 samples of digit
    planes a block holds: all of ``ceil(frame_length / 32)`` unless the
    planes are cut into slabs).  One group holds 1,488 filters at K 400 on
    an H100."""
    return _plan(
        "stk_int8_plan", device, frame_shift, frame_length, n_filts,
        keys=_PLAN_KEYS + ("tile", "slab"),
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


# --- per-tensor layouts, built once ------------------------------------------


def _filter_spans(w_hi, w_lo=None):
    """``(C, 2)`` int32: each filter's first and one-past-last row with a
    nonzero ``w_hi`` (or ``w_lo``, where given) weight (empty as ``(nb,
    0)``).  The kernels' filter sums skip the rows outside, whose terms are
    exact zeros."""
    nz = w_hi != 0 if w_lo is None else (w_hi != 0) | (w_lo != 0)
    rows = torch.arange(nz.shape[0], device=nz.device)[:, None]
    first = torch.where(nz, rows, nz.shape[0]).amin(0)
    last = torch.where(nz, rows + 1, 0).amax(0)
    return torch.stack([first, last], dim=1).to(torch.int32).contiguous()


_PACKED = {}  # id(gmats, dft_cos or pdk_mats) -> (weakref to it, key, packed layout)
_SPANS = {}  # id(w_hi or weights) -> (weakref to it, key, filter spans)


def _cached(cache, tensor, key, build):
    """``build()`` once per ``tensor``: the value is kept in ``cache`` while
    the tensor lives and ``key`` (its version and what else the value
    depends on) is unchanged, so a launch only reads it."""
    slot = id(tensor)
    hit = cache.get(slot)
    if hit is not None and hit[0]() is tensor and hit[1] == key:
        return hit[2]
    value = build()
    cache[slot] = (weakref.ref(tensor, lambda r: cache.pop(slot, None)), key, value)
    return value


def _digit_spans(w_hi, w_lo):
    """:func:`_filter_spans` of a digit layout's split weights, once per
    w_hi tensor (same version, same w_lo at the same version)."""
    return _cached(
        _SPANS, w_hi, (w_hi._version, id(w_lo), w_lo._version),
        lambda: _filter_spans(w_hi, w_lo),
    )


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
    (``_frames_kernel``).  The kernel of :func:`stft_feats_rows` with a
    frame stride of ``K``: the frames overlap nothing, so its blocks stage
    slabs of ``K`` of each frame in shared memory.  ``precision`` picks the
    tensor-core passes as there.
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
        precision=precision,
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
    (``_rows_kernel`` + ``_feats_from_pieces``).  Bound on an H100: the DFT
    products, ``passes * 2*F*K*2nb`` operations against the 495 TFLOP/s
    dense TF32 rate (3 passes for 'highest' and 'high', 1 for 'default'),
    plus the fp32 filter product ``2*F*half*C`` at 67 TFLOP/s; its bytes,
    the signal read once and the features written once, take some 0.05 ms.
    Design (``csrc/stft_kernels.cu``): one block per (row, 128 frames)
    stages ``127*shift + K`` samples in shared memory (slabs of ``K`` of
    each frame where that does not fit), so frames never reach device
    memory; two warpgroups run ``wgmma`` TF32 products with the frames in
    registers (split there for 3 passes) and the DFT operand of
    :func:`_pack_float` streaming through a shared-memory ring, one 64-bin
    chunk of (cos, sin) columns at a time; each chunk's spectrum stays in
    shared memory for the filter sums over each filter's nonzero rows.  A
    bank whose filter sums do not fit beside the ring and the samples (some
    290 filters at K 400) runs in filter groups, one grid slice each.  Any
    frame shift and ``K`` work; the TPU's ``shift % 8`` gate does not
    apply.
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
        precision=precision,
        counted=stft_feats_rows,
    )


def _launch_float(
    x, cos, sin, weights, *, batch, row_stride, n_valid, frame_stride,
    num_frames, frame_length, use_log, use_power, include_energy, log_floor,
    precision, counted,
):
    half = cos.shape[1]
    if sin.shape != cos.shape or weights.shape[0] != half:
        raise ValueError("dft_cos, dft_sin and weights disagree in shape")
    if cos.shape[0] != frame_length:
        raise ValueError(f"dft_cos has {cos.shape[0]} rows, frame_length is {frame_length}")
    out = torch.empty(
        (batch, num_frames, weights.shape[1] + int(include_energy)),
        dtype=torch.float32,
        device=x.device,
    )
    if out.numel() == 0:
        return out
    packed, nb, steps = _packed_float(cos, sin)
    spans = _cached(_SPANS, weights, weights._version, lambda: _filter_spans(weights))
    with torch.cuda.device(x.device):
        _launch(
            "stk_float_feats", counted.__name__,
            x.data_ptr(), batch, row_stride, n_valid, frame_stride, num_frames,
            frame_length, half, nb, weights.shape[1], packed.data_ptr(), steps,
            weights.data_ptr(), spans.data_ptr(), out.data_ptr(), int(use_log),
            int(use_power), int(include_energy), float(log_floor),
            _float_passes(precision), _stream(x),
        )
    counted.launches += 1
    return out


_F_STEP_K = 8  # k rows of one TF32 tensor-core product
_F_STAGE_STEPS = 2  # k-steps a ring stage: the packing pads to a multiple
_F_CHUNK_BINS = 64  # bins per column chunk


def _float_passes(precision) -> int:
    """Tensor-core passes of a float tier: 3 (split operands, about fp32)
    for 'highest', None and 'high'; 1 (TF32) for 'default'."""
    _check_precision(precision)
    return 1 if precision == "default" else 3


def _tf32(x):
    """``x`` rounded to TF32 (10 stored mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: float32 whose 13 low bits
    are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _float_nb(cos, sin) -> int:
    """Bins with a column pair in the float layout: ``half - 1`` where the
    last bin is a Nyquist bin (even DFT size: its sin column is zero but
    for the float64 rounding of ``-sin(pi t)``, some 1e-14 of the window,
    which the layout drops as the plain path's Nyquist split does), else
    ``half`` (odd size: every sin column is real)."""
    half = cos.shape[1]
    if half < 2:
        return half
    nyq = bool(sin[:, -1].abs().max() <= 2.0**-30 * cos[:, -1].abs().max())
    return half - 1 if nyq else half


def _pack_float(cos, sin):
    """The window-folded DFT matrices packed for the TF32 tensor-core
    kernel, split ``hi + lo``.

    Returns ``(packed, nb, steps)``: ``packed`` is float32 ``(chunks,
    steps, 2, 16, 2, 8, 4)`` with ``chunks = ceil(nb / 64)``: [chunk][k-step]
    [hi, lo][column group][k half][column in group][k in half], so each
    k-step's hi and lo are 16 x 2 core matrices (8 columns x 4 k, 16 bytes
    a column) in the K-major layout the tensor cores read from shared
    memory.  Chunk ``c``'s column ``2i`` is the cos column and ``2i + 1``
    the mixed column of bin ``64c + i``: the sin column, but at bin 0 (whose
    sin column is zero) the Nyquist cos column where there is one (see
    :func:`_float_nb`), else zero.  ``hi = tf32(v)`` and ``lo = tf32(v -
    hi)``.  K-step ``u`` holds rows ``[8u, 8u + 8)``, zero past ``K``;
    ``steps = ceil(K / 8)`` rounded up to even; columns past ``nb`` are
    zero."""
    K, half = cos.shape
    nb = _float_nb(cos, sin)
    chunks = -(-nb // _F_CHUNK_BINS)
    steps = -(-K // (_F_STEP_K * _F_STAGE_STEPS)) * _F_STAGE_STEPS
    nyq = cos[:, nb:] if nb < half else torch.zeros_like(cos[:, :1])
    mixed = torch.cat([nyq, sin[:, 1:nb]], dim=1)
    cols = torch.stack([cos[:, :nb], mixed], dim=-1).reshape(K, 2 * nb)
    cols = torch.nn.functional.pad(
        cols, (0, 2 * (chunks * _F_CHUNK_BINS - nb), 0, steps * _F_STEP_K - K)
    )
    hi = _tf32(cols)
    lo = _tf32(cols - hi)
    packed = (
        torch.stack([hi, lo])
        .reshape(2, steps, 2, 4, chunks, 2 * _F_CHUNK_BINS // 8, 8)
        .permute(4, 1, 0, 5, 2, 6, 3)
        .contiguous()
    )
    return packed, nb, steps


def _packed_float(cos, sin):
    """:func:`_pack_float`, once per dft_cos tensor (same version, same
    dft_sin at the same version)."""
    key = (cos._version, id(sin), sin._version)
    return _cached(_PACKED, cos, key, lambda: _pack_float(cos, sin))


# --- B2: the int8 digit tiers --------------------------------------------------


def _digit_tail(acc, scale, params, prefix: str, *, use_power: bool):
    """Digit-kernel spectrum -> filter features on the ``prefix`` layout
    ('i8k_' or 'pdk_'): rescale, the power spectrum with the Nyquist value
    in the sin block's DC slot, the hi/lo-split weights and the rank-1
    Nyquist term."""
    mask = params[prefix + "mask"]
    nb = mask.shape[0]
    re = acc[..., :nb] * (scale * params[prefix + "cos_scale"])
    mixed = acc[..., nb:] * (scale * params[prefix + "mixed_scale"])
    im = mixed * mask
    power = re * re + im * im
    spec = power if use_power else torch.sqrt(power)
    nyq = mixed - im
    nyq_spec = nyq * nyq if use_power else torch.abs(nyq)
    return (
        torch.matmul(spec, params[prefix + "w_hi"])
        + torch.matmul(spec, params[prefix + "w_lo"])
        + nyq_spec[..., 0:1] * params[prefix + "w_nyq"][0:1]
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
        feats = _digit_tail(acc, scale, params, "i8k_", use_power=use_power)
    if use_log:
        feats = floor_log(feats, log_floor)
    if include_energy:
        energy = frame_energy(
            frames, use_log=use_log, use_power=use_power, log_floor=log_floor
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


_I8_STEP_K = 32  # k rows of one int8 tensor-core product
_I8_STEP_ALIGN = 4  # k-steps a chunk is padded to a multiple of (ring stages)
_I8_CHUNK_BINS = 64  # bins per column chunk


def _pack_groups(gmats, offsets, frame_length: int):
    """The grouped digit matrices packed for the tensor-core kernel, and
    the group table.

    Returns ``(packed, steps, (n_groups, members, xs, s))``: ``packed`` is
    int8 ``(chunks, steps, 16, 2, 8, 16)`` with ``chunks = ceil(nb / 64)``:
    [chunk][k-step][column group][k half][column in group][k in half], so
    each k-step is 16 x 2 core matrices (8 columns x 16 k, contiguous) in
    the K-major layout the tensor cores read from shared memory.  Chunk
    ``c``'s column ``2i`` is the real (cos) column and ``2i + 1`` the mixed
    column of bin ``64c + i``, so one thread of the kernel holds a bin's
    pair; columns past ``nb`` are zero.  K-step ``u`` holds rows ``[32kk,
    32kk + 32)`` (``kk = u % nk``, ``nk = ceil(K / 32)``) of member
    ``u // nk``, members in group order, zero past ``K``; zero k-steps pad
    ``steps`` to a multiple of 4.  ``members``, ``xs`` (five slots a group)
    and ``s`` are ctypes arrays in ascending weight order."""
    nb2 = gmats.shape[1]
    nb = nb2 // 2
    kp = -(-frame_length // _I8_STEP_K) * _I8_STEP_K
    blocks, members, xs_flat, svals = [], [], [], []
    for s, xs, off, span in offsets:
        m = len(xs)
        blocks.append(gmats[off : off + span].reshape(m, frame_length, nb2))
        members.append(m)
        xs_flat.extend(list(xs) + [0] * (_I8_X_DIGITS - m))
        svals.append(s)
    rows = torch.nn.functional.pad(torch.cat(blocks), (0, 0, 0, kp - frame_length))
    n_steps = rows.shape[0] * kp // _I8_STEP_K
    steps = -(-n_steps // _I8_STEP_ALIGN) * _I8_STEP_ALIGN
    chunks = -(-nb // _I8_CHUNK_BINS)
    ksteps = rows.reshape(n_steps, _I8_STEP_K, nb2)
    # (real, mixed) of each bin side by side, bins padded to whole chunks
    cols = torch.stack([ksteps[..., :nb], ksteps[..., nb:]], dim=-1).reshape(
        n_steps, _I8_STEP_K, nb2
    )
    cols = torch.nn.functional.pad(
        cols, (0, 2 * (chunks * _I8_CHUNK_BINS - nb), 0, 0, 0, steps - n_steps)
    )
    packed = (
        cols.reshape(steps, 2, 16, chunks, 2 * _I8_CHUNK_BINS // 8, 8)
        .permute(3, 0, 4, 1, 5, 2)
        .contiguous()
    )

    def ints(vals):
        return (ctypes.c_int * len(vals))(*vals)

    return packed, steps, (len(members), ints(members), ints(xs_flat), ints(svals))


def _packed_groups(gmats, offsets, frame_length: int):
    """:func:`_pack_groups`, once per gmats tensor (same version, schedule
    and frame length)."""
    key = (gmats._version, tuple(offsets), frame_length)
    return _cached(_PACKED, gmats, key, lambda: _pack_groups(gmats, offsets, frame_length))


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
    ``2*F*K*2nb`` per kept digit pair (19 pairs for 'double', 15 for
    'accurate'), against the 1,979 TOP/s int8 tensor-core rate.  Design
    (``csrc/int8_kernels.cu``): one block per (row, 64 frames) digitises
    its frames once into shared memory and runs each equal-weight group as
    exact int8 x int8 -> int32 tensor-core products (``wgmma``; ``mma.sync``
    for the 32- and 16-frame tiles of long frames; past those, 64-frame
    tiles digitise slab by slab of ``K``, so every ``K`` runs), the grouped matrices
    streaming through a shared-memory ring in the layout of
    :func:`_pack_groups`, one 64-bin chunk of columns at a time; the
    exactness (integer sums, the 12-bit split, the ascending fp32 adds) is
    the point of the tier.  A bank too wide for one block's filter sums is
    split into filter groups (:func:`int8_launch_plan`), each column with
    the bits a one-group launch would give it.
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
    packed, steps, (n_groups, members, xs, svals) = _packed_groups(
        gmats, params["i8k_offsets"], frame_length
    )
    w_hi, w_lo = tail["w_hi"], tail["w_lo"]
    spans = _digit_spans(w_hi, w_lo)
    with torch.cuda.device(padded.device):
        _launch(
            "stk_int8_feats", "stft_feats_int8",
            padded.data_ptr(), padded.shape[0], padded.shape[1], padded.shape[1],
            frame_shift, num_frames, frame_length, nb, n_filts, packed.data_ptr(),
            steps, n_groups, members, xs, svals,
            float(params["i8k_cos_scale"]), tail["mixed_scale"].data_ptr(),
            tail["mask"].data_ptr(), tail["w_hi"].data_ptr(), tail["w_lo"].data_ptr(),
            tail["w_nyq"].data_ptr(), spans.data_ptr(), out.data_ptr(), int(use_log),
            int(use_power), int(include_energy), float(log_floor), _stream(padded),
        )
    stft_feats_int8.launches += 1
    return out


# --- B4: the base-256 digit kernel -------------------------------------------


def padded_need(
    num_frames: int,
    frame_length: int,
    frame_shift: int,
    block_frames: int,
) -> int:
    """The padded sample count the JAX package's fused kernels' rows layout
    needs (``speech_tpu/ops/pallas_stft.py:padded_need``): callers that pad
    their own buffers to it hand both packages the same rows.  The CUDA
    kernels bound their reads by the row length and need no such padding.
    """
    q_full, rem = divmod(frame_length, frame_shift)
    q_rows = q_full + (1 if rem else 0)
    blocks = -(-num_frames // block_frames)
    seg_rows = -(-(block_frames + q_rows) // 8) * 8
    return (blocks * block_frames + (seg_rows - block_frames)) * frame_shift


def _digit_adversary_rows(batch: int, n: int):
    """float32 CPU rows ``(batch, n)`` whose frames drive the base-256 pair
    sums toward their 2^24 limit, for the digit kernel's exactness checks.

    Every sample is ``+-v`` with ``v = 127.5 / 256``: a frame's peak is
    ``v``, its scale 1, and each sample's x digits are (128, -128, 0, 0)
    (127.5 rounds half to even).  Rows ``0, 3, ...`` are ``+v``, rows ``1,
    4, ...`` alternate in sign (the Nyquist cosine, in the mixed block's DC
    slot) and rows ``2, 5, ...`` are ``-v``: the signs of the DC cosine
    planes, so pairs (0, 0) and (1, 0) add ``128 |M digit|`` over the whole
    frame.  With the Hamming window at K = 512 that is ``128 * 65,556 >
    2^23`` (Hann's plane-0 digits are half as large)."""
    v = 127.5 / 256
    t = torch.arange(n)
    patterns = torch.stack(
        [torch.full((n,), v), v * (1 - 2 * (t % 2)).to(torch.float32), torch.full((n,), -v)]
    )
    return patterns[torch.arange(batch) % 3].to(torch.float32).contiguous()


_D_STEP_K = 16  # k rows of one bf16 tensor-core product
_D_STAGE_STEPS = 2  # k-steps a ring stage: the packing pads to a multiple
_D_CHUNK_BINS = 64  # bins per column chunk


def _pack_double(mats):
    """The base-256 M digit planes packed for the bf16 tensor-core kernel.

    Returns ``(packed, steps)``: ``packed`` is bfloat16 ``(n_m, chunks,
    steps, 16, 2, 8, 8)`` with ``chunks = ceil(nb / 64)``: [plane][chunk]
    [k-step][column group][k half][column in group][k in half], so each
    k-step of a chunk is 16 x 2 core matrices (8 columns x 8 k, 16 bytes a
    column) in the K-major layout the tensor cores read from shared memory.
    Chunk ``c``'s column ``2i`` is the real (cos) column and ``2i + 1`` the
    mixed column of bin ``64c + i`` (the Nyquist cosine at bin 0), as
    ``pdk_mats`` holds them in ``[:nb]`` and ``[nb:]``; columns past ``nb``
    are zero.  K-step ``u`` holds rows ``[16u, 16u + 16)``, zero past ``K``;
    ``steps = ceil(K / 16)`` rounded up to even.  Every digit (at most 256
    in magnitude) is exact in bf16."""
    n_m, K, nb2 = mats.shape
    nb = nb2 // 2
    chunks = -(-nb // _D_CHUNK_BINS)
    steps = -(-K // (_D_STEP_K * _D_STAGE_STEPS)) * _D_STAGE_STEPS
    cols = torch.stack([mats[..., :nb], mats[..., nb:]], dim=-1).reshape(n_m, K, nb2)
    cols = torch.nn.functional.pad(
        cols, (0, 2 * (chunks * _D_CHUNK_BINS - nb), 0, steps * _D_STEP_K - K)
    )
    packed = (
        cols.to(torch.bfloat16)
        .reshape(n_m, steps, 2, 8, chunks, 2 * _D_CHUNK_BINS // 8, 8)
        .permute(0, 4, 1, 5, 2, 6, 3)
        .contiguous()
    )
    return packed, steps


def _packed_double(mats):
    """:func:`_pack_double`, once per pdk_mats tensor (same version)."""
    return _cached(_PACKED, mats, (mats._version,), lambda: _pack_double(mats))


def _double_pairs(params, n_x: Optional[int], cutoff: Optional[int]):
    """The kept ``(i, j)`` digit pairs, in the order their terms add."""
    n_x = _PDK_X_DIGITS if n_x is None else n_x
    cutoff = _PDK_CUTOFF if cutoff is None else cutoff
    return digit_pair_schedule(n_x, params["pdk_mats"].shape[0], cutoff)


def stft_feats_double_plain(
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
    n_x: Optional[int] = None,
    cutoff: Optional[int] = None,
):
    """Plain version of :func:`stft_feats_double`, step by step.  Each
    pair dot is an IEEE float32 matmul of integer digits: products below
    2^15 and sums below 2^24 are exact in any order, so it gives the
    kernel's integers."""
    frames = frame_padded(
        padded.to(torch.float32), num_frames, frame_length, frame_shift
    )
    m = torch.clamp_min(torch.amax(torch.abs(frames), dim=-1, keepdim=True), 1e-30)
    bits = m.contiguous().view(torch.int32)
    scale = (((bits >> 23) + 2) << 23).view(torch.float32)
    v = frames * (1.0 / scale)
    pairs = _double_pairs(params, n_x, cutoff)
    planes = []
    for _ in range(max(i for i, _ in pairs) + 1):
        d = torch.round(v * _PDK_BASE)  # half to even, as jnp.round
        v = v * _PDK_BASE - d
        planes.append(d)
    mats = params["pdk_mats"]
    acc = None
    with ieee_float32():
        for i, j in pairs:  # ascending weight
            term = torch.matmul(planes[i], mats[j]) * _PDK_BASE ** -(i + j + 2)
            acc = term if acc is None else acc + term
        feats = _digit_tail(acc, scale, params, "pdk_", use_power=use_power)
    if use_log:
        feats = floor_log(feats, log_floor)
    if include_energy:
        energy = frame_energy(
            frames, use_log=use_log, use_power=use_power, log_floor=log_floor
        )
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


def stft_feats_double(
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
    n_x: Optional[int] = None,
    cutoff: Optional[int] = None,
):
    """Fused base-256 digit-tier features for padded signals ``(batch,
    padded_len)`` -> ``(batch, num_frames, num_coeffs)`` float32.

    The default plane configuration is the exact 'double' tier (4
    x-planes, 13 pair dots); ``n_x``/``cutoff`` select reduced-pair
    variants ('accurate' passes ``(4, 3)``: 10 dots).  Like the JAX op it
    runs framing plus the plain digit path
    (``stft_feats_from_frames(..., precision="double")``) where the params
    carry no kernel layout (``pdk_mats``) or the frame is too long for
    exact base-256 sums (``K * 256^2 / 2 > 2^24``, i.e. K > 512).

    Replaces ``speech_tpu/ops/pallas_stft.py:stft_feats_pallas_double``
    (``_double_rows_kernel``).  Bound on an H100: the pair dots, ``2*F*K*2nb``
    per pair, against the 989 TFLOP/s dense bf16 tensor-core rate, plus
    the fp32 tail over each filter's span.  Design (``csrc/double_kernels.cu``):
    one block per (row, 128 frames) stages its samples in shared memory;
    two warpgroups run each pair dot as ``wgmma`` bf16 products with the x
    digits computed into registers from the samples (every digit is exact
    in bf16) and the M plane of :func:`_pack_double` streaming through a
    shared-memory ring, one 64-bin chunk of columns at a time; the tensor
    cores sum each dot in fp32 exactly (measured by
    ``tools/torch_wgmma_probe.py``: integer sums up to 2^24), and each
    pair's term adds into the fp32 accumulator in pair order.  Frames and
    digit planes never reach device memory.  A bank whose filter sums do
    not fit beside a ring of 3 stages (161 filters at K 400) runs in filter
    groups, one grid slice each; every filter's sum runs over its chunks in
    the same order, so the bits do not depend on the split.
    """
    padded = padded.to(torch.float32)
    if padded.dim() != 2:
        raise ValueError(f"padded must be (batch, samples), got {tuple(padded.shape)}")
    k_exact = frame_length * int(_PDK_BASE) ** 2 // 2 <= 1 << 24
    if "pdk_mats" not in params or not k_exact:
        frames = frame_padded(padded, num_frames, frame_length, frame_shift)
        return stft_feats_from_frames(
            frames,
            params,
            dft_size=dft_size,
            use_log=use_log,
            use_power=use_power,
            include_energy=include_energy,
            log_floor=log_floor,
            fft_mode="matmul",
            precision="double",
        )
    nb = params["pdk_mask"].shape[0]
    if nb != dft_size // 2:
        raise ValueError(f"digit layout has nb={nb}, dft_size is {dft_size}")
    spec = dict(
        num_frames=num_frames,
        frame_length=frame_length,
        frame_shift=frame_shift,
        dft_size=dft_size,
        use_log=use_log,
        use_power=use_power,
        include_energy=include_energy,
        log_floor=log_floor,
        n_x=n_x,
        cutoff=cutoff,
    )
    if padded.device.type == "cpu":
        return stft_feats_double_plain(padded, params, **spec)
    mats = params["pdk_mats"]
    if mats.dtype != torch.float32 or mats.shape[1:] != (frame_length, 2 * nb):
        raise ValueError(
            f"pdk_mats must be float32 (n_m, {frame_length}, {2 * nb}), got "
            f"{mats.dtype} {tuple(mats.shape)}"
        )
    tail = {k: params["pdk_" + k] for k in ("mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")}
    _check_cuda(padded, padded=padded, pdk_mats=mats, **tail)
    n_filts = tail["w_hi"].shape[1]
    out = torch.empty(
        (padded.shape[0], num_frames, n_filts + int(include_energy)),
        dtype=torch.float32,
        device=padded.device,
    )
    if out.numel() == 0:
        return out
    pairs = _double_pairs(params, n_x, cutoff)
    pair_i = (ctypes.c_int * len(pairs))(*(i for i, _ in pairs))
    pair_j = (ctypes.c_int * len(pairs))(*(j for _, j in pairs))
    packed, _ = _packed_double(mats)
    w_hi, w_lo = tail["w_hi"], tail["w_lo"]
    spans = _digit_spans(w_hi, w_lo)
    with torch.cuda.device(padded.device):
        _launch(
            "stk_double_feats", "stft_feats_double",
            padded.data_ptr(), padded.shape[0], padded.shape[1], padded.shape[1],
            frame_shift, num_frames, frame_length, nb, n_filts, packed.data_ptr(),
            mats.shape[0], len(pairs), pair_i, pair_j,
            float(params["pdk_cos_scale"]), tail["mixed_scale"].data_ptr(),
            tail["mask"].data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
            tail["w_nyq"].data_ptr(), spans.data_ptr(), out.data_ptr(), int(use_log),
            int(use_power), int(include_energy), float(log_floor), _stream(padded),
        )
    stft_feats_double.launches += 1
    return out


# --- the packed batch's row layout --------------------------------------------


def layout_rows_plain(packed, offsets, counts, max_len: int):
    """Plain version of :func:`layout_rows`, row by row, with the kernel's
    clamps."""
    n = packed.shape[0]
    rows = torch.zeros((counts.shape[0], max_len), dtype=packed.dtype, device=packed.device)
    for r, (off, k) in enumerate(zip(offsets.tolist(), counts.tolist())):
        off = min(max(off, 0), n)
        k = min(max(k, 0), max_len, n - off)
        rows[r, :k] = packed[off: off + k]
    return rows


def layout_rows(packed, offsets, counts, max_len: int):
    """The zero-padded ``(rows, max_len)`` block of a packed batch: row
    ``r`` is the ``counts[r]`` elements of the 1-D ``packed`` from element
    ``offsets[r]`` (int64 ``(rows,)`` tensors beside it), then zeros.
    Counts are clamped to ``max_len`` and to the packed elements.  The
    elements are copied as they are (2, 4 or 8 bytes, any dtype), so the
    block is bit for bit the one a host would pad.  The kernel loads a row
    in 16-byte vectors where its offset is a multiple of 16 bytes."""
    if packed.dim() != 1 or not packed.is_contiguous():
        raise ValueError(f"packed must be 1-D and contiguous, got {tuple(packed.shape)}")
    if packed.element_size() not in (2, 4, 8):
        raise ValueError(f"packed elements must be 2, 4 or 8 bytes, got {packed.dtype}")
    for name, t in (("offsets", offsets), ("counts", counts)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int64, got {t.dtype} {tuple(t.shape)}")
    if offsets.shape != counts.shape:
        raise ValueError(f"offsets {tuple(offsets.shape)} and counts {tuple(counts.shape)} differ")
    if max_len < 0:
        raise ValueError(f"max_len must not be negative, got {max_len}")
    if packed.device.type == "cpu":
        return layout_rows_plain(packed, offsets, counts, max_len)
    _check_cuda(packed, offsets=offsets, counts=counts)
    out = torch.empty((counts.shape[0], max_len), dtype=packed.dtype, device=packed.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(packed.device):
        _launch(
            "stk_layout_rows", "layout_rows",
            packed.data_ptr(), packed.shape[0], offsets.data_ptr(), counts.data_ptr(),
            counts.shape[0], max_len, packed.element_size(), out.data_ptr(), _stream(packed),
        )
    layout_rows.launches += 1
    return out


KERNELS = (stft_feats_rows, stft_feats_frames, stft_feats_int8, stft_feats_double, layout_rows)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0
