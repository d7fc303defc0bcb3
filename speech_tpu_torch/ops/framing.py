"""Framing: slicing signals into (possibly overlapping) analysis frames.

The PyTorch counterpart of :mod:`speech_tpu.ops.framing`.  A signal is
padded by symmetric reflection on both sides (:func:`pad_signal_full` when
every row is valid to its end, :func:`pad_signal` for per-row lengths) and
then framed with a strided view (:func:`frame_padded`).  The fused kernels
read the padded rows directly and never materialise the frames.
"""

import torch

__all__ = [
    "frame_count",
    "frame_count_np",
    "frame_padded",
    "left_pad_width",
    "pad_signal",
    "pad_signal_full",
    "reflect_index",
]


def left_pad_width(
    frame_style: str, frame_length: int, frame_shift: int, kaldi_shift: bool
) -> int:
    """Samples of left context before sample 0 of the signal
    (reference: compute.py:76-84, 280-285, 583-587)."""
    if frame_style == "causal":
        return 0
    if kaldi_shift:
        return frame_length // 2 - frame_shift // 2
    return (frame_length + 1) // 2 - 1


def frame_count_np(sig_len: int, frame_length: int, frame_shift: int) -> int:
    """Number of frames ``compute_full`` produces for a signal (host math):
    ``(len + shift // 2) // shift``, but 0 for signals shorter than half a
    frame (reference: compute.py:580-596)."""
    if sig_len < frame_length // 2 + 1:
        return 0
    return max(0, (sig_len + frame_shift // 2) // frame_shift)


def frame_count(sig_len, frame_length: int, frame_shift: int):
    """Tensor version of :func:`frame_count_np` (int32)."""
    sig_len = torch.as_tensor(sig_len)
    n = torch.clamp_min(
        torch.div(sig_len + frame_shift // 2, frame_shift, rounding_mode="floor"),
        0,
    )
    n = torch.where(sig_len < frame_length // 2 + 1, torch.zeros_like(n), n)
    return n.to(torch.int32)


def reflect_index(pos, length):
    """Map integer positions onto ``[0, length)`` by symmetric reflection,
    at any depth: ``..., x1, x0 | x0, ..., xl-1 | xl-1, ..., x0 | ...``."""
    period = 2 * length
    m = torch.remainder(pos, period)  # floor-mod: negatives land in range
    return torch.where(m < length, m, period - 1 - m)


def pad_signal_full(signal, frame_length: int, pad_left: int, min_len: int = 0):
    """Symmetric padding of fully valid rows ``(..., L)`` with ``L >=
    frame_length``: ``[flip(x[:pad_left]) | x | flip(x[-frame_length:])]``.

    ``min_len`` right-pads with zeros to at least that length in the same
    concatenation.
    """
    pieces = [
        torch.flip(signal[..., :pad_left], dims=[-1]),
        signal,
        torch.flip(signal[..., -frame_length:], dims=[-1]),
    ]
    base = pad_left + signal.shape[-1] + frame_length
    if min_len > base:
        pieces.append(
            signal.new_zeros(signal.shape[:-1] + (min_len - base,))
        )
    return torch.cat(pieces, dim=-1)


def pad_signal(signal, sig_len, frame_length: int, frame_shift: int, pad_left: int):
    """Symmetric padding with per-row true lengths.

    ``signal`` is ``(L,)`` with a scalar ``sig_len`` or ``(batch, L)`` with
    ``(batch,)`` lengths; the first ``sig_len`` samples of a row are valid.
    Returns rows of ``pad_left + L + frame_length`` samples laid out as
    ``[reflect(pad_left) | signal | reflect(...)]``: the right reflection is
    one gather of ``frame_length`` samples per row, at any depth of
    reflection.  Contents past the right reflection are unspecified (they
    only feed frames past the true frame count, which callers mask).
    """
    single = signal.dim() == 1
    if single:
        signal = signal[None]
    batch, buf_len = signal.shape
    lengths = torch.as_tensor(sig_len, device=signal.device).reshape(-1)
    lengths = lengths.to(torch.int64).expand(batch)
    left = torch.flip(signal[:, :pad_left], dims=[-1])
    padded = torch.cat(
        [left, signal, signal.new_zeros((batch, frame_length))], dim=-1
    )
    k = torch.arange(frame_length, device=signal.device)
    pos = reflect_index(
        lengths[:, None] + k, torch.clamp_min(lengths, 1)[:, None]
    )
    rtail = torch.gather(signal, 1, pos)
    # the write starts at pad_left + sig_len; like jax.lax.
    # dynamic_update_slice, a negative start counts from the end (a
    # negative pad_left: Kaldi centring with shift > frame length) and the
    # start is clamped so the write fits
    total = padded.shape[1]
    start = pad_left + lengths
    start = torch.where(start < 0, start + total, start)
    start = torch.clamp(start, 0, total - frame_length)
    padded.scatter_(1, start[:, None] + k, rtail)
    return padded[0] if single else padded


def frame_padded(padded, max_frames: int, frame_length: int, frame_shift: int):
    """Frame padded rows ``(..., N)`` into ``(..., max_frames,
    frame_length)``: frame ``k`` is samples ``[k*shift, k*shift +
    frame_length)``.  A strided view where the rows are long enough,
    zero-padded otherwise."""
    need = max(max_frames - 1, 0) * frame_shift + frame_length
    if padded.shape[-1] < need:
        padded = torch.nn.functional.pad(padded, (0, need - padded.shape[-1]))
    return padded.unfold(-1, frame_length, frame_shift)[..., :max_frames, :]
