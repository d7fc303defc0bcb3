"""Explicit-carry streaming: chunked feature extraction with tensor state.

The counterpart of :mod:`speech_tpu.streaming`.  The host streaming API of
the computers (``compute_chunk``/``finalize``) keeps its state in Python;
here state is a :class:`~typing.NamedTuple` of tensors on the computer's
device, chunks have a static size, and ``process`` / ``finalize`` return
padded frame blocks plus valid counts, so that a server can carry many
sessions side by side.

Semantics match the host streaming exactly (reference: compute.py:462-572):
the first centered frame's left context is reflected ("symmetric") from
the stream head, after which framing is a causal sliding window;
``finalize`` right-pads symmetrically and flushes.  Any signal length
streams: ``process`` takes a ``valid_len`` marking how many leading samples
of the chunk are real.

Concurrent streams are a leading stream axis.  ``init_state(streams=S)``
gives every state leaf a leading axis of ``S``; ``_process_impl`` /
``_finalize_impl`` then take chunks ``(S, C)`` and valid counts ``(S,)``
and return ``(S, ...)`` outputs.  Without the axis a call is the
single-stream form.  Counts, carries and offsets stay on the device: a
slice whose start is a count is one gather of ``arange + start``, with the
start clamped into range as ``jax.lax.dynamic_slice`` clamps it, and no
tick reads a tensor back to the host.  Only ``transform`` and ``scan``'s
callers read counts.  ``lax.scan`` becomes a Python loop.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from . import config as _config
from .compute import (
    _TORCH_DTYPES,
    ShortIntegrationFrameComputer,
    ShortTimeFourierTransformFrameComputer,
)
from .ops import pitch as _pitch
from .ops import si as _si
from .ops import stft as _stft
from .ops._device import host_constant, resolve_device
from .ops.framing import frame_count, frame_padded, reflect_index
from .ops.resample import fir_conv_matmul, resample_matrices

__all__ = [
    "StreamState",
    "StreamingSTFT",
    "SIStreamState",
    "StreamingSI",
    "PitchStreamState",
    "StreamingPitch",
    "AppendPitchState",
    "StreamingAppendPitch",
]

def _torch_dtype(dtype) -> torch.dtype:
    """A float dtype given as a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).name]


# --- tensor-tree and slicing helpers (shared with streaming_post) -----------


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested tuples / NamedTuples."""
    tree = trees[0]
    if isinstance(tree, torch.Tensor):
        return fn(*trees)
    out = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def _tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _tree_leaves(sub)]


def _tree_where(cond, new, old):
    """Per stream ``cond (S,)``: the leaves of ``new`` or ``old``."""

    def pick(n, o):
        if n is o:
            return n
        return torch.where(cond.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return _tree_map(pick, new, old)


def _lift(tree):
    return _tree_map(lambda x: x[None], tree)


def _drop(tree):
    return _tree_map(lambda x: x[0], tree)


def _take_rows(x, idx):
    """``x[s, idx[s, j]]`` along axis 1 of ``x (S, T, ...)`` for ``idx (S,
    J)``: one gather."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _window(x, start, length: int):
    """Rows ``[start, start + length)`` of each stream of ``x (S, T, ...)``,
    ``start (S,)`` clamped into ``[0, T - length]`` as
    ``jax.lax.dynamic_slice`` clamps it."""
    start = torch.clamp(start, 0, max(x.shape[1] - length, 0))
    return _take_rows(x, start[:, None] + torch.arange(length, device=x.device))


def _paste(buf, block, start):
    """``buf (S, T, ...)`` with rows ``[start, start + c)`` replaced by
    ``block (S, c, ...)``, ``start (S,)`` clamped into ``[0, T - c]`` as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    T, c = buf.shape[1], block.shape[1]
    if c == 0:
        return buf
    start = torch.clamp(start, 0, T - c)
    rel = torch.arange(T, device=buf.device)[None, :] - start[:, None]
    inside = (rel >= 0) & (rel < c)
    vals = _take_rows(block, torch.clamp(rel, 0, c - 1))
    return torch.where(inside.reshape(inside.shape + (1,) * (buf.dim() - 2)), vals, buf)


def _counts(valid_len, streams: int, limit: int, device):
    """Valid counts ``(streams,)`` int64 on ``device``, clipped to ``[0,
    limit]`` as ``jnp.clip``: from a host integer (a fill, no copy) or a
    tensor (a scalar broadcasts)."""
    if isinstance(valid_len, torch.Tensor):
        v = valid_len.to(device=device, dtype=torch.int64).reshape(-1).expand(streams)
    else:
        v = torch.full((streams,), int(valid_len), dtype=torch.int64, device=device)
    return torch.clamp(v, 0, limit)


def _scrub(frames, nin):
    """Zero rows at/after the valid counts of ``frames (S, cap, F)``
    (garbage must never reach arithmetic that could spill into valid
    rows); returns the counts clipped to ``[0, cap]`` too."""
    cap = frames.shape[1]
    nin = torch.clamp(nin, 0, cap)
    mask = torch.arange(cap, device=frames.device)[None, :] < nin[:, None]
    return torch.where(mask[..., None], frames, 0), nin


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _as_signal(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class _Streamer:
    """The public entry points and host helpers shared by the streamers.

    Subclasses implement ``_process_streams(state, chunks (S, C), v (S,))``
    and ``_finalize_streams(state)`` on the stream axis, and name a counter
    leaf of their state (``_counter``) whose rank tells the single-stream
    form (0) from the stream axis (1)."""

    _counter = "n_raw"

    def _as_chunk(self, chunk):
        return _as_signal(chunk, self._dtype, self.device)

    def _process_impl(self, state, chunk, valid_len):
        """One chunk ``(C,)`` (or ``(S, C)`` on the stream axis): returns
        ``(state, feats, n_valid)``."""
        chunk = self._as_chunk(chunk)
        single = chunk.dim() == 1
        if single:
            state, chunk = _lift(state), chunk[None]
        v = _counts(valid_len, chunk.shape[0], chunk.shape[1], chunk.device)
        out = self._process_streams(state, chunk, v)
        return _drop(out) if single else out

    def _finalize_impl(self, state):
        single = getattr(state, self._counter).dim() == 0
        out = self._finalize_streams(_lift(state) if single else state)
        return _drop(out) if single else out

    def _process_many_impl(self, state, chunks, valids):
        """``k`` chunks, ``(k, C)`` (or ``(S, k, C)``), one process step
        each: returns ``(state, feats (k, ...), nfs (k,))`` (the chunk axis
        after the stream axis)."""
        chunks = self._as_chunk(chunks)
        axis = chunks.dim() - 2
        valids = valids if isinstance(valids, torch.Tensor) else torch.as_tensor(np.asarray(valids))
        feats, nfs = [], []
        for i in range(chunks.shape[axis]):
            state, f, n = self._process_impl(
                state, chunks.select(axis, i), valids.select(valids.dim() - 1, i)
            )
            feats.append(f)
            nfs.append(n)
        return state, torch.stack(feats, axis), torch.stack(nfs, -1)

    def finalize(self, state):
        """Flush the remaining samples; returns ``(feats, n_valid)``."""
        return self._finalize_impl(state)

    def scan(self, signal, sig_len=None):
        """A whole utterance ``(L,)`` (or ``(S, L)`` with ``sig_len (S,)``),
        chunk by chunk then finalize.  Returns ``(feats, counts, fin_feats,
        fin_count)`` with feats ``(n_steps, capacity, width)`` and per-step
        valid counts; rows past a step's count are garbage to mask (see
        :meth:`transform`)."""
        C = self.chunk_size
        signal = self._as_chunk(signal)
        buf_len = signal.shape[-1]
        n_steps = max(1, -(-buf_len // C))
        if sig_len is None:
            sig_len = buf_len
        padded = torch.nn.functional.pad(signal, (0, n_steps * C - buf_len))
        sig_len = torch.as_tensor(sig_len, device=signal.device)
        starts = torch.arange(n_steps, device=signal.device) * C
        valids = torch.clamp(sig_len[..., None] - starts, 0, C)
        state = self.init_state(None if signal.dim() == 1 else signal.shape[0])
        chunks = padded.reshape(padded.shape[:-1] + (n_steps, C))
        state, feats, counts = self._process_many_impl(state, chunks, valids)
        fin_feats, fin_count = self._finalize_impl(state)
        return feats, counts, fin_feats, fin_count

    def _compacted(self, signal):
        """The valid rows of :meth:`scan` over a whole host signal, as one
        numpy array."""
        sig = np.asarray(signal)
        feats, counts, fin_feats, fin_count = self.scan(sig, len(sig))
        feats, counts = feats.cpu().numpy(), counts.cpu().numpy()
        outs = [feats[i, : counts[i]] for i in range(feats.shape[0])]
        outs.append(fin_feats.cpu().numpy()[: int(fin_count)])
        return np.concatenate(outs)


class _FrameStreamer(_Streamer):
    """The entry points of the frame computers' streamers."""

    def process(self, state, chunk, valid_len=None):
        """Consume one ``(chunk_size,)`` chunk (``(S, chunk_size)`` on the
        stream axis); returns ``(state, feats, n_valid)`` with feats
        ``(max_frames, num_coeffs)``.  ``valid_len`` (a host integer or a
        tensor) marks how many leading samples of the chunk are real;
        default: all of them."""
        if chunk.shape[-1] != self.chunk_size:
            raise ValueError(
                f"chunk must have static size {self.chunk_size}; "
                f"got {chunk.shape[-1]} (zero-pad and pass valid_len instead)"
            )
        if valid_len is None:
            valid_len = self.chunk_size
        return self._process_impl(state, chunk, valid_len)

    def process_many(self, state, chunks, valids):
        """Consume ``chunks (k, chunk_size)`` with per-chunk ``valids
        (k,)`` in one call; returns ``(state, feats (k, max_frames, C), nfs
        (k,))``."""
        if chunks.shape[-1] != self.chunk_size:
            raise ValueError(
                f"chunks must have static size {self.chunk_size}; "
                f"got {chunks.shape[-1]}"
            )
        return self._process_many_impl(state, chunks, valids)

    def process_wide(self, state, samples, valid_len=None):
        """Consume a masked sample buffer of any width in one call: the
        same result as successive :meth:`process` calls over the same
        samples, with every frame in one batch of products."""
        if valid_len is None:
            valid_len = samples.shape[-1]
        return self._process_impl(state, samples, valid_len)

    def transform(self, signal: np.ndarray) -> np.ndarray:
        """Host helper: stream a whole signal (any length) through
        :meth:`scan` and return the concatenated valid frames."""
        return self._compacted(signal)


class StreamState(NamedTuple):
    """Carry between chunks: a tail ring of the virtual stream."""

    carry: torch.Tensor  # (carry_len,) most recent virtual-stream samples
    n_carry: torch.Tensor  # int64, valid samples at the END of `carry`
    is_first: torch.Tensor  # bool, initial reflection not yet applied
    head: torch.Tensor  # (pad_left,) raw stream head (for the reflection)
    n_raw: torch.Tensor  # int64, raw samples seen so far


class StreamingSTFT(_FrameStreamer):
    """Explicit-carry streaming wrapper around an STFT computer.

    Example::

        stream = StreamingSTFT(computer, chunk_size=1600)
        state = stream.init_state()
        for chunk in chunks:                      # (1600,) each
            state, feats, n = stream.process(state, chunk)
            use(feats[:n])
        feats, n = stream.finalize(state)
        use(feats[:n])

    Features come from :func:`speech_tpu_torch.ops.stft.stft_feats_from_frames`
    with the computer's static spec (the plain tensor path, as the
    reference's stream takes the XLA path), on the computer's device.  A
    tick gathers each stream's window of samples once and frames it with a
    strided view.
    """

    def __init__(self, computer: ShortTimeFourierTransformFrameComputer, chunk_size: int):
        if not isinstance(computer, ShortTimeFourierTransformFrameComputer):
            raise ValueError("StreamingSTFT requires an STFT computer")
        self.computer = computer
        self.chunk_size = int(chunk_size)
        self.frame_length = computer.frame_length
        self.frame_shift = computer.frame_shift
        self.pad_left = computer._pad_left if computer.frame_style == "centered" else 0
        if self.frame_shift > self.frame_length:
            raise ValueError("streaming requires frame_shift <= frame_length")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        # the carry keeps up to frame_length - 1 unconsumed stream samples
        self.carry_len = self.frame_length - 1
        total = self.carry_len + self.pad_left + self.chunk_size
        self.max_frames = max(0, (total - self.frame_length) // self.frame_shift + 1)
        self.finalize_max_frames = (self.carry_len + self.pad_left) // self.frame_shift + 1
        self._dtype = computer._dtype
        self.device = computer.device
        computer.params  # the host build, outside any tick

    def init_state(self, streams=None) -> StreamState:
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        lead = () if streams is None else (int(streams),)
        dev = self.device
        return StreamState(
            carry=torch.zeros(lead + (self.carry_len,), dtype=self._dtype, device=dev),
            n_carry=torch.zeros(lead, dtype=torch.int64, device=dev),
            is_first=torch.ones(lead, dtype=torch.bool, device=dev),
            head=torch.zeros(lead + (self.pad_left,), dtype=self._dtype, device=dev),
            n_raw=torch.zeros(lead, dtype=torch.int64, device=dev),
        )

    def _feats(self, frames):
        c = self.computer
        return _stft.stft_feats_from_frames(frames, c.params, **c._static_spec)

    def _emit(self, stream, valid_end, total, max_frames: int):
        """Frames + counts from stream buffers ``(S, B)`` whose ``total``
        samples ending at index ``valid_end`` are valid.  Frame ``k`` starts
        at ``valid_end - total + k*shift``: one gather of the window, then
        a strided view.  Positions past ``valid_end`` (chunk tail garbage,
        then the zero pad) are read only by frames ``>= nf``."""
        FL, FS = self.frame_length, self.frame_shift
        nf = torch.clamp_min(_floordiv(total - FL, FS) + 1, 0)
        win_len = (max_frames - 1) * FS + FL
        padded = torch.nn.functional.pad(stream, (0, win_len))
        start = torch.clamp(valid_end - total, 0, stream.shape[1])
        window = _window(padded, start, win_len)
        frames = frame_padded(window, max_frames, FL, FS)
        return self._feats(frames), nf

    def _process_streams(self, state: StreamState, chunk, v):
        S, C = chunk.shape
        FS, PL, CL = self.frame_shift, self.pad_left, self.carry_len
        dev = chunk.device
        # grow the raw stream head while the initial reflection is pending
        if PL:
            pos = torch.arange(PL, device=dev)[None, :]
            src = pos - torch.clamp(state.n_raw, max=PL)[:, None]
            shifted = torch.where(
                (src >= 0) & (src < C), torch.gather(chunk, 1, torch.clamp(src, 0, C - 1)), 0
            )
            grow = (pos >= state.n_raw[:, None]) & (pos < (state.n_raw + v)[:, None])
            head = torch.where(grow, shifted, state.head)
        else:
            head = state.head
        n_raw = state.n_raw + v

        total = state.n_carry + v
        zeros = chunk.new_zeros((S, PL))
        stream = torch.cat([zeros, state.carry, chunk], dim=1)
        valid_end = PL + CL + v
        # apply the symmetric reflection of the stream head once it is
        # complete (reference: compute.py:497-517): flip(head) goes just
        # before the valid region
        if PL:
            apply_now = state.is_first & (n_raw >= PL)
            inserted = _paste(stream, torch.flip(head, dims=[1]), valid_end - total - PL)
            stream = torch.where(apply_now[:, None], inserted, stream)
            total = total + torch.where(apply_now, PL, 0)
            is_first = state.is_first & ~apply_now
        else:
            is_first = torch.zeros_like(state.is_first)

        # no frame may be emitted before the reflection is applied; the
        # frame capacity scales with the chunk length, so any width is one
        # call
        max_frames = max(0, (CL + PL + C - self.frame_length) // FS + 1)
        feats, nf = self._emit(stream, valid_end, total, max_frames)
        nf = torch.where(is_first, 0, nf)
        rem = torch.clamp(total - nf * FS, max=CL)
        # the carry holds the CL virtual samples ending at the newest valid
        # one (only the last `rem` are meaningful)
        carry = _window(stream, valid_end - CL, CL) if CL else stream[:, :0]
        new = StreamState(carry=carry, n_carry=rem, is_first=is_first, head=head, n_raw=n_raw)
        return new, feats, nf

    def _finalize_streams(self, state: StreamState):
        FL, FS, PL = self.frame_length, self.frame_shift, self.pad_left
        buf_len = state.carry.shape[1]
        dev = state.carry.device
        total = state.n_carry
        start = (buf_len - total)[:, None, None]  # first valid sample in carry
        pos = (
            torch.arange(self.finalize_max_frames, device=dev)[:, None] * FS
            + torch.arange(FL, device=dev)[None, :]
        )[None]
        top = max(buf_len - 1, 0)
        if PL:
            # never-reflected stream (every chunk so far was too short to
            # complete the head): the carry holds the raw signal whole, so
            # frames follow compute_full's semantics, reflecting on both
            # sides at any depth
            n = state.n_raw
            sidx = reflect_index(pos - PL, torch.clamp_min(n, 1)[:, None, None])
            first_idx = torch.clamp(start + sidx, 0, top)
            nf_first = frame_count(n, FL, FS).to(torch.int64)
        # steady stream: the reflection is already part of the carried
        # virtual samples; only the right edge still reflects.  The global
        # frame target minus the frames already emitted is the flush count.
        done = _floordiv(state.n_raw + PL - total, FS)
        nf_steady = torch.clamp_min(frame_count(state.n_raw, FL, FS).to(torch.int64) - done, 0)
        rel = reflect_index(pos, torch.clamp_min(total, 1)[:, None, None])
        steady_idx = torch.clamp(start + rel, 0, top)
        if PL:
            idx = torch.where(state.is_first[:, None, None], first_idx, steady_idx)
            nf = torch.where(state.is_first, nf_first, nf_steady)
        else:
            idx, nf = steady_idx, nf_steady
        S = idx.shape[0]
        frames = torch.gather(state.carry, 1, idx.reshape(S, -1)).reshape(idx.shape)
        return self._feats(frames), nf


class SIStreamState(NamedTuple):
    """Carry between chunks for the SI stream."""

    carry: torch.Tensor  # (carry_len,) most recent raw samples (tail-valid)
    unconsumed: torch.Tensor  # int64, counted-but-unframed samples (< 0
    # early in causal/skip mode: counted = seen - shift_eff)
    seen: torch.Tensor  # int64, total raw samples seen


class StreamingSI(_FrameStreamer):
    """Explicit-carry streaming for the SI computer.

    The same contract as :class:`StreamingSTFT`.  The carry holds the last
    ``hist + 2*frame_shift`` raw samples (``hist = max(max_support - 1,
    translation)``): enough history for every convolution tap and energy
    Dirac of any frame not yet emitted.

    The emit convolution follows the computer's ``conv_mode``: the
    banded-Toeplitz block products of :func:`speech_tpu_torch.ops.si.block_conv_parts`,
    shared with ``compute_batch`` (digit tiers included, so the stream has
    the batch tier's exactness by construction), for ``matmul``,
    ``direct`` and ``auto`` at speech-sized supports; one real-FFT product
    for ``fft``.  Both run inside :func:`~speech_tpu_torch.ops.stft.ieee_float32`.
    """

    _counter = "seen"

    def __init__(self, computer: ShortIntegrationFrameComputer, chunk_size: int):
        if not isinstance(computer, ShortIntegrationFrameComputer):
            raise ValueError("StreamingSI requires an SI computer")
        self.computer = computer
        self.chunk_size = int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        k = computer._kernel
        self.T = k["max_support"]
        self.shift = computer.frame_shift
        self.shift_eff = k["shift_eff"]
        self.translation = k["translation"]
        self.is_real = k["is_real"]
        # the conv needs T-1 taps before counted position 0; the energy
        # Dirac reads `translation` samples back
        self.hist = max(self.T - 1, self.translation)
        self.carry_len = self.hist + 2 * self.shift
        # frames a chunk can give: unconsumed < 2*shift before it
        self.max_frames = (2 * self.shift + self.chunk_size) // self.shift
        # finalize pads at most ~2*shift + shift_eff zeros
        self.fin_pad = 2 * self.shift + max(0, self.shift_eff) + self.shift
        self.fin_max = (2 * self.shift + self.fin_pad) // self.shift + 1
        self._dtype = computer._dtype
        self.device = computer.device
        # the batch path's resolution of conv_mode; "direct" maps to the
        # block products too (the stream has no conv1d tier)
        conv_mode = computer._conv_mode
        if conv_mode == "auto":
            conv_mode = "matmul" if self.T <= 16 * _si.CONV_BLOCK else "fft"
        elif conv_mode == "direct":
            conv_mode = "matmul"
        self.conv_mode = conv_mode
        self.precision = computer._precision
        self._params = computer._params_for({"conv_mode": conv_mode})

    def init_state(self, streams=None) -> SIStreamState:
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        lead = () if streams is None else (int(streams),)
        dev = self.device
        return SIStreamState(
            carry=torch.zeros(lead + (self.carry_len,), dtype=self._dtype, device=dev),
            unconsumed=torch.full(lead, -self.shift_eff, dtype=torch.int64, device=dev),
            seen=torch.zeros(lead, dtype=torch.int64, device=dev),
        )

    def _conv_parts_fft(self, aligned, ny: int):
        """Per-part conv values ``(S, F, ny)`` at the aligned buffers'
        static output window (counted position ``q`` sits at input index
        ``hist + q``), via one real-FFT product."""
        params = self._params
        H0 = aligned.shape[1] - ny  # == self.hist
        need = aligned.shape[1] + self.T - 1
        fft_size = 1 << max(0, int(need)).bit_length()
        X = torch.fft.rfft(aligned, n=fft_size, dim=-1)

        def conv_vals(f):
            H = torch.fft.rfft(f, n=fft_size, dim=-1)
            conv = torch.fft.irfft(X[:, None, :] * H[None], n=fft_size, dim=-1)
            return conv[..., H0 : H0 + ny]

        parts = [conv_vals(params["firs_re"])]
        if not self.is_real:
            parts.append(conv_vals(params["firs_im"]))
        return parts

    def _conv_parts_matmul(self, aligned, ny: int):
        """Per-part conv values ``(S, F, ny)`` via the batch path's
        banded-Toeplitz block products over the aligned buffers (counted
        position ``q``'s conv value sits at linear-conv index ``hist +
        q``, a static window)."""
        params = self._params
        V = _si.CONV_BLOCK
        H0 = aligned.shape[1] - ny  # == self.hist
        nb = -(-aligned.shape[1] // V)
        x_pad = torch.nn.functional.pad(aligned, (0, nb * V - aligned.shape[1]))
        if self.precision in ("double", "accurate"):
            Kk = params["conv_re_digits"].shape[1] - 1
        else:
            Kk = params["conv_re_blocks"].shape[0] - 1
        part = _si.block_conv_parts(x_pad, nb, V, Kk, self.precision)
        parts = [part(params, "conv_re")[..., H0 : H0 + ny]]
        if not self.is_real:
            parts.append(part(params, "conv_im")[..., H0 : H0 + ny])
        return parts

    def _emit(self, stream, valid_end, u_end, max_frames: int):
        """Features ``(S, max_frames, C)`` for the frames ending ``u_end``
        counted samples before stream index ``valid_end`` (just past the
        newest valid sample).  Every row is computed; the caller masks
        rows past its frame count."""
        c = self.computer
        params = self._params
        s = self.shift
        ny = (max_frames + 1) * s
        # one gather pulls counted position 0 and its `hist` history taps
        # to the buffer front, so the conv output window and the energy
        # Diracs are static slices.  carry_len = hist + 2s and unconsumed
        # < 2s keep the start >= 1; the right overhang reads the zero pad
        # (frames there fall past the caller's count).
        H = self.hist
        rpad = ny + abs(self.shift_eff)
        padded = torch.nn.functional.pad(stream, (0, rpad))
        aligned = _window(padded, valid_end - u_end - H, H + ny)
        with _stft.ieee_float32():
            if self.conv_mode == "matmul":
                parts = self._conv_parts_matmul(aligned, ny)
            else:
                parts = self._conv_parts_fft(aligned, ny)
            if self.is_real:
                y = parts[0]
                y_mod = y * y if c._power else torch.abs(y)
            else:
                yr, yi = parts
                y_mod = yr * yr + yi * yi
                if not c._power:
                    y_mod = torch.sqrt(y_mod)
            if c._include_energy:
                # the energy Dirac at counted position q reads the aligned
                # buffer at hist - translation + q: static and in bounds
                off = H - self.translation
                xe = aligned[:, off : off + ny]
                e_mod = xe * xe if c._power else torch.abs(xe)
                y_mod = torch.cat([e_mod[:, None, :], y_mod], dim=1)
            # the overlapping 2s windows factor into s-blocks under the
            # window's two halves (the batch tail's form)
            S, nF = y_mod.shape[:2]
            blocks = y_mod.reshape(S, nF, max_frames + 1, s)
            w = params["window"]
            lo = torch.matmul(blocks, w[:s])
            hi = torch.matmul(blocks, w[s:])
        feats = (lo[..., :-1] + hi[..., 1:]).transpose(-1, -2)
        if c._log:
            feats = _stft.floor_log(feats, _config.LOG_FLOOR_VALUE)
        return feats

    def _process_streams(self, state: SIStreamState, chunk, v):
        C = chunk.shape[1]
        s, CL = self.shift, self.carry_len
        # zero the masked tail: valid frames never read past the newest
        # valid sample, but garbage must not reach any arithmetic
        chunk = torch.where(torch.arange(C, device=chunk.device)[None, :] < v[:, None], chunk, 0)
        stream = torch.cat([state.carry, chunk], dim=1)
        u = state.unconsumed + v
        max_frames = (2 * s + C) // s
        nf = torch.clamp(_floordiv(u, s) - 1, 0, max_frames)
        feats = self._emit(stream, CL + v, u, max_frames)
        carry = _window(stream, v, CL)
        new = SIStreamState(carry=carry, unconsumed=u - nf * s, seen=state.seen + v)
        return new, feats, nf

    def _finalize_streams(self, state: SIStreamState):
        s, T = self.shift, self.T
        seen = state.seen
        target = _floordiv(seen + s // 2, s)
        after_pad = _floordiv(target * s + T - 1 - self.shift_eff, s) - 1
        # frames already emitted: (seen - shift_eff - unconsumed) / s
        done = _floordiv(seen - self.shift_eff - state.unconsumed, s)
        total = torch.maximum(done, torch.minimum(target, after_pad))
        remaining = torch.clamp(total - done, max=self.fin_max)
        stream = torch.nn.functional.pad(state.carry, (0, self.fin_pad))
        u = state.unconsumed + self.fin_pad
        feats = self._emit(stream, torch.full_like(u, stream.shape[1]), u, self.fin_max)
        return feats, remaining


class PitchStreamState(NamedTuple):
    """Carry between chunks for the streaming pitch tracker."""

    stage: torch.Tensor  # (chunk_size,) staged valid samples (head-valid,
    # zero beyond n_stage) awaiting a full aligned chunk
    n_stage: torch.Tensor  # int64, valid samples at the START of `stage`
    raw_carry: torch.Tensor  # (raw_ctx,) most recent raw samples absorbed
    n_chunks: torch.Tensor  # int64, full aligned chunks absorbed so far
    n_raw: torch.Tensor  # int64, VALID raw samples absorbed
    sumsq: torch.Tensor  # running energy of valid work samples (ballast)
    wcount: torch.Tensor  # int64, valid work samples counted into sumsq
    wcarry: torch.Tensor  # (span - 1,) unconsumed work samples (tail-valid)
    n_wc: torch.Tensor  # int64, valid samples at the END of wcarry
    cost: torch.Tensor  # (n_lags,) Viterbi forward cost at the newest
    # frame, shifted so that its minimum is 0
    ring_ptr: torch.Tensor  # (ring_len, n_lags) int64 backpointers (newest last)
    ring_pov: torch.Tensor  # (ring_len, n_lags) ballast-free NCCF rows
    n_frames: torch.Tensor  # int64, frames absorbed into the Viterbi
    n_out: torch.Tensor  # int64, frames emitted so far


class StreamingPitch(_Streamer):
    """Explicit-carry streaming for the Kaldi-style pitch tracker.

    The chunked serving form of :func:`speech_tpu_torch.ops.pitch.kaldi_pitch`
    (the whole-utterance Viterbi), with the same ``(state, feats,
    n_valid)`` contract as the other streamers (feature columns ``[f0,
    nccf]``), masked chunks of any ``valid_len``, and the stream axis for
    concurrent sessions.  Stage by stage:

    - **Staging**: valid samples compact into a one-chunk staging buffer;
      absorption takes full aligned chunks only (the polyphase front end
      needs a fixed raw grid), and ``finalize`` absorbs the staged rest as
      the final partial chunk.  A ``valid_len`` of 0 leaves the state
      bitwise as it was.
    - **Front end** (resample to the work rate + lowpass) by overlap-save:
      the carry keeps the last ``raw_ctx`` raw samples and each absorbed
      chunk recomputes the products over ``[carry | chunk]`` (the batch
      path's matrices), emitting the work samples whose taps are all known,
      a constant ``delay_w`` behind; ``finalize`` flushes it.
    - **NCCF**: the carried ``span - 1`` work samples and the new block,
      framed by one gather and a strided view, then
      :func:`speech_tpu_torch.ops.pitch._nccf_from_frames`.  The energy
      ballast uses the RUNNING mean square of the work samples so far;
      ``ballast_ms`` freezes it.
    - **Lag search**: the Viterbi forward step runs frame by frame, each
      step's costs shifted by their minimum (which moves no argmin; the
      reference's unshifted costs grow by about one a frame and, in
      float32, lose the 1e-5 steps between neighbouring lags after about
      10 s).  The backpointer rows of a call go into one timeline per
      stream; each emission backtracks from the newest frame's best lag
      through the last ``ring_len`` rows and emits the OLDEST pending
      frames, each with at least ``lookahead_frames`` frames of future
      context.  ``finalize``'s frames are the offline optimum; with a
      lookahead covering the signal the whole track is.

    Latency: up to one chunk of staging, ``delay_w`` work samples and
    ``lookahead_frames`` frames.  ``dtype`` sets the float leaves; the
    tracker runs on ``device`` (:func:`~speech_tpu_torch.ops._device.resolve_device`).
    """

    def __init__(
        self,
        rate: float,
        chunk_size: int,
        lookahead_frames: int = 50,
        dtype=torch.float32,
        ballast_ms=None,
        min_f0: float = 50.0,
        max_f0: float = 400.0,
        frame_length_ms: float = 25.0,
        frame_shift_ms: float = 10.0,
        resample_rate=4000.0,
        lowpass_cutoff=1000.0,
        penalty_factor: float = 0.1,
        nccf_ballast: float = 1.0,
        soft_min_f0: float = 10.0,
        lag_resolution: float = 0.01,
        device=None,
    ):
        (
            self.work_rate,
            self.up,
            self.down,
            self.nccf_window,
            self.shift,
            self.tables,
        ) = _pitch._work_geometry(
            rate,
            min_f0,
            max_f0,
            frame_length_ms,
            frame_shift_ms,
            resample_rate,
            penalty_factor,
            lag_resolution,
        )
        self.chunk_size = int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        if self.chunk_size % self.down:
            raise ValueError(
                f"chunk_size must be a multiple of the resampling "
                f"denominator {self.down} (rate {rate} -> {resample_rate}); "
                f"got {self.chunk_size}"
            )
        self.lookahead = int(lookahead_frames)
        if self.lookahead < 0:
            raise ValueError("lookahead_frames must be >= 0")
        self._dtype = _torch_dtype(dtype)
        self.device = resolve_device(device)
        self.ballast_ms = None if ballast_ms is None else float(ballast_ms)
        self.nccf_ballast = float(nccf_ballast)
        self.lag_resolution = float(lag_resolution)
        self.soft_min_f0 = float(soft_min_f0)
        self.span = _pitch._nccf_span(self.nccf_window, self.tables)
        fine = self.tables[2]
        self.fine = fine
        self.n_lags = len(fine)
        self.lowpass_active = bool(lowpass_cutoff and lowpass_cutoff < self.work_rate / 2)
        self.lowpass_cutoff = float(lowpass_cutoff) if self.lowpass_active else None
        # lowpass FIR half-width (ops/pitch._lowpass_fir's fixed design)
        K2 = 32 if self.lowpass_active else 0
        L_, M_ = self.up, self.down
        N = self.chunk_size
        if (L_, M_) != (1, 1):
            phi_np, k_min = resample_matrices(L_, M_)
            self.w_width = phi_np.shape[1]
            self.phi_np = phi_np  # (up, W) host phases for fir_conv_matmul
        else:
            self.w_width, k_min, self.phi_np = 1, 0, None
        self.k_min = k_min
        self.work_per_chunk = N * L_ // M_
        Nw = self.work_per_chunk
        # emission delay (work samples): every emitted sample's lowpass
        # window and each window tap's resample raw window must lie in the
        # current buffer.  Start above K2 so that mid-stream emissions never
        # read the (finalize-time) valid-length zeroing region.
        D = K2 + 1
        while ((Nw - D - 1 + K2) // L_) * M_ + k_min + self.w_width - 1 > N - 1:
            D += 1
        self.delay_w = D
        # raw context: the oldest emitted sample's leftmost tap
        need = -((((-D - K2) // L_) * M_) + k_min)
        self.raw_ctx = -(-max(need, 0) // M_) * M_  # round up to blocks
        self.r_w = self.raw_ctx * L_ // M_
        self.off = self.r_w - D  # emitted slice's static work-buffer offset
        self.n_blocks = (self.raw_ctx + N) // M_
        self.n_work_buf = self.n_blocks * L_
        self.pad_l = -k_min
        self.pad_r = max(
            (self.n_blocks - 1) * M_ + k_min + self.w_width - (self.raw_ctx + N), 0
        )
        self.max_frames_chunk = (Nw - 1) // self.shift + 1
        self.k_flush = -(-D // Nw)
        # finalize absorbs the staged remainder plus k_flush zero chunks
        # without emitting; the backtrack window must reach every frame
        # across that
        self.ring_len = self.lookahead + (1 + self.k_flush) * self.max_frames_chunk
        dt, dev = self._dtype, self.device
        self.tmat = host_constant(self.tables[4], dt, dev)
        self.soft = host_constant(
            _pitch._soft_discount(fine, self.work_rate, self.soft_min_f0), dt, dev
        )
        # one flush of an empty session copies the device tables of the
        # front end, the NCCF and the refinement, so that no tick does
        self._finalize_impl(self.init_state())

    def init_state(self, streams=None) -> PitchStreamState:
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        lead = () if streams is None else (int(streams),)
        Lf, RL = self.n_lags, self.ring_len
        dt, dev = self._dtype, self.device

        def zeros(shape=(), dtype=dt):
            return torch.zeros(lead + shape, dtype=dtype, device=dev)

        count = torch.int64
        return PitchStreamState(
            stage=zeros((self.chunk_size,)),
            n_stage=zeros(dtype=count),
            raw_carry=zeros((self.raw_ctx,)),
            n_chunks=zeros(dtype=count),
            n_raw=zeros(dtype=count),
            sumsq=zeros(),
            wcount=zeros(dtype=count),
            wcarry=zeros((self.span - 1,)),
            n_wc=zeros(dtype=count),
            cost=zeros((Lf,)),
            ring_ptr=zeros((RL, Lf), count),
            ring_pov=zeros((RL, Lf)),
            n_frames=zeros(dtype=count),
            n_out=zeros(dtype=count),
        )

    # ------------------------------------------------------------------

    def _front(self, buf):
        """Resampled work samples of the raw buffers (the absolute work
        index of output 0 is ``n_chunks*work_per_chunk - r_w``)."""
        if self.up == 1 and self.down == 1:
            return buf
        return fir_conv_matmul(
            buf, self.phi_np, stride=self.down, pad_left=self.pad_l, n_out=self.n_work_buf
        )

    def _timeline(self, state: PitchStreamState, frames: int):
        """Per stream, the backpointer and NCCF rows of the ring (oldest
        first) followed by room for ``frames`` new rows and one row that
        takes the writes of frames that do not count."""
        S = state.ring_ptr.shape[0]
        extra = (S, frames + 1, self.n_lags)
        return (
            torch.cat([state.ring_ptr, state.ring_ptr.new_zeros(extra)], dim=1),
            torch.cat([state.ring_pov, state.ring_pov.new_zeros(extra)], dim=1),
        )

    def _absorb(self, state: PitchStreamState, chunk, v, advance, timeline, base):
        """Absorb ONE grid-aligned chunk per stream (front end, framing,
        NCCF, Viterbi steps); no emission.  Streams whose ``advance`` is
        False keep every leaf bitwise; each counted frame's rows go into
        ``timeline`` at ``ring_len + n_frames - base``."""
        N, Nw = self.chunk_size, self.work_per_chunk
        S = chunk.shape[0]
        dev = chunk.device
        v = torch.clamp(v, 0, N)
        chunk = torch.where(torch.arange(N, device=dev)[None, :] < v[:, None], chunk, 0)
        buf = torch.cat([state.raw_carry, chunk], dim=1)
        c = state.n_chunks
        n_raw = state.n_raw + v
        # valid resampled length so far (batch: ceil(len * up / down))
        s_w_valid = _floordiv(n_raw * self.up + self.down - 1, self.down)
        work = self._front(buf)
        # zero outside the valid resampled extent before the lowpass: past
        # ceil(len*up/down) as the batch tracker re-zeroes (only the final
        # flush sees it), and before work sample 0, where the batch lowpass
        # reads zeros
        a_w0 = c * Nw - self.r_w  # absolute work index of work[:, 0]
        idx = torch.arange(work.shape[1], device=dev)[None, :] + a_w0[:, None]
        work = torch.where((idx >= 0) & (idx < s_w_valid[:, None]), work, 0)
        if self.lowpass_active:
            work = _pitch._lowpass(work, self.work_rate, self.lowpass_cutoff)
        emit = work[:, self.off : self.off + Nw]
        e0 = c * Nw - self.delay_w  # absolute work index of emit[:, 0]
        pos = torch.arange(Nw, device=dev)[None, :] + e0[:, None]
        vmask = (pos >= 0) & (pos < s_w_valid[:, None])
        sumsq = state.sumsq + torch.sum(torch.where(vmask, emit * emit, 0), dim=1)
        dv = vmask.sum(dim=1)
        wcount = state.wcount + dv
        # the valid part of `emit` is contiguous [lo, hi); lo > 0 only
        # before any valid work existed (the carry is empty then)
        hi_loc = torch.clamp(s_w_valid - e0, 0, Nw)
        CL = self.span - 1
        stream = torch.cat([state.wcarry, emit], dim=1)
        total = state.n_wc + dv
        valid_end = CL + hi_loc
        nf = torch.clamp_min(_floordiv(total - self.span, self.shift) + 1, 0)
        F = self.max_frames_chunk
        win_len = (F - 1) * self.shift + self.span
        windowed = _window(torch.nn.functional.pad(stream, (0, win_len)), valid_end - total, win_len)
        frames = frame_padded(windowed, F, self.span, self.shift)
        if self.ballast_ms is not None:
            ms = torch.full((S,), self.ballast_ms, dtype=self._dtype, device=dev)
        else:
            ms = sumsq / torch.clamp_min(wcount, 1)
        ballast = self.nccf_ballast * self.nccf_window * ms
        nc_p, nc_v = _pitch._nccf_from_frames(frames, self.nccf_window, self.tables, ballast)
        fvalid = (torch.arange(F, device=dev)[None, :] < nf[:, None]) & advance[:, None]
        nc_eff = nc_p * self.soft
        ptr_tl, pov_tl = timeline
        trash = ptr_tl.shape[1] - 1
        lags = torch.arange(self.n_lags, device=dev)
        cost, n_frames = state.cost, state.n_frames
        for f in range(F):
            ok = fvalid[:, f]
            nc_row = nc_eff[:, f]
            tot = cost[:, :, None] + self.tmat
            ptr = torch.argmin(tot, dim=1)  # the first index of a tie
            cost2 = torch.amin(tot, dim=1) - nc_row
            first = (n_frames == 0)[:, None]
            cost2 = torch.where(first, -nc_row, cost2)
            ptr = torch.where(first, lags, ptr)
            cost2 = cost2 - torch.amin(cost2, dim=1, keepdim=True)
            row = torch.where(ok, self.ring_len + n_frames - base, trash)
            row = row[:, None, None].expand(S, 1, self.n_lags)
            ptr_tl.scatter_(1, row, ptr[:, None, :])
            pov_tl.scatter_(1, row, nc_v[:, f][:, None, :])
            cost = torch.where(ok[:, None], cost2, cost)
            n_frames = n_frames + ok
        rem = torch.clamp(total - nf * self.shift, 0, CL)
        wcarry = _window(stream, valid_end - CL, CL)
        new = state._replace(
            raw_carry=buf[:, N:],
            n_chunks=c + 1,
            n_raw=n_raw,
            sumsq=sumsq,
            wcount=wcount,
            wcarry=wcarry,
            n_wc=rem,
            cost=cost,
            n_frames=n_frames,
        )
        return _tree_where(advance, new, state)

    def _emit_tracks(self, timeline, cost, end, pending, e, out_n: int):
        """Backtrack from each snapshot's best lag through the last
        ``ring_len`` timeline rows before ``end`` and emit the OLDEST ``e``
        of its ``pending`` frames, refined to sub-grid lags.  ``cost (K, S,
        L)``, ``end``, ``pending``, ``e`` ``(K, S)``: one loop of
        ``ring_len`` steps serves every snapshot.  Returns ``(f0, nccf)``,
        ``(K, S, out_n)`` each, rows ``>= e`` zeroed."""
        ptr_tl, pov_tl = timeline
        S, T, Lf = ptr_tl.shape
        RL = self.ring_len
        dev = cost.device
        j = torch.argmin(cost, dim=-1)
        first_row = torch.arange(S, device=dev) * T + end - RL  # (K, S)
        flat = ptr_tl.reshape(-1)
        path = [None] * RL
        for r in reversed(range(RL)):
            path[r] = j
            j = flat[(first_row + r) * Lf + j]
        path = torch.stack(path, dim=-1)  # (K, S, RL)
        start = torch.clamp(RL - pending, 0, RL)
        q = start[..., None] + torch.arange(out_n, device=dev)
        in_ring = q < RL
        qc = torch.clamp(q, max=RL - 1)
        p = torch.where(in_ring, torch.gather(path, -1, qc), 0)
        pv = pov_tl.reshape(S * T, Lf)[first_row[..., None] + qc]
        pv = torch.where(in_ring[..., None], pv, 0)
        f0, nccf = _pitch._refine_lags(p, pv, self.work_rate, self.fine, self.lag_resolution)
        ok = torch.arange(out_n, device=dev) < e[..., None]
        return torch.where(ok, f0, 0), torch.where(ok, nccf, 0)

    def _ring(self, timeline, end):
        """The state's ring: the last ``ring_len`` rows before ``end``."""
        return tuple(_window(t, end - self.ring_len, self.ring_len) for t in timeline)

    def _process_streams(self, state: PitchStreamState, samples, v):
        """Stage + absorb full chunks + emit; ``samples (S, W)`` with ``W``
        any multiple of ``chunk_size`` (a wide buffer drains a backlog in
        one call).  Returns ``(state, feats (S, capacity, 2), n_valid)``
        with columns ``[f0, nccf]``."""
        N = self.chunk_size
        S, W = samples.shape
        k_steps = W // N
        F = self.max_frames_chunk
        out_n = max(k_steps, 1) * F
        dev = samples.device
        samples = torch.where(torch.arange(W, device=dev)[None, :] < v[:, None], samples, 0)
        # compact the valid prefix onto the staged samples (both are zero
        # past their counts, so the paste keeps the zero invariant)
        combined = _paste(
            torch.nn.functional.pad(state.stage, (0, W)), samples, state.n_stage
        )
        total_in = state.n_stage + v
        full = _floordiv(total_in, N)
        f0b = samples.new_zeros((S, out_n + 1))
        ncb = samples.new_zeros((S, out_n + 1))
        ne = torch.zeros(S, dtype=torch.int64, device=dev)
        if k_steps:
            # absorb every chunk first, keeping each one's emission inputs
            # (cost, timeline end, pending, count), then backtrack them all
            # in one loop
            timeline = self._timeline(state, k_steps * F)
            base = state.n_frames
            snaps = []
            for i in range(k_steps):
                state = self._absorb(
                    state, combined[:, i * N : (i + 1) * N], torch.full_like(v, N), i < full,
                    timeline, base,
                )
                pending = state.n_frames - state.n_out
                e = torch.clamp(pending - self.lookahead, 0, F)
                state = state._replace(n_out=state.n_out + e)
                snaps.append((state.cost, self.ring_len + state.n_frames - base, pending, e))
            costs, ends, pendings, es = (torch.stack(x) for x in zip(*snaps))
            f0s, ncs = self._emit_tracks(timeline, costs, ends, pendings, es, F)
            # chunk i's first e_i rows go to rows [ne_i, ne_i + e_i); the
            # rest to the spare column out_n
            ne_i = torch.cumsum(es, dim=0) - es
            rows = ne_i[..., None] + torch.arange(F, device=dev)
            rows = torch.where(torch.arange(F, device=dev) < es[..., None], rows, out_n)
            rows = rows.permute(1, 0, 2).reshape(S, -1)
            f0b.scatter_(1, rows, f0s.permute(1, 0, 2).reshape(S, -1))
            ncb.scatter_(1, rows, ncs.permute(1, 0, 2).reshape(S, -1))
            ne = es.sum(dim=0)
            ring_ptr, ring_pov = self._ring(timeline, ends[-1])
            state = state._replace(ring_ptr=ring_ptr, ring_pov=ring_pov)
        stage = _window(combined, full * N, N)
        state = state._replace(stage=stage, n_stage=total_in - full * N)
        feats = torch.stack([f0b[:, :out_n], ncb[:, :out_n]], dim=-1)
        return state, feats, ne

    def _finalize_streams(self, state: PitchStreamState):
        """Absorb the staged remainder as the final (masked) chunk, flush
        the front end's delay with zero chunks, and emit every pending
        frame: the tail is the offline Viterbi optimum.  Returns ``(feats
        (S, ring_len, 2), n_valid)``."""
        F = self.max_frames_chunk
        timeline = self._timeline(state, (1 + self.k_flush) * F)
        base = state.n_frames
        every = torch.ones_like(state.n_raw, dtype=torch.bool)
        state = self._absorb(state, state.stage, state.n_stage, every, timeline, base)
        zeros = torch.zeros_like(state.stage)
        for _ in range(self.k_flush):
            state = self._absorb(state, zeros, torch.zeros_like(state.n_raw), every, timeline, base)
        pending = state.n_frames - state.n_out
        end = self.ring_len + state.n_frames - base
        f0, nccf = self._emit_tracks(
            timeline, state.cost[None], end[None], pending[None], pending[None], self.ring_len
        )
        return torch.stack([f0[0], nccf[0]], dim=-1), pending

    # public entry points --------------------------------------------------

    def process(self, state: PitchStreamState, samples, valid_len=None):
        """Consume a sample buffer (width any multiple of ``chunk_size``;
        ``(S, W)`` on the stream axis); returns ``(state, track)`` with
        ``track`` a prefix-valid :class:`~speech_tpu_torch.ops.pitch.PitchTrack`.

        ``valid_len`` marks the real prefix (default: all); any chunking
        streams: short valids stage until a full aligned chunk
        accumulates."""
        W = samples.shape[-1]
        if W < self.chunk_size or W % self.chunk_size:
            raise ValueError(
                f"sample buffers must be a multiple of chunk_size "
                f"({self.chunk_size}); got {W} (zero-pad and pass "
                f"valid_len instead)"
            )
        if valid_len is None:
            valid_len = W
        state, feats, ne = self._process_impl(state, samples, valid_len)
        return state, self._track(feats, ne)

    def _track(self, feats, ne):
        valid = torch.arange(feats.shape[-2], device=feats.device) < ne[..., None]
        return _pitch.PitchTrack(feats[..., 0], feats[..., 1], valid)

    def finalize(self, state: PitchStreamState):
        """Flush staging, the front-end delay and the Viterbi lookahead;
        returns the final prefix-valid :class:`~speech_tpu_torch.ops.pitch.PitchTrack`,
        whose frames are the offline optimum."""
        feats, ne = self._finalize_impl(state)
        return self._track(feats, ne)

    def transform(self, signal: np.ndarray):
        """Stream a whole signal via :meth:`scan` and return the compacted
        ``(f0, nccf)`` numpy arrays (testing helper)."""
        out = self._compacted(signal)
        return out[:, 0], out[:, 1]


class AppendPitchState(NamedTuple):
    """Carry between chunks for :class:`StreamingAppendPitch`."""

    fbank: StreamState  # the filter-bank stream's
    pitch: tuple  # (PitchStreamState, the process-pitch step's carry)
    held: torch.Tensor  # (hold_len, num_coeffs) filter-bank rows awaiting
    # their pitch columns (head-valid, zero beyond n_held)
    n_held: torch.Tensor  # int64


class StreamingAppendPitch(_FrameStreamer):
    """An STFT computer's filter-bank rows with the three online Kaldi
    pitch columns pasted on: Kaldi online2's feature pipeline with
    ``add_pitch``, where ``OnlineAppendFeature`` joins the base features to
    ``OnlineProcessPitch`` over ``OnlinePitchFeature``.

    One state and one ``_process_impl`` per tick on the stream axis, as the
    other streamers (:class:`~speech_tpu_torch.serve.StreamPool` takes it as
    its computer).  A tick runs

    - the filter bank: :class:`StreamingSTFT`'s own rows, bit for bit;
    - the pitch: :class:`StreamingPitch` (``[f0, nccf]`` rows, emitted once
      ``lookahead_frames`` frames follow them), then
      :class:`~speech_tpu_torch.streaming_post.StreamingProcessPitch` (POV,
      normalised log pitch over the rows that have arrived, delta), which
      holds back ``delta_window`` rows more;
    - the join: filter-bank rows wait in ``held`` until their pitch columns
      exist, and go out with them.  ``finalize`` flushes both, and the rows
      past the track (it ends 2-3 frames before the filter bank) repeat its
      last row's columns, zeros with no track, as the batch path's paste.

    ``pitch`` is a configuration's ``"pitch"`` block: the keyword arguments
    of :class:`StreamingPitch` (``lookahead_frames`` included) and of the
    process step (``normalization_window``, ``delta_window``).  The
    tracker runs on the computer's device in its dtype.

    A valid-0 step leaves the state bitwise as it was, and a tick queues no
    host synchronisation.  The pitch share of a tick runs inside a
    ``record_function("stream.pitch")`` range and the filter bank's inside
    ``"stream.fbank"``; :attr:`stats` counts the tracker's frames.
    """

    _counter = "n_held"

    def __init__(self, computer: ShortTimeFourierTransformFrameComputer, pitch: dict,
                 chunk_size: int = 1600):
        from .streaming_post import StreamingProcessPitch

        pitch = dict(pitch)
        post = {k: pitch.pop(k) for k in ("normalization_window", "delta_window") if k in pitch}
        self.fbank = StreamingSTFT(computer, chunk_size)
        self.tracker = StreamingPitch(computer.sampling_rate, chunk_size, dtype=computer._dtype,
                                      device=computer.device, **pitch)
        self.process = StreamingProcessPitch(**post, device=self.tracker.device)
        self.computer = computer
        self.chunk_size = self.fbank.chunk_size
        self.device = self.fbank.device
        self._dtype = self.fbank._dtype
        self.num_coeffs = computer.num_coeffs + 3
        tr, fb = self.tracker, self.fbank
        if tr.shift * tr.down != fb.frame_shift * tr.up:
            raise ValueError(
                f"the pitch frame shift ({tr.shift} samples at {tr.work_rate} Hz) is not the "
                f"filter bank's ({fb.frame_shift} samples)")
        if tr.span * tr.down < (fb.frame_length - fb.pad_left) * tr.up:
            # a pitch frame would end before the filter bank's frame of the
            # same index, and its columns could come before its row
            raise ValueError("a pitch frame spans less input than a filter-bank frame")
        # the most filter-bank rows that can wait: the frames the filter
        # bank has ahead of the tracker's absorbed ones (a staged chunk, the
        # front end's delay and a pitch frame's span, in input samples, and
        # two for the floors of both frame counts), the tracker's lookahead
        # and the delta's right context, and one spare
        ahead = fb.pad_left - fb.frame_length + self.chunk_size - 1 + (
            (tr.delay_w + tr.span) * tr.down + tr.up - 1) // tr.up
        self.hold_len = -(-ahead // fb.frame_shift) + 3 + tr.lookahead + self.process.delta_window
        self._counts = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._stepped = self._backtracked = 0

    @property
    def stats(self) -> dict:
        """The tracker's frames since construction (read back from the
        card; the ticks only queue their counts):
        ``pitch_frames_tracked``, frames absorbed into the Viterbi in the
        sessions' rows; ``pitch_frames_stepped``, rows times frames the
        Viterbi loop stepped over, masked rows included;
        ``pitch_frames_emitted``, track frames the tracker emitted;
        ``pitch_backtrack_steps``, rows times the backtrack loop's steps."""
        tracked, emitted = self._counts.tolist()
        return {"pitch_frames_tracked": tracked, "pitch_frames_stepped": self._stepped,
                "pitch_frames_emitted": emitted, "pitch_backtrack_steps": self._backtracked}

    def init_state(self, streams=None) -> AppendPitchState:
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        lead = () if streams is None else (int(streams),)
        return AppendPitchState(
            fbank=self.fbank.init_state(streams),
            pitch=(self.tracker.init_state(streams),
                   self.process.init_state(2, self._dtype, streams)),
            held=torch.zeros(lead + (self.hold_len, self.computer.num_coeffs), dtype=self._dtype,
                             device=self.device),
            n_held=torch.zeros(lead, dtype=torch.int64, device=self.device),
        )

    def _count(self, tracked, emitted, streams: int, chunks: int, snapshots: int):
        tr = self.tracker
        self._stepped += streams * chunks * tr.max_frames_chunk
        self._backtracked += streams * snapshots * tr.ring_len
        self._counts += torch.stack([tracked.sum(), emitted.sum()])

    def _pitch_step(self, state, chunk, v):
        """The pitch share of a tick: the tracker, then the process step;
        returns ``(state, columns (S, cap, 3), n)``."""
        with record_function("stream.pitch"):
            track, post = state
            new, rows, ne = self.tracker._process_streams(track, chunk, v)
            post, cols, nc = self.process._step_streams(post, rows, ne)
            k = chunk.shape[1] // self.chunk_size
            self._count(new.n_frames - track.n_frames, ne, chunk.shape[0], k, k)
        return (new, post), cols, nc

    def _pitch_finalize(self, state):
        with record_function("stream.pitch"):
            track, post = state
            rows, pending = self.tracker._finalize_streams(track)
            post, c1, n1 = self.process._step_streams(post, rows, pending)
            c2, n2 = self.process._finalize_streams(post)
            cols = _paste(torch.nn.functional.pad(_scrub(c1, n1)[0], (0, 0, 0, c2.shape[1])),
                          c2, n1)
            # the frames finalize absorbed: all it emits less those pending before
            tracked = pending - (track.n_frames - track.n_out)
            self._count(tracked, pending, pending.shape[0], 1 + self.tracker.k_flush, 1)
        return cols, n1 + n2

    def _joined(self, state, fb, nf, rows: int):
        """The held rows followed by the new filter-bank rows ``fb``, at
        least ``rows`` of them, and their count."""
        block = _scrub(fb, nf)[0]
        pad = max(block.shape[1], rows - self.hold_len)
        joined = _paste(torch.nn.functional.pad(state.held, (0, 0, 0, pad)), block, state.n_held)
        return joined, state.n_held + nf

    def _process_streams(self, state: AppendPitchState, chunk, v):
        if chunk.shape[1] % self.chunk_size:
            raise ValueError(
                f"sample buffers must be a multiple of chunk_size ({self.chunk_size}); "
                f"got {chunk.shape[1]}")
        with record_function("stream.fbank"):
            fb_state, fb, nf = self.fbank._process_streams(state.fbank, chunk, v)
        pitch, cols, nc = self._pitch_step(state.pitch, chunk, v)
        cap = cols.shape[1]
        joined, total = self._joined(state, fb, nf, cap)
        # every row with its pitch columns goes out: the track never leads
        # the filter bank, so nc <= total
        out = torch.cat([joined[:, :cap], cols], dim=-1)
        held = _window(joined, nc, self.hold_len)
        return AppendPitchState(fb_state, pitch, held, total - nc), out, nc

    def _finalize_streams(self, state: AppendPitchState):
        with record_function("stream.fbank"):
            fb, nf = self.fbank._finalize_streams(state.fbank)
        cols, nc = self._pitch_finalize(state.pitch)
        joined, total = self._joined(state, fb, nf, 0)
        R, cap = joined.shape[1], cols.shape[1]
        j = torch.arange(R, device=joined.device)[None, :]
        # past the track, its last row (zeros with no track)
        last = _take_rows(cols, torch.clamp(nc - 1, 0, cap - 1)[:, None])
        last = torch.where((nc > 0)[:, None, None], last, 0)
        pitch = torch.where((j < nc[:, None])[..., None],
                            _take_rows(cols, torch.clamp(j, max=cap - 1).expand(cols.shape[0], R)),
                            last)
        out = _scrub(torch.cat([joined, pitch], dim=-1), total)[0]
        return out, total
