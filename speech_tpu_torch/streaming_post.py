"""Explicit-carry streaming post-processing: online deltas, CMVN, PCEN, ...

The counterpart of :mod:`speech_tpu.streaming_post`.  The batch pipelines
apply post-processors over whole feature matrices (:mod:`speech_tpu_torch.post`
on the host, :mod:`speech_tpu_torch.ops.postops` on the device); a server
consumes features online, and deltas, sliding CMVN and splicing need
lookahead-bounded streaming forms.  They are built like
:mod:`speech_tpu_torch.streaming`: state is a tuple of tensors of static
shapes, ``_step_impl`` / ``_finalize_impl`` are pure, a ``valid 0`` step
leaves the state bitwise as it was, and frame blocks are prefix-valid
``(capacity, F)`` buffers with a valid count.  On the stream axis blocks
are ``(S, capacity, F)`` and counts ``(S,)``; ``init_state(...,
streams=S)`` gives every state leaf that leading axis.

Semantics: every step's valid rows plus the finalize flush equal the batch
post-op over the full feature matrix: exactly for the frame-local and
integral ops (splice, stack, DCT, PLP, standardize), to reduction roundoff
for the windowed and recursive ones (deltas, sliding CMVN, PCEN).  The ops
with lookahead (deltas, splice, centered sliding CMVN) emit late and flush
on finalize.

:class:`StreamingPipeline` fuses a signal streamer (:class:`~speech_tpu_torch.streaming.StreamingSTFT`,
``SI`` or ``Pitch``) with a post chain and honours the streamer contract.
Each op runs on ``device`` (:func:`~speech_tpu_torch.ops._device.resolve_device`:
the GPU unless named); its float dtype is the one ``init_state`` is given,
which a pipeline takes from its streamer.  Host tables (PCEN's parameters,
the frame-local ops' matrices) go to the device on an op's first step and
are shared after it (:func:`~speech_tpu_torch.ops._device.host_constant`),
so that later steps copy nothing from the host.
"""

import abc

import numpy as np
import torch

from .ops import postops as _postops
from .ops._device import host_constant, resolve_device
from .ops.pitch import nccf_to_pov
from .ops.plp import plp as _plp
from .ops.postops import _linear_scan, _pcen_compress, delta_filters
from .ops.stft import ieee_float32
from .streaming import (
    _counts,
    _drop,
    _floordiv,
    _lift,
    _paste,
    _scrub,
    _take_rows,
    _torch_dtype,
    _tree_leaves,
    _window,
)

__all__ = [
    "StreamingDeltas",
    "StreamingFrameLocal",
    "StreamingPCEN",
    "StreamingPipeline",
    "StreamingPostChain",
    "StreamingPostOp",
    "StreamingProcessPitch",
    "StreamingSlidingCMVN",
    "StreamingSplice",
    "StreamingStack",
    "StreamingVAD",
    "streaming_post_op",
]


def _lead(streams):
    return () if streams is None else (int(streams),)


class StreamingPostOp(abc.ABC):
    """One post-processor's streaming twin.

    Subclasses implement ``_step_streams(state, frames (S, cap, F), nin
    (S,))`` and ``_finalize_streams(state)`` on the stream axis, plus the
    static capacities (``step_cap`` / ``fin_cap`` / ``out_width``) the
    chain sizes its buffers by.  ``_step_impl`` / ``_finalize_impl`` take
    the single-stream form (``(cap, F)`` blocks, scalar counts) or the
    stream axis.
    """

    #: index of a state leaf that is a per-stream scalar
    _counter = 1

    def __init__(self, device=None):
        self.device = resolve_device(device)

    @abc.abstractmethod
    def out_width(self, in_width: int) -> int:
        """Feature width of the output given the input width."""

    def step_cap(self, in_cap: int) -> int:
        """Max valid output rows for a step of ``in_cap`` input rows."""
        return in_cap

    def fin_cap(self) -> int:
        """Max valid output rows from :meth:`_finalize_impl`."""
        return 0

    @abc.abstractmethod
    def init_state(self, in_width: int, dtype, streams=None):
        """Fresh carry for ``in_width``-wide input frames, its float leaves
        of ``dtype``; ``streams`` gives every leaf a leading axis."""

    @abc.abstractmethod
    def _step_streams(self, state, frames, nin):
        ...

    def _single(self, state) -> bool:
        return state[self._counter].dim() == 0

    def _step_impl(self, state, frames, n_valid):
        """One block: ``(state, out, n_out)``."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.as_tensor(np.asarray(frames), device=self.device)
        single = frames.dim() == 2
        if single:
            state, frames = _lift(state), frames[None]
        nin = _counts(n_valid, frames.shape[0], frames.shape[1], frames.device)
        out = self._step_streams(state, frames, nin)
        return _drop(out) if single else out

    def _finalize_impl(self, state):
        """The flush: ``(out, n_out)``."""
        single = self._single(state)
        out = self._finalize_streams(_lift(state) if single else state)
        return _drop(out) if single else out

    def _finalize_streams(self, state):
        leaves = _tree_leaves(state)
        floats = [leaf for leaf in leaves if leaf.is_floating_point()]
        S = leaves[0].shape[0]
        out = floats[0].new_zeros((S, 0, self._fin_width(state)))
        return out, torch.zeros(S, dtype=torch.int64, device=out.device)

    def _fin_width(self, state) -> int:
        raise NotImplementedError  # only ops with fin_cap() == 0 need it

    def _empty(self, frames, width: int):
        """The output of a zero-capacity step."""
        S = frames.shape[0]
        return frames.new_zeros((S, 0, width)), torch.zeros(
            S, dtype=torch.int64, device=frames.device
        )


class _FIREdgeOp(StreamingPostOp):
    """Shared machinery for time-FIR ops with edge-replication padding.

    Covers :class:`StreamingDeltas` and :class:`StreamingSplice`: output
    frame ``o`` is a function of the ``K = left + right + 1`` input frames
    ``[o-left, o+right]``, positions before frame 0 replicating frame 0 and
    positions past the last frame replicating it (``np.pad(mode="edge")``
    in the batch forms).  Emission is ``right`` frames late; ``finalize``
    flushes the tail against the replicated last frame.

    The carry holds the last ``left + right`` frames of the virtual
    (edge-extended) stream; when the first frame arrives the carry fills
    with it, which realises the left edge.  Outputs come from one gather
    aligning the valid region, then ``K`` static shifted slices.
    """

    def __init__(self, left: int, right: int, device=None):
        if left < 0 or right < 0:
            raise ValueError(f"left/right must be >= 0, got {left}/{right}")
        super().__init__(device)
        self.left = int(left)
        self.right = int(right)
        self._cl = self.left + self.right  # carried virtual frames

    def fin_cap(self) -> int:
        return self.right

    @abc.abstractmethod
    def _combine(self, slices):
        """Output block from the ``K`` shifted ``(S, cap, F)`` slices
        (oldest tap first)."""

    def init_state(self, in_width: int, dtype, streams=None):
        lead, dev = _lead(streams), self.device
        return (
            torch.zeros(lead + (self._cl, in_width), dtype=_torch_dtype(dtype), device=dev),
            torch.zeros(lead, dtype=torch.int64, device=dev),  # frames seen
            torch.ones(lead, dtype=torch.bool, device=dev),  # left edge pending
        )

    def _windows(self, stream_p, base, cap_out: int):
        K = self._cl + 1
        window = _window(stream_p, base, cap_out + K - 1)
        return [window[:, k : k + cap_out] for k in range(K)]

    def _step_streams(self, state, frames, nin):
        buf, seen, is_first = state
        frames, nin = _scrub(frames, nin)
        S, cap, F = frames.shape
        if cap == 0:
            return (state,) + self._empty(frames, self.out_width(F))
        CL, R = self._cl, self.right
        buf = buf.to(frames.dtype)
        if CL:
            prefill = frames[:, :1].expand(buf.shape)
            buf = torch.where((is_first & (nin > 0))[:, None, None], prefill, buf)
        stream = torch.cat([buf, frames], dim=1)
        old_em = torch.clamp_min(seen - R, 0)
        new_em = torch.clamp_min(seen + nin - R, 0)
        # output o reads virtual frames [o-left, o+right]; virtual frame t
        # sits at stream row t - seen + CL
        base = old_em - self.left - seen + CL
        stream_p = torch.nn.functional.pad(stream, (0, 0, 0, R)) if R else stream
        out = self._combine(self._windows(stream_p, base, cap))
        new_buf = _window(stream, nin, CL) if CL else buf
        return (new_buf, seen + nin, is_first & (nin == 0)), out, new_em - old_em

    def _finalize_streams(self, state):
        buf, seen, _ = state
        CL, R = self._cl, self.right
        S, _, F = buf.shape
        if R == 0:
            return self._empty(buf, self.out_width(F))
        last = buf[:, -1:]  # frame seen-1 (tail-valid; zeros when seen == 0)
        fin_stream = torch.cat([buf, last.expand(S, R, F), buf.new_zeros((S, R, F))], dim=1)
        old_em = torch.clamp_min(seen - R, 0)
        base = old_em - self.left - seen + CL
        return self._combine(self._windows(fin_stream, base, R)), seen - old_em


class StreamingDeltas(_FIREdgeOp):
    """Online :class:`speech_tpu_torch.post.Deltas` (edge padding, the
    concatenating form): emits ``[x | d1 | .. | dN]`` rows
    ``num_deltas * context_window`` frames late; equal to the batch op to
    reduction roundoff."""

    def __init__(self, num_deltas: int, context_window: int = 2, device=None):
        if num_deltas < 1:
            raise ValueError(f"num_deltas must be >= 1, got {num_deltas}")
        if context_window < 1:
            raise ValueError(f"context_window must be >= 1, got {context_window}")
        self.num_deltas = int(num_deltas)
        self.context_window = int(context_window)
        D = self.num_deltas * self.context_window
        super().__init__(D, D, device)
        # per-order taps over the full [-D, D] window (order 0: identity)
        coeffs = np.zeros((self.num_deltas + 1, 2 * D + 1))
        coeffs[0, D] = 1.0
        for d, filt in enumerate(delta_filters(self.num_deltas, self.context_window), start=1):
            off = D - d * self.context_window
            coeffs[d, off : off + len(filt)] = filt
        self._coeffs = coeffs

    def out_width(self, in_width: int) -> int:
        return in_width * (self.num_deltas + 1)

    def _combine(self, slices):
        outs = []
        for row in self._coeffs:
            acc = None
            for k, c in enumerate(row):
                if c == 0.0:
                    continue
                # a Python number enters at the tensor's dtype, as the
                # reference's dtype.type(c)
                term = slices[k] * float(c)
                acc = term if acc is None else acc + term
            outs.append(acc)
        return torch.cat(outs, dim=-1)


class StreamingSplice(_FIREdgeOp):
    """Online :class:`speech_tpu_torch.post.Splice` (Kaldi ``splice-feats``):
    emits ``[x[o-left] | .. | x[o+right]]`` rows ``right`` frames late;
    bitwise equal to the batch op."""

    def out_width(self, in_width: int) -> int:
        return in_width * (self.left + self.right + 1)

    def _combine(self, slices):
        return torch.cat(slices, dim=-1)


class StreamingFrameLocal(StreamingPostOp):
    """Streaming twin of any frame-local (stateless along time) op.

    ``fn`` maps a ``(..., n, F)`` block to ``(..., n, F')`` rows
    independently, e.g. :func:`speech_tpu_torch.ops.postops.dct`; the
    stream equals the batch op.  ``width_fn`` maps the input width to the
    output width (identity by default).
    """

    def __init__(self, fn, width_fn=None, device=None):
        super().__init__(device)
        self._fn = fn
        self._width_fn = width_fn or (lambda w: w)

    def out_width(self, in_width: int) -> int:
        return self._width_fn(in_width)

    def init_state(self, in_width: int, dtype, streams=None):
        # a width/dtype breadcrumb
        shape = _lead(streams) + (0, in_width)
        return torch.zeros(shape, dtype=_torch_dtype(dtype), device=self.device)

    def _single(self, state) -> bool:
        return state.dim() == 2

    def _fin_width(self, state) -> int:
        return self.out_width(state.shape[-1])

    def _step_streams(self, state, frames, nin):
        frames, nin = _scrub(frames, nin)
        if frames.shape[1] == 0:
            return (state,) + self._empty(frames, self.out_width(frames.shape[2]))
        return state, self._fn(frames), nin


class StreamingPCEN(StreamingPostOp):
    """Online :class:`speech_tpu_torch.post.PCEN`: the per-channel IIR
    smoother carries across chunks (``M_{-1}`` is the first frame's energy,
    as the batch op starts), and the compression shares
    :func:`speech_tpu_torch.ops.postops.pcen`'s formulation.  No lookahead;
    equal to the batch op to reduction roundoff (the smoother is a prefix
    scan, :func:`~speech_tpu_torch.ops.postops._linear_scan`, which the
    stream re-associates at chunk boundaries).
    """

    def __init__(self, smooth=0.025, alpha=0.98, delta=2.0, power=0.5, eps: float = 1e-6,
                 device=None):
        super().__init__(device)
        self.smooth = smooth
        self.alpha = alpha
        self.delta = delta
        self.power = power
        self.eps = float(eps)

    def out_width(self, in_width: int) -> int:
        return in_width

    def init_state(self, in_width: int, dtype, streams=None):
        lead, dev = _lead(streams), self.device
        return (
            torch.zeros(lead + (in_width,), dtype=_torch_dtype(dtype), device=dev),  # M
            torch.zeros(lead, dtype=torch.bool, device=dev),  # smoother started
        )

    def _fin_width(self, state) -> int:
        return state[0].shape[-1]

    def _step_streams(self, state, frames, nin):
        m_prev, started = state
        frames, nin = _scrub(frames, nin)
        S, cap, F = frames.shape
        if cap == 0:
            return state, frames, nin
        dt, dev = frames.dtype, frames.device
        smooth = host_constant(np.asarray(self.smooth), dt, dev)
        decay = 1.0 - smooth
        valid = (torch.arange(cap, device=dev)[None, :] < nin[:, None])[..., None]
        # invalid rows are scan identities (a=1, b=0): the smoother carries
        # through them untouched
        a = torch.where(valid, decay.expand(frames.shape), 1.0)
        b = torch.where(valid, smooth * frames, 0.0)
        first = frames[:, 0]
        m0 = torch.where(started[:, None], m_prev.to(dt), first)
        b0 = decay * m0 + smooth * first
        b = torch.cat([torch.where(valid[:, 0], b0, 0.0)[:, None], b[:, 1:]], dim=1)
        m = _linear_scan(a, b, 1)
        out = _pcen_compress(frames, m, self.alpha, self.delta, self.power, self.eps)
        m_new = torch.where((nin > 0)[:, None], m[:, -1], m_prev.to(dt))
        return (m_new, started | (nin > 0)), out, nin


class StreamingSlidingCMVN(StreamingPostOp):
    """Online :class:`speech_tpu_torch.post.SlidingCMVN` (Kaldi
    ``apply-cmvn-sliding``).

    Not centered (``center=False``, Kaldi's online mode): emission stalls
    only until ``min_window`` frames exist (early frames borrow lookahead
    exactly as the batch op does), then is causal.  Centered: each frame
    waits for its half-window of future context, ``window - window//2``
    frames of latency, and the finalize flush applies the end-of-stream
    clipping; equal to the batch op to summation roundoff (the stream
    re-derives window sums from its own prefix table each step).
    """

    def __init__(self, window: int = 600, center: bool = True, norm_var: bool = False,
                 min_window: int = 100, device=None):
        if window < 1:
            raise ValueError(f"window must be positive, got {window}")
        if min_window < 1:
            raise ValueError(f"min_window must be positive, got {min_window}")
        if min_window > window:
            raise ValueError(
                f"streaming requires min_window <= window, got {min_window} > {window}"
            )
        super().__init__(device)
        self.window = int(window)
        self.center = bool(center)
        self.norm_var = bool(norm_var)
        self.min_window = int(min_window)
        self._extra = self.window // 2 + 1 if self.center else self.min_window - 1

    def out_width(self, in_width: int) -> int:
        return in_width

    def step_cap(self, in_cap: int) -> int:
        return in_cap + self._extra

    def fin_cap(self) -> int:
        return self.window - 1 if self.center else self.min_window - 1

    def init_state(self, in_width: int, dtype, streams=None):
        lead, dev = _lead(streams), self.device
        return (
            # the last `window` frames (zeros before the stream head: the
            # prefix-sum argument of _step_streams relies on it)
            torch.zeros(lead + (self.window, in_width), dtype=_torch_dtype(dtype), device=dev),
            torch.zeros(lead, dtype=torch.int64, device=dev),  # frames seen
        )

    def _emitted(self, seen):
        w = self.window
        if self.center:
            return torch.where(seen >= w, seen - (w - w // 2) + 1, 0)
        return torch.where(seen >= self.min_window, seen, 0)

    def _bounds(self, o, total=None):
        """Per-output window ``[lo, hi)`` (Kaldi's clipping rules);
        ``total`` applies the end-of-stream clamp (finalize only)."""
        w = self.window
        if self.center:
            hi = torch.clamp_min(o - w // 2, 0) + w
        else:
            hi = torch.clamp_min(o + 1, self.min_window)
        if total is not None:
            hi = torch.minimum(hi, total)
        return torch.clamp_min(hi - w, 0), hi

    def _normalize(self, stream_p, row0, cap_out: int, lo, hi):
        """Outputs for the frames at consecutive rows from ``row0`` of the
        zero-left-padded buffers ``stream_p (S, top, F)``; ``lo``/``hi``
        are the per-output window bounds in row coordinates."""
        x = _window(stream_p, row0, cap_out)
        top = stream_p.shape[1]
        cp = torch.nn.functional.pad(torch.cumsum(stream_p, dim=1), (0, 0, 1, 0))
        ra = torch.clamp(lo, 0, top)
        rb = torch.clamp(hi, 0, top)
        count = torch.clamp_min(hi - lo, 1).to(stream_p.dtype)[..., None]
        mean = (_take_rows(cp, rb) - _take_rows(cp, ra)) / count
        out = x - mean
        if self.norm_var:
            cps = torch.nn.functional.pad(torch.cumsum(stream_p * stream_p, dim=1), (0, 0, 1, 0))
            var = (_take_rows(cps, rb) - _take_rows(cps, ra)) / count - mean * mean
            out = out * torch.rsqrt(torch.clamp_min(var, 1e-10))
        return out

    def _step_streams(self, state, frames, nin):
        ring, seen = state
        frames, nin = _scrub(frames, nin)
        S, cap, F = frames.shape
        if cap == 0:
            return (state,) + self._empty(frames, F)
        w = self.window
        cap_out = self.step_cap(cap)
        stream = torch.cat(
            [ring.to(frames.dtype), frames, frames.new_zeros((S, self._extra, F))], dim=1
        )
        seen2 = seen + nin
        em_old = self._emitted(seen)
        o = em_old[:, None] + torch.arange(cap_out, device=frames.device)
        lo, hi = self._bounds(o)
        # virtual frame t sits at stream row t - seen + w (ring rows before
        # the stream head are zeros, so a lo = 0 clamp lands in the prefix
        # table's flat zero region)
        shift = (w - seen)[:, None]
        out = self._normalize(stream, em_old + w - seen, cap_out, lo + shift, hi + shift)
        new_ring = _window(stream, nin, w)
        return (new_ring, seen2), out, self._emitted(seen2) - em_old

    def _fin_width(self, state) -> int:
        return state[0].shape[-1]

    def _finalize_streams(self, state):
        ring, seen = state
        w = self.window
        S, _, F = ring.shape
        cap_fin = self.fin_cap()
        if cap_fin == 0:
            return self._empty(ring, F)
        em = self._emitted(seen)
        o = em[:, None] + torch.arange(cap_fin, device=ring.device)
        lo, hi = self._bounds(o, total=seen[:, None])
        stream_p = torch.cat([ring, ring.new_zeros((S, cap_fin, F))], dim=1)
        shift = (w - seen)[:, None]
        row0 = torch.clamp(em + w - seen, 0, w)
        out = self._normalize(stream_p, row0, cap_fin, lo + shift, hi + shift)
        return out, seen - em


class StreamingStack(StreamingPostOp):
    """Online :class:`speech_tpu_torch.post.Stack`: every ``num_vectors``
    consecutive frames merge into one wide frame; the remainder is dropped
    (``pad=False``) or edge-padded to a final frame at finalize
    (``pad=True``).  Bitwise equal to the batch op."""

    def __init__(self, num_vectors: int, pad: bool = False, device=None):
        if num_vectors < 1:
            raise ValueError(f"num_vectors must be positive, got {num_vectors}")
        super().__init__(device)
        self.num_vectors = int(num_vectors)
        self.pad = bool(pad)

    def out_width(self, in_width: int) -> int:
        return in_width * self.num_vectors

    def step_cap(self, in_cap: int) -> int:
        return (self.num_vectors - 1 + in_cap) // self.num_vectors

    def fin_cap(self) -> int:
        return 1 if self.pad else 0

    def init_state(self, in_width: int, dtype, streams=None):
        lead, dev = _lead(streams), self.device
        m = self.num_vectors
        return (
            torch.zeros(lead + (m - 1, in_width), dtype=_torch_dtype(dtype), device=dev),
            torch.zeros(lead, dtype=torch.int64, device=dev),
        )

    def _step_streams(self, state, frames, nin):
        carry, cnt = state
        frames, nin = _scrub(frames, nin)
        S, cap, F = frames.shape
        m = self.num_vectors
        if cap == 0:
            return (state,) + self._empty(frames, F * m)
        # head-valid compaction (both sides are zero past their counts, so
        # the paste keeps the zero invariant)
        carry = carry.to(frames.dtype)
        combined = _paste(torch.cat([carry, frames.new_zeros((S, cap, F))], dim=1), frames, cnt)
        total = cnt + nin
        nfull = _floordiv(total, m)
        ncap = self.step_cap(cap)
        out = combined[:, : ncap * m].reshape(S, ncap, m * F)
        if m > 1:
            # the carry window may start past cap (a small chunk on a
            # nearly full carry): right-pad so that it never clamps
            combined_p = torch.nn.functional.pad(combined, (0, 0, 0, m - 1))
            new_carry = _window(combined_p, nfull * m, m - 1)
        else:
            new_carry = carry
        return (new_carry, total - nfull * m), out, nfull

    def _fin_width(self, state) -> int:
        return state[0].shape[-1] * self.num_vectors

    def _finalize_streams(self, state):
        carry, cnt = state
        m = self.num_vectors
        S, _, F = carry.shape
        if not self.pad or m == 1:
            return self._empty(carry, F * m)
        # rows past cnt-1 replicate the last valid frame (batch: np.pad
        # edge over the remainder); cnt <= m-1, so the rows stay in carry
        idx = torch.minimum(
            torch.arange(m, device=carry.device)[None, :], torch.clamp_min(cnt - 1, 0)[:, None]
        )
        out = _take_rows(carry, idx).reshape(S, 1, m * F)
        return out, (cnt > 0).to(torch.int64)


class StreamingVAD(StreamingPostOp):
    """Online energy VAD with voiced-frame selection.

    The streaming twin of :func:`speech_tpu_torch.ops.vad.energy_vad` plus
    ``select-voiced-frames``.  A frame is voiced when at least
    ``proportion_threshold`` of its ``[-w, w]`` context window's log
    energies (``w = frames_context``, edge-clipped like Kaldi's
    ``den_count``) exceed a threshold; emission is therefore ``w`` frames
    late and ``finalize`` flushes the tail.

    With ``energy_mean_scale == 0`` the threshold is the fixed
    ``energy_threshold`` and the selected frames equal the batch op's
    exactly, under any chunking.  With a nonzero scale the batch op's
    utterance mean is not causal; the stream uses the RUNNING mean over
    the first ``o + w + 1`` energies, every frame that has arrived when
    frame ``o``'s decision is due, which makes decisions chunk-size
    invariant.

    ``emit="select"`` (default) compacts voiced rows to the block prefix
    (``n_out`` = voiced count), a true frame filter in a chain;
    ``emit="flag"`` passes every decided frame with a trailing 0/1 voiced
    column.  ``energy_idx`` selects the log-energy column.
    """

    _counter = 3

    def __init__(
        self,
        energy_threshold: float = 5.0,
        energy_mean_scale: float = 0.5,
        frames_context: int = 0,
        proportion_threshold: float = 0.6,
        energy_idx: int = 0,
        emit: str = "select",
        device=None,
    ):
        if frames_context < 0:
            raise ValueError(f"frames_context must be >= 0, got {frames_context}")
        if not 0.0 < proportion_threshold < 1.0:
            raise ValueError(
                f"proportion_threshold must be in (0, 1), got {proportion_threshold}"
            )
        if energy_mean_scale < 0:
            raise ValueError(f"energy_mean_scale must be >= 0, got {energy_mean_scale}")
        if emit not in ("select", "flag"):
            raise ValueError(f"emit must be 'select' or 'flag', got {emit}")
        super().__init__(device)
        self.energy_threshold = float(energy_threshold)
        self.energy_mean_scale = float(energy_mean_scale)
        self.w = int(frames_context)
        self.proportion_threshold = float(proportion_threshold)
        self.energy_idx = int(energy_idx)
        self.emit = emit

    def out_width(self, in_width: int) -> int:
        return in_width if self.emit == "select" else in_width + 1

    def fin_cap(self) -> int:
        return self.w

    def init_state(self, in_width: int, dtype, streams=None):
        lead, dev, dt = _lead(streams), self.device, _torch_dtype(dtype)
        w = self.w
        return (
            torch.zeros(lead + (w, in_width), dtype=dt, device=dev),  # frames [seen-w, seen)
            torch.zeros(lead + (2 * w,), dtype=dt, device=dev),  # energies [seen-2w, seen)
            torch.zeros(lead, dtype=dt, device=dev),  # sum of energies [0, seen-2w)
            torch.zeros(lead, dtype=torch.int64, device=dev),  # frames seen
        )

    def _decide(self, ewin, base_abs, pre_total, total_frames, cap: int):
        """Voiced flags ``(S, cap)`` for outputs whose first absolute frame
        is ``base_abs``; ``ewin[:, i + k]`` is the energy of output ``i``'s
        tap ``k`` (absolute frame ``base_abs + i - w + k``), zero outside
        the stream.  ``total_frames`` bounds the right edge (it binds only
        at finalize)."""
        w = self.w
        dev = ewin.device
        o_abs = base_abs[:, None] + torch.arange(cap, device=dev)
        total_frames = total_frames[:, None]
        if self.energy_mean_scale:
            cume = torch.cumsum(ewin, dim=1)
            # the threshold of output o: the running mean over energies [0,
            # min(o + w, total - 1)]; rows of ewin outside the stream are
            # zeros, so the clipped cumulative read is exact
            hi = torch.minimum(o_abs + w, total_frames - 1)
            n_hi = hi - (base_abs[:, None] - w)  # ewin row of hi
            cnt = torch.clamp_min(hi + 1, 1)
            run = pre_total[:, None] + torch.gather(cume, 1, torch.clamp(n_hi, 0, cap + 2 * w - 1))
            thresh = self.energy_threshold + self.energy_mean_scale * (run / cnt.to(ewin.dtype))
        else:
            thresh = self.energy_threshold
        num = torch.zeros_like(o_abs)
        den = torch.zeros_like(o_abs)
        for k in range(2 * w + 1):
            j_abs = o_abs - w + k
            tap = ewin[:, k : k + cap]
            ok = (j_abs >= 0) & (j_abs < total_frames)
            num = num + (ok & (tap > thresh)).to(torch.int64)
            den = den + ok.to(torch.int64)
        return num >= self.proportion_threshold * torch.clamp_min(den, 1)

    def _emit_block(self, out_frames, voiced, nout):
        cap = out_frames.shape[1]
        decided = torch.arange(cap, device=out_frames.device)[None, :] < nout[:, None]
        if self.emit == "flag":
            flags = decided & voiced
            out = torch.cat([out_frames, flags.to(out_frames.dtype)[..., None]], dim=-1)
            return out, nout
        # select: stable-partition the voiced decided rows to the prefix
        # (0 = keep, 1 = decided unvoiced, 2 = undecided garbage)
        key = torch.where(decided, torch.where(voiced, 0, 1), 2)
        order = torch.argsort(key, dim=1, stable=True)
        return _take_rows(out_frames, order), (key == 0).sum(dim=1)

    def _step_streams(self, state, frames, nin):
        feat_buf, e_buf, ptot, seen = state
        frames, nin = _scrub(frames, nin)
        S, cap, F = frames.shape
        if cap == 0:
            return (state,) + self._empty(frames, self.out_width(F))
        w = self.w
        dt = frames.dtype
        feat_buf, e_buf, ptot = feat_buf.to(dt), e_buf.to(dt), ptot.to(dt)
        fstream = torch.cat([feat_buf, frames], dim=1)  # [seen-w, seen+cap)
        estream = torch.cat([e_buf, frames[..., self.energy_idx]], dim=1)  # [seen-2w, seen+cap)
        old_em = torch.clamp_min(seen - w, 0)
        new_em = torch.clamp_min(seen + nin - w, 0)
        # align once (one gather), then static shifts
        fbase = old_em - (seen - w)  # in [0, w]
        out_frames = _window(fstream, fbase, cap)
        ewin = _window(torch.nn.functional.pad(estream, (0, w)), fbase, cap + 2 * w)
        # running-mean bookkeeping: ewin row 0 is absolute frame old_em - w;
        # pre covers [0, seen-2w) plus the fbase stream rows before the
        # window
        if self.energy_mean_scale:
            head = estream[:, : 2 * w]
            before = torch.arange(2 * w, device=frames.device)[None, :] < fbase[:, None]
            pre = ptot + torch.sum(torch.where(before, head, 0), dim=1)
        else:
            pre = ptot
        voiced = self._decide(ewin, old_em, pre, seen + nin + w + 1, cap)  # right edge unbound
        out, n_sel = self._emit_block(out_frames, voiced, new_em - old_em)
        new_feat = _window(fstream, nin, w) if w else feat_buf
        new_e = _window(estream, nin, 2 * w) if w else e_buf
        shed = torch.arange(estream.shape[1], device=frames.device)[None, :] < nin[:, None]
        new_ptot = ptot + torch.sum(torch.where(shed, estream, 0), dim=1)
        new_ptot = torch.where(nin > 0, new_ptot, ptot)
        return (new_feat, new_e, new_ptot, seen + nin), out, n_sel

    def _fin_width(self, state) -> int:
        return self.out_width(state[0].shape[-1])

    def _finalize_streams(self, state):
        feat_buf, e_buf, ptot, seen = state
        w = self.w
        S, _, F = feat_buf.shape
        if w == 0:
            return self._empty(feat_buf, self.out_width(F))
        nout = torch.clamp(seen, max=w)
        fb_base = w - nout
        out_frames = _window(torch.nn.functional.pad(feat_buf, (0, 0, 0, w)), fb_base, w)
        ewin = _window(torch.nn.functional.pad(e_buf, (0, 2 * w)), fb_base, 3 * w)
        base_abs = seen - nout
        if self.energy_mean_scale:
            # ewin row 0 is absolute frame base_abs - w = seen - 2w +
            # fb_base; pre covers [0, seen-2w) plus the fb_base rows
            before = torch.arange(2 * w, device=e_buf.device)[None, :] < fb_base[:, None]
            pre = ptot + torch.sum(torch.where(before, e_buf, 0), dim=1)
        else:
            pre = ptot
        voiced = self._decide(ewin, base_abs, pre, seen, w)
        return self._emit_block(out_frames, voiced, nout)


class StreamingProcessPitch(StreamingPostOp):
    """Online Kaldi ``process-kaldi-pitch-feats``, as Kaldi's
    ``OnlineProcessPitch`` computes it from the frames its source has
    ready: ``[f0, nccf]`` track rows in (the columns of
    :class:`~speech_tpu_torch.streaming.StreamingPitch`), the three columns
    of :func:`speech_tpu_torch.ops.pitch.pitch_feats_from_track` out:

    - the POV feature ``2 ((1.001 - nccf)^0.15 - 1)``;
    - log f0 less its mean weighted by ``pov(nccf) + 1e-6`` over the
      centred window of ``normalization_window`` frames, clipped at frame 0
      and at the newest track row of the step that emits the frame: a
      frame's window reads the rows that had arrived when it went out;
    - the order-1 delta of log f0 over ``[t - delta_window, t +
      delta_window]``, frame 0 standing in before the track and, at
      ``finalize``, the last frame after it.

    No scale and no noise, as the batch form.  Rows go out
    ``delta_window`` frames late (the delta's right context), and
    ``finalize`` flushes them.  The carry keeps the last ``max(
    normalization_window // 2, delta_window) + delta_window`` track rows
    and their count; a step's window sums are one masked product in IEEE
    float32."""

    def __init__(self, normalization_window: int = 151, delta_window: int = 2, device=None):
        if normalization_window < 1:
            raise ValueError(f"normalization_window must be >= 1, got {normalization_window}")
        if delta_window < 1:
            raise ValueError(f"delta_window must be >= 1, got {delta_window}")
        super().__init__(device)
        self.normalization_window = int(normalization_window)
        self.delta_window = int(delta_window)
        self._left = self.normalization_window // 2  # frames before t in its window
        self._carry = max(self._left, self.delta_window) + self.delta_window
        self._taps = [float(c) for c in delta_filters(1, self.delta_window)[0]]

    def out_width(self, in_width: int) -> int:
        if in_width != 2:
            raise ValueError(f"process-pitch takes [f0, nccf] rows, got width {in_width}")
        return 3

    def fin_cap(self) -> int:
        return self.delta_window

    def init_state(self, in_width: int, dtype, streams=None):
        self.out_width(in_width)
        lead = _lead(streams)
        return (
            torch.zeros(lead + (self._carry, 2), dtype=_torch_dtype(dtype), device=self.device),
            torch.zeros(lead, dtype=torch.int64, device=self.device),  # track rows seen
        )

    def _columns(self, stream, base, first, n_track, cap: int):
        """Output rows ``first .. first + cap - 1`` (absolute frames, ``(S,)``
        starts) from ``stream (S, R, 2)``, whose row ``r`` is track frame
        ``base + r``; frames at or past ``n_track`` have not arrived."""
        S, R, _ = stream.shape
        dev = stream.device
        a = base[:, None] + torch.arange(R, device=dev)[None, :]  # (S, R)
        ok = (a >= 0) & (a < n_track[:, None])
        f0, nccf = stream[..., 0], stream[..., 1]
        logf0 = torch.where(ok, torch.log(torch.where(ok, f0, 1.0)), 0.0)
        w = torch.where(ok, nccf_to_pov(nccf) + 1e-6, 0.0)
        t = first[:, None] + torch.arange(cap, device=dev)[None, :]  # (S, cap)
        lo = torch.clamp_min(t - self._left, 0)
        hi = torch.minimum(t - self._left + self.normalization_window, n_track[:, None])
        inside = (a[:, None, :] >= lo[..., None]) & (a[:, None, :] < hi[..., None])
        with ieee_float32():
            sums = torch.bmm(inside.to(stream.dtype), torch.stack([w * logf0, w], dim=-1))
        last = torch.clamp_min(n_track - 1, 0)[:, None]

        def at(frames):
            return torch.gather(logf0, 1, torch.clamp(frames - base[:, None], 0, R - 1))

        mean = sums[..., 0] / torch.clamp_min(sums[..., 1], 1e-6)
        dlog = None
        for d, c in zip(range(-self.delta_window, self.delta_window + 1), self._taps):
            if c == 0.0:
                continue
            term = at(torch.minimum(torch.clamp_min(t + d, 0), last)) * c
            dlog = term if dlog is None else dlog + term
        nccf_t = torch.gather(nccf, 1, torch.clamp(t - base[:, None], 0, R - 1))
        pov_feat = 2.0 * (torch.exp(0.15 * torch.log(1.001 - nccf_t)) - 1.0)
        return torch.stack([pov_feat, at(t) - mean, dlog], dim=-1)

    def _step_streams(self, state, frames, nin):
        carry, n = state
        frames, nin = _scrub(frames, nin)
        S, cap, _ = frames.shape
        if cap == 0:
            return (state,) + self._empty(frames, 3)
        K, dw = self._carry, self.delta_window
        stream = torch.cat([carry.to(frames.dtype), frames], dim=1)
        n_new = n + nin
        first = torch.clamp_min(n - dw, 0)
        n_out = torch.clamp_min(n_new - dw, 0) - first
        out = self._columns(stream, n - K, first, n_new, cap)
        out = torch.where((torch.arange(cap, device=out.device) < n_out[:, None])[..., None], out, 0)
        return (_window(stream, nin, K), n_new), out, n_out

    def _finalize_streams(self, state):
        carry, n = state
        first = torch.clamp_min(n - self.delta_window, 0)
        out = self._columns(carry, n - self._carry, first, n, self.delta_window)
        n_out = n - first
        valid = torch.arange(self.delta_window, device=out.device) < n_out[:, None]
        return torch.where(valid[..., None], out, 0), n_out


class StreamingPostChain(StreamingPostOp):
    """Sequential composition of streaming post-ops (itself an op).

    Stage k+1 consumes stage k's emitted rows, the batch CLIs'
    ``--postprocess`` order.  ``finalize`` flushes stage by stage, pushing
    each flush through the later stages, so the concatenated output equals
    the batch chain over the full matrix.
    """

    def __init__(self, ops, device=None):
        super().__init__(device)
        self.ops = list(ops)
        for op in self.ops:
            if not isinstance(op, StreamingPostOp):
                raise TypeError(f"chain entries must be StreamingPostOp, got {type(op)}")

    def out_width(self, in_width: int) -> int:
        for op in self.ops:
            in_width = op.out_width(in_width)
        return in_width

    def step_cap(self, in_cap: int) -> int:
        for op in self.ops:
            in_cap = op.step_cap(in_cap)
        return in_cap

    def fin_cap(self) -> int:
        total = 0
        for k, op in enumerate(self.ops):
            cap = op.fin_cap()
            for later in self.ops[k + 1 :]:
                cap = later.step_cap(cap)
            total += cap
        return total

    def init_state(self, in_width: int, dtype, streams=None):
        states = []
        for op in self.ops:
            states.append(op.init_state(in_width, dtype, streams))
            in_width = op.out_width(in_width)
        return tuple(states)

    def _step_streams(self, state, frames, nin):
        states = list(state)
        cur, ncur = frames, nin
        for k, op in enumerate(self.ops):
            states[k], cur, ncur = op._step_impl(states[k], cur, ncur)
        return tuple(states), cur, ncur

    def _step_impl(self, state, frames, n_valid):
        if not self.ops:
            return state, frames, n_valid
        return super()._step_impl(state, frames, n_valid)

    def _finalize_impl(self, state):
        states = list(state)
        blocks = []
        for k, op in enumerate(self.ops):
            cur, ncur = op._finalize_impl(states[k])
            for j in range(k + 1, len(self.ops)):
                states[j], cur, ncur = self.ops[j]._step_impl(states[j], cur, ncur)
            blocks.append((cur, ncur))
        if not blocks:
            return (
                torch.zeros((0, 0), dtype=torch.float32, device=self.device),
                torch.zeros((), dtype=torch.int64, device=self.device),
            )
        single = blocks[0][0].dim() == 2
        if single:
            blocks = [_lift(b) for b in blocks]
        # every block carries the final stage's width (the zero-capacity
        # early outs keep widths through the pushes)
        S = blocks[0][0].shape[0]
        total_cap = sum(b.shape[1] for b, _ in blocks)
        width = max(b.shape[2] for b, _ in blocks)
        dtype = blocks[0][0].dtype
        for b, _ in blocks[1:]:
            dtype = torch.promote_types(dtype, b.dtype)
        buf = torch.zeros((S, total_cap, width), dtype=dtype, device=blocks[0][0].device)
        off = torch.zeros(S, dtype=torch.int64, device=buf.device)
        for b, nb in blocks:
            if b.shape[1] == 0:
                continue
            b, nb = _scrub(b.to(dtype), nb)
            buf = _paste(buf, b, off)
            off = off + nb
        return _drop((buf, off)) if single else (buf, off)


def streaming_post_op(post, device=None) -> StreamingPostOp:
    """The streaming twin of a host post-processor instance, on ``device``.

    Maps :mod:`speech_tpu_torch.post` classes onto this module's ops,
    checking that the instance's configuration is streamable (time axis 0,
    feature axis last, the batch CLIs' convention).  Raises ``ValueError``
    for configurations that cannot stream (e.g.
    :class:`~speech_tpu_torch.post.Standardize` without accumulated
    statistics normalises by whole-tensor moments).  Host tables are copied
    to the device once, not on every step.
    """
    from . import post as _post

    if isinstance(post, StreamingPostOp):
        return post
    if isinstance(post, _post.Deltas):
        if not post.concatenate:
            raise ValueError("streaming Deltas supports the concatenating form only")
        if post._target_axis not in (-1, 1):
            raise ValueError("streaming Deltas requires target_axis -1 (feature axis)")
        if post._pad_mode != "edge":
            raise ValueError(f"streaming Deltas requires pad_mode='edge', got {post._pad_mode!r}")
        if post.num_deltas == 0:  # degenerate: identity
            return StreamingFrameLocal(lambda f: f, device=device)
        W = (len(post.filters[1]) - 1) // 2
        return StreamingDeltas(post.num_deltas, W, device=device)
    if isinstance(post, _post.Splice):
        if post.time_axis % 2 != 0:
            raise ValueError("streaming Splice requires time_axis 0")
        return StreamingSplice(post.left, post.right, device=device)
    if isinstance(post, _post.Stack):
        if post.time_axis % 2 != 0:
            raise ValueError("streaming Stack requires time_axis 0")
        if post._pad_mode not in (None, "edge"):
            raise ValueError(
                f"streaming Stack supports pad_mode None or 'edge', got {post._pad_mode!r}"
            )
        return StreamingStack(post.num_vectors, pad=post._pad_mode == "edge", device=device)
    if isinstance(post, _post.PCEN):
        if post.time_axis % 2 != 0:
            raise ValueError("streaming PCEN requires time_axis 0")
        return StreamingPCEN(post.smooth, post.alpha, post.delta, post.power, post.eps,
                             device=device)
    if isinstance(post, _post.SlidingCMVN):
        if post.time_axis % 2 != 0:
            raise ValueError("streaming SlidingCMVN requires time_axis 0")
        return StreamingSlidingCMVN(post.window, post.center, post.norm_var, post.min_window,
                                    device=device)
    if isinstance(post, _post.DCT):
        num_ceps, lifter = post.num_ceps, post.lifter
        return StreamingFrameLocal(
            lambda f: _postops.dct(f, num_ceps, lifter),
            (lambda w: num_ceps) if num_ceps is not None else None,
            device=device,
        )
    if isinstance(post, _post.PLP):
        center_hz = post.center_hz
        kw = dict(order=post.order, num_ceps=post.num_ceps, compress=post.compress,
                  lifter=post.lifter, eps=post.eps)
        return StreamingFrameLocal(
            lambda f: _plp(f, center_hz, **kw), lambda w: kw["num_ceps"], device=device
        )
    if isinstance(post, _post.Transform):
        mat = np.asarray(post.matrix)
        out_dim = post.out_dim
        return StreamingFrameLocal(
            lambda f: _postops.transform(f, mat), lambda w: out_dim, device=device
        )
    if isinstance(post, _post.VADTrim):
        if post.time_axis % 2 != 0:
            raise ValueError("streaming VADTrim requires time_axis 0")
        if post.energy_mean_scale:
            raise ValueError(
                "streaming VADTrim requires energy_mean_scale 0 (the "
                "utterance-global mean threshold is not causal); build "
                "StreamingVAD directly for the running-mean form"
            )
        return StreamingVAD(
            energy_threshold=post.energy_threshold,
            energy_mean_scale=0.0,
            frames_context=post.frames_context,
            proportion_threshold=post.proportion_threshold,
            energy_idx=post.energy_idx,
            device=device,
        )
    if isinstance(post, _post.Standardize):
        if not post.have_stats:
            raise ValueError(
                "streaming Standardize needs accumulated/loaded statistics "
                "(whole-tensor local standardization is not causal)"
            )
        stats = np.asarray(post.stats)
        norm_var = post._norm_var
        return StreamingFrameLocal(
            lambda f: _postops.standardize_with_stats(f, stats, norm_var), device=device
        )
    raise ValueError(f"no streaming twin for {type(post).__name__}")


class StreamingPipeline:
    """A signal streamer fused with a streaming post chain.

    Honours the streamer contract (``init_state`` / ``_process_impl(state,
    chunk, valid_len)`` / ``_finalize_impl(state)`` with prefix-valid
    outputs, bitwise no-op ``valid 0`` steps, and the stream axis)::

        computer = STFTFrameComputer(...)
        pipe = StreamingPipeline(computer, [Deltas(2), SlidingCMVN(center=False)],
                                 chunk_size=1600)

    Parameters
    ----------
    computer
        A frame computer (STFT or SI, wrapped in its streaming class) or a
        streamer honouring the contract (:class:`~speech_tpu_torch.streaming.StreamingPitch`
        included).
    postprocessors
        Host post-processor instances (converted by
        :func:`streaming_post_op` onto the streamer's device) and/or
        :class:`StreamingPostOp`\\ s, applied in order.
    chunk_size
        Chunk size for a computer argument (a streamer carries its own).
    in_width
        Feature width entering the chain; inferred from the computer's
        ``num_coeffs`` (or 2 for a pitch streamer) when omitted.
    """

    def __init__(self, computer, postprocessors, chunk_size: int = 1600, in_width=None):
        from .compute import FrameComputer, ShortIntegrationFrameComputer
        from .streaming import StreamingPitch, StreamingSI, StreamingSTFT

        if hasattr(computer, "init_state") and hasattr(computer, "_process_impl"):
            self.stream = computer
        elif isinstance(computer, FrameComputer):
            cls = (
                StreamingSI
                if isinstance(computer, ShortIntegrationFrameComputer)
                else StreamingSTFT
            )
            self.stream = cls(computer, chunk_size)
        else:
            raise ValueError(f"expected a frame computer or streamer, got {type(computer)}")
        self.device = resolve_device(getattr(self.stream, "device", None))
        self.chain = StreamingPostChain(
            [streaming_post_op(p, device=self.device) for p in postprocessors],
            device=self.device,
        )
        if in_width is None:
            inner = getattr(self.stream, "computer", None)
            if inner is not None and hasattr(inner, "num_coeffs"):
                in_width = inner.num_coeffs
            elif isinstance(self.stream, StreamingPitch):
                in_width = 2
            else:
                raise ValueError("cannot infer the streamer's feature width; pass in_width=")
        self.in_width = int(in_width)
        self.num_coeffs = self.chain.out_width(self.in_width)
        self.chunk_size = self.stream.chunk_size
        self._dtype = _torch_dtype(self.stream._dtype)

    def init_state(self, streams=None):
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        return (
            self.stream.init_state(streams),
            self.chain.init_state(self.in_width, self._dtype, streams),
        )

    def _process_impl(self, state, chunk, valid_len):
        sig_state, post_state = state
        sig_state, feats, nf = self.stream._process_impl(sig_state, chunk, valid_len)
        post_state, out, nout = self.chain._step_impl(post_state, feats, nf)
        return (sig_state, post_state), out, nout

    def _finalize_impl(self, state):
        sig_state, post_state = state
        fin_feats, fin_n = self.stream._finalize_impl(sig_state)
        post_state, out1, n1 = self.chain._step_impl(post_state, fin_feats, fin_n)
        out2, n2 = self.chain._finalize_impl(post_state)
        single = out1.dim() == 2
        if single:
            out1, n1, out2, n2 = _lift((out1, n1, out2, n2))
        S, cap1, width = out1.shape
        out1, n1 = _scrub(out1, _counts(n1, S, cap1, out1.device))
        buf = torch.nn.functional.pad(out1, (0, 0, 0, out2.shape[1]))
        n = n1
        if out2.shape[1]:
            out2, n2 = _scrub(out2, n2)
            buf = _paste(buf, out2, n1)
            n = n1 + n2
        return _drop((buf, n)) if single else (buf, n)

    # public entry points ------------------------------------------------

    def process(self, state, chunk, valid_len=None):
        """Consume one chunk; returns ``(state, feats, n_valid)`` with the
        post chain applied."""
        if valid_len is None:
            valid_len = chunk.shape[-1]
        return self._process_impl(state, chunk, valid_len)

    def finalize(self, state):
        """Flush the streamer and every post stage; returns ``(feats,
        n_valid)``."""
        return self._finalize_impl(state)

    def transform(self, signal: np.ndarray) -> np.ndarray:
        """Host helper: stream a whole signal chunk by chunk and return the
        concatenated valid rows."""
        sig = np.asarray(signal)
        C = self.chunk_size
        state = self.init_state()
        outs = []
        for start in range(0, max(len(sig), 1), C):
            piece = sig[start : start + C]
            buf = np.zeros((C,), sig.dtype if sig.dtype.kind == "f" else np.float64)
            buf[: len(piece)] = piece
            state, feats, n = self.process(state, buf, len(piece))
            outs.append(feats.cpu().numpy()[: int(n)])
        feats, n = self.finalize(state)
        outs.append(feats.cpu().numpy()[: int(n)])
        return np.concatenate(outs)
