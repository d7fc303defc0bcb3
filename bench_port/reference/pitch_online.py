"""Plain online Kaldi-style pitch columns: the benchmark's reference for a
configuration whose ``"pitch"`` block sets ``lookahead_frames``, as Kaldi
online2's feature pipeline with pitch (``OnlinePitchFeature`` under
``OnlineProcessPitch``) computes them while a session's audio arrives in
chunks.

A frozen, self-contained statement of the online semantics, in plain
PyTorch and numpy in float64 (no float32 product, so TF32 plays no part);
it imports nothing of the program under test and takes its offline pieces
(the resampler, the lowpass, the lag grid and its tables, the NCCF's
definition) from :mod:`bench_port.reference.pitch`.  One session at a
time; a session is a signal of ``n`` samples fed as ``pieces`` (by default
consecutive ``chunk``-sample pieces, the last one partial), then
finalized.  The steps:

1. **Staging**: the tracker takes the input in full aligned chunks of
   ``chunk`` samples; a piece's samples wait in a stage until a chunk is
   full, and the chunk is absorbed at once (a piece may fill several).
   ``finalize`` absorbs the staged rest as one last chunk, zero-padded,
   then empty chunks until the front end has given every work sample.
2. **Front end**: the work signal is the offline one (``PitchSpec``'s
   resampling and lowpass of the whole signal, zero outside itself, of
   ``ceil(n up / down)`` samples); what streaming changes is when each
   work sample exists.  After ``A`` input samples have been absorbed (``A``
   a multiple of ``chunk``, zero-padded at the end), work sample ``j`` has
   arrived once every tap it reads has: its lowpass taps ``j - 32 .. j +
   32`` and, for each, the resampler's taps ``i`` with ``|m down - i up|
   <= K``, so ``j <= floor((A up - 1 - K) / down) - 32`` (and ``j <
   ceil(n up / down)`` of the samples fed so far).
3. **Frames**: frame ``i`` spans work samples ``[i shift, i shift +
   span)`` and is absorbed by the first absorption after which its span
   has arrived.
4. **Running-mean-square ballast**: the frames an absorption brings get
   the NCCF of ``PitchSpec`` with the ballast ``nccf_ballast * window *
   ms``, ``ms`` the mean square of the work samples that have arrived by
   that absorption (not the whole signal's).
5. **Min-plus step**: each absorbed frame in order, ``cost'[j] = min_i
   (cost[i] + penalty (log lag_i - log lag_j)^2) - nccf_eff[j]`` with the
   back-pointer the first index of the minimum (``-nccf_eff`` and the
   identity at the first frame), then the costs shifted by their minimum,
   which moves no argmin.
6. **Backtrack and emission**: after each absorption before
   ``finalize``, the frames absorbed and not yet emitted are ``pending``;
   the oldest ``min(pending - lookahead_frames, frames a chunk can bring)``
   of them (none where that is below 1) go out, each with the lag of the
   path traced back from the newest absorbed frame's best lag.  At
   ``finalize`` every pending frame goes out on the path from the last
   frame's best lag.  An emitted frame's ``f0`` and ``nccf`` are
   ``PitchSpec``'s parabolic refinement on its voicing NCCF.
7. **The three columns, as computed at emission**: the frames the pieces
   of one call (a piece, or ``finalize``) emitted join the track's ``N``
   frames so far; the call's columns are those of frames ``[max(N_before
   - delta_window, 0), max(N - delta_window, 0))`` (all of the rest at
   ``finalize``), frame ``t``'s: POV ``2 ((1.001 - nccf)^0.15 - 1)``; log
   ``f0`` less its mean weighted by ``pov(nccf) + 1e-6`` over frames
   ``[max(t - W // 2, 0), min(t - W // 2 + W, N))`` for ``W`` the
   ``normalization_window``, clipped to the ``N`` frames emitted so far;
   the order-1 delta ``sum_d d / sum d^2 log f0[clip(t + d, 0, N - 1)]``
   over ``d`` in ``[-delta_window, delta_window]``.
8. **The repeated tail**: the rows of the session are the filter bank's
   frames; those past the track repeat the track's last columns, zeros
   with no track.

``precision``: ``"float64"`` (the reference), ``"tf32"`` (the NCCF's
products read their operands rounded to TF32 and sum in float32) and
``"viterbi32"`` (the costs in float32 with no per-step shift: they grow
by about one a frame and, past about 10 s, lose the steps between
neighbouring lags): the controls.
"""

import math

import numpy as np
import torch

from .fbank import _tf32
from .pitch import _LOWPASS_HW, _RESAMPLE_HW, _TINY, PRECISIONS, PitchSpec

__all__ = ["OnlinePitchSpec"]


def _pov(nccf):
    a = np.abs(nccf)
    logit = (-5.2 + 5.4 * np.exp(7.5 * (a - 1.0)) + 4.8 * a - 2.0 * np.exp(-10.0 * a)
             + 4.2 * np.exp(20.0 * (a - 1.0)))
    return 1.0 / (1.0 + np.exp(-logit))


class OnlinePitchSpec(PitchSpec):
    """The numbers of a ``"pitch"`` block with ``lookahead_frames``, fed in
    ``chunk``-sample chunks at the input ``rate``."""

    def __init__(self, pitch: dict, rate: int, chunk: int):
        super().__init__(pitch, rate)
        if "lookahead_frames" not in pitch:
            raise ValueError("the pitch block lacks lookahead_frames")
        self.lookahead = int(pitch["lookahead_frames"])
        self.chunk = int(chunk)
        if self.chunk % self.down:
            raise ValueError(f"chunk {chunk} is not a multiple of the resampler's {self.down}")
        self.work_chunk = self.chunk * self.up // self.down
        self.chunk_frames = -(-self.work_chunk // self.shift)
        resampled = (self.up, self.down) != (1, 1)
        self._taps_rs = _RESAMPLE_HW * max(self.up, self.down) if resampled else 0
        self._taps_lp = _LOWPASS_HW if self.cutoff and self.cutoff < self.work_rate / 2 else 0

    # -- when work samples and frames arrive ----------------------------

    def arrived(self, absorbed: int, fed: int) -> int:
        """Work samples that exist after ``absorbed`` input samples (a
        multiple of ``chunk``) have been absorbed, ``fed`` of them real."""
        j = (absorbed * self.up - 1 - self._taps_rs) // self.down - self._taps_lp
        return max(0, min(j + 1, -(-fed * self.up // self.down)))

    def frames_in(self, work: int) -> int:
        return (work - self.span) // self.shift + 1 if work >= self.span else 0

    def absorptions(self, n: int, pieces=None):
        """``[(call, work samples arrived, frames absorbed)]`` of each
        absorption, ``call`` the index of the piece (``len(pieces)`` for
        ``finalize``)."""
        pieces = self.pieces(n) if pieces is None else [int(p) for p in pieces]
        if sum(pieces) != n:
            raise ValueError("the pieces do not add up to the signal")
        out, staged, absorbed, fed = [], 0, 0, 0
        for call, p in enumerate(pieces):
            staged += p
            while staged >= self.chunk:
                staged -= self.chunk
                absorbed += self.chunk
                fed += self.chunk
                w = self.arrived(absorbed, fed)
                out.append((call, w, self.frames_in(w)))
        fed += staged
        total = -(-fed * self.up // self.down)
        while True:
            absorbed += self.chunk
            w = self.arrived(absorbed, fed)
            out.append((len(pieces), w, self.frames_in(w)))
            if w >= total:
                return out

    def pieces(self, n: int):
        """The cell's chunking: consecutive ``chunk``-sample pieces, the
        last one partial."""
        return [min(self.chunk, n - s) for s in range(0, n, self.chunk)]

    def rows_before_finalize(self, n: int, frames: int) -> int:
        """The rows of an ``n``-sample session (``frames`` filter-bank
        frames) that go out before its ``finalize``."""
        out = 0
        for call, _, absorbed in self.absorptions(n):
            if call < len(self.pieces(n)):
                out += min(max(absorbed - out - self.lookahead, 0), self.chunk_frames)
        return min(max(out - self.delta_window, 0), frames)

    # -- the tracker ------------------------------------------------------

    def _nccf_at(self, x, first: int, last: int, ms, precision: str):
        """``(pitch, voicing)`` NCCFs on the lag grid of frames ``first ..
        last - 1`` with the mean square ``ms``."""
        b = self.ballast * self.window * ms
        starts = torch.arange(first, last, device=x.device) * self.shift
        frames = x[starts[:, None] + torch.arange(self.span, device=x.device)[None, :]]
        frames = frames - frames.mean(dim=1, keepdim=True)
        x1 = frames[:, : self.window]
        lags = torch.as_tensor(self.int_lags, device=x.device)
        x2 = frames[:, lags[:, None] + torch.arange(self.window, device=x.device)[None, :]]
        if precision == "tf32":
            f1, f2 = _tf32(x1.to(torch.float32)), _tf32(x2.to(torch.float32))
            inner = (f2 * f1[:, None, :]).sum(-1).double()
            e1, e2 = (f1 * f1).sum(-1).double(), (f2 * f2).sum(-1).double()
        else:
            inner = (x2 * x1[:, None, :]).sum(-1)
            e1, e2 = (x1 * x1).sum(-1), (x2 * x2).sum(-1)
        m = torch.tensor(self.interpolation(), dtype=x.dtype, device=x.device)
        pitch = inner / (torch.sqrt((e1[:, None] + b) * (e2 + b)) + _TINY)
        voicing = inner / (torch.sqrt(e1[:, None] * e2) + _TINY)
        return pitch @ m, torch.clamp(voicing @ m, -1.0, 1.0)

    def _refine(self, voicing, path):
        """``(f0, nccf)`` of frames whose voicing NCCF rows are ``voicing``
        at grid indices ``path``."""
        L = voicing.shape[1]
        rows = torch.arange(path.shape[0], device=voicing.device)
        nccf = voicing[rows, path]
        jc = path.clamp(1, L - 2)
        y1, y2, y3 = voicing[rows, jc - 1], voicing[rows, jc], voicing[rows, jc + 1]
        curv = y1 + y3 - 2.0 * y2
        safe = torch.where(curv.abs() > 1e-12, curv, torch.ones_like(curv))
        delta = torch.where(curv.abs() > 1e-12, 0.5 * (y1 - y3) / safe, 0.0)
        delta = torch.where((path > 0) & (path < L - 1), delta.clamp(-0.5, 0.5), 0.0)
        lags = torch.tensor(self.lags, dtype=voicing.dtype, device=voicing.device)
        log_lag = torch.log(lags[path]) + delta * math.log1p(self.resolution)
        return self.work_rate * torch.exp(-log_lag), nccf

    def track_calls(self, signal, pieces=None, device="cpu", precision: str = "float64"):
        """The track frames each call emits: ``[(f0, nccf)]`` float64 numpy
        arrays, one entry a piece and the last ``finalize``'s."""
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        n = len(signal)
        events = self.absorptions(n, pieces)
        n_calls = events[-1][0] + 1
        x = torch.as_tensor(np.asarray(signal, dtype=np.float64), device=device)
        x = self._lowpass(self._resample(x))
        sq = torch.cumsum(torch.nn.functional.pad(x * x, (1, 0)), 0)
        lags = torch.tensor(self.lags, dtype=x.dtype, device=x.device)
        discount = 1.0 - torch.clamp(self.soft_min_f0 * lags / self.work_rate, max=1.0)
        dtype = torch.float32 if precision == "viterbi32" else torch.float64
        trans = torch.tensor(self.transitions(), dtype=dtype, device=x.device)
        cost, ptrs, voicings = None, [], []
        absorbed = emitted = 0
        calls = [[] for _ in range(n_calls)]

        def emit(call, count):
            # the path traced back from the newest frame's best lag to the
            # oldest pending frame
            j = int(torch.argmin(cost))
            back = torch.stack(ptrs[emitted + 1: absorbed]).cpu().numpy() if absorbed - emitted > 1 \
                else np.zeros((0, len(self.lags)), np.int64)
            path = [j]
            for ptr in back[::-1]:
                j = int(ptr[j])
                path.append(j)
            path = torch.as_tensor(path[::-1][:count], device=x.device)
            f0, nccf = self._refine(torch.stack(voicings[emitted: emitted + count]), path)
            calls[call].append((f0.cpu().numpy(), nccf.cpu().numpy()))

        for call, work, frames in events:
            if frames > absorbed:
                ms = sq[work] / work
                pitch, voicing = self._nccf_at(x, absorbed, frames, ms, precision)
                nc = (pitch * discount).to(dtype)
                for t in range(frames - absorbed):
                    if cost is None:
                        cost = -nc[t]
                        ptrs.append(torch.arange(nc.shape[1], device=x.device))
                    else:
                        best, arg = torch.min(cost[:, None] + trans, dim=0)
                        cost = best - nc[t]
                        ptrs.append(arg)
                    if precision != "viterbi32":
                        cost = cost - cost.min()
                voicings.extend(voicing)
                absorbed = frames
            if call < n_calls - 1:
                count = min(max(absorbed - emitted - self.lookahead, 0), self.chunk_frames)
                if count:
                    emit(call, count)
                    emitted += count
        if absorbed > emitted:
            emit(n_calls - 1, absorbed - emitted)
        out = []
        for parts in calls:
            f0 = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0)
            nccf = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0)
            out.append((f0, nccf))
        return out

    # -- the columns ------------------------------------------------------

    def columns(self, calls):
        """``(frames, 3)``: each emitted frame's columns as the call that
        emits it computes them (step 7)."""
        f0 = np.concatenate([c[0] for c in calls])
        nccf = np.concatenate([c[1] for c in calls])
        T, W, dw = f0.shape[0], self.norm_window, self.delta_window
        logf0 = np.log(np.where(f0 > 0, f0, 1.0))
        w = _pov(nccf) + 1e-6
        d = np.arange(-dw, dw + 1)
        taps = d / float((d * d).sum())
        out = np.zeros((T, 3))
        n = done = 0
        for k, (f, _) in enumerate(calls):
            n += f.shape[0]
            upto = n if k == len(calls) - 1 else max(n - dw, 0)
            for t in range(done, upto):
                lo, hi = max(t - W // 2, 0), min(t - W // 2 + W, n)
                mean = (w[lo:hi] * logf0[lo:hi]).sum() / max(w[lo:hi].sum(), 1e-6)
                dlog = (taps * logf0[np.clip(t + d, 0, n - 1)]).sum()
                out[t] = 2.0 * ((1.001 - nccf[t]) ** 0.15 - 1.0), logf0[t] - mean, dlog
            done = max(done, upto)
        return out

    def features(self, signal, frames: int, device="cpu", precision: str = "float64"):
        """``(frames, 3)`` float64 numpy rows of one session fed in the
        cell's chunks: the columns, past the track its last row, zeros
        with none (the signature of :meth:`PitchSpec.features`)."""
        track = self.columns(self.track_calls(signal, None, device, precision))
        out = np.zeros((frames, 3))
        v = min(track.shape[0], frames)
        if v:
            out[:v] = track[:v]
            out[v:] = track[v - 1]
        return out
