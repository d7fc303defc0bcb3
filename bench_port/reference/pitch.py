"""Plain Kaldi-style pitch features: the benchmark's reference for a
configuration's ``"pitch"`` block.

A frozen, self-contained statement of the tracker of Ghahremani et al.,
"A pitch extraction algorithm tuned for automatic speech recognition"
(ICASSP 2014), as Kaldi's ``compute-kaldi-pitch-feats`` and
``process-kaldi-pitch-feats`` compute it and as the program states its
own departures from Kaldi.  Plain PyTorch in float64, one utterance at a
time, with no batching; it imports nothing of the program under test and
builds every table here from the configuration's numbers.

The steps, for one utterance of ``n`` samples at ``rate``:

1. Resampling to ``resample_rate`` by the rational factor ``up / down``
   (reduced): a Kaiser-windowed sinc (half-width 10 taps of the slower
   rate, beta 5, cutoff at the lower Nyquist, unit DC gain times ``up``),
   ``y[m] = sum_i x[i] h[K + m down - i up]``, ``ceil(n up / down)``
   samples, the signal zero outside itself.
2. A zero-phase lowpass at ``lowpass_cutoff``: a windowed sinc of
   half-width 32 under a Kaiser window of beta 5, unit DC gain, over the
   same samples.
3. Frames of ``window = frame_length_ms`` every ``shift =
   frame_shift_ms`` (at the working rate), each spanning ``window +
   max_int_lag`` samples, its mean removed over that span; ``(n' - span)
   // shift + 1`` frames (none when the signal is shorter than a span).
4. The NCCF at every integer lag ``l`` from ``floor(rate / max_f0) - 8``
   (at least 1) to ``ceil(rate / min_f0) + 8``: ``inner / sqrt((e1 + b)
   (e2 + b))`` with the ballast ``b = nccf_ballast * window *
   mean_square(signal)`` (the pitch NCCF), and ``inner / sqrt(e1 e2)``
   (the voicing NCCF, clipped to [-1, 1]).
5. Both onto the geometric lag grid from ``rate / max_f0`` to ``rate /
   min_f0`` of relative step ``lag_resolution`` (the last point at the
   longest lag) by a sinc under a Kaiser window of half-width 8 and beta
   6, each column renormalised to unit sum.
6. The soft-min-f0 discount: the pitch NCCF times ``1 - min(soft_min_f0
   * lag / rate, 1)``.
7. The whole-utterance Viterbi path minimising ``sum -nccf + penalty *
   log(lag_i / lag_j)^2`` over neighbouring frames, ties to the first
   index at every step (the back-pointers of the forward pass).
8. A parabola in log-lag through the voicing NCCF at the chosen lag and
   its neighbours (inner lags only, its offset clipped to half a step)
   gives ``f0``; the voicing NCCF at the chosen lag is kept.
9. The columns: POV ``2 ((1.001 - nccf)^0.15 - 1)``; log ``f0`` less its
   mean weighted by ``pov(nccf) + 1e-6`` (``pov`` the paper's eq. 2)
   over a centred window of ``normalization_window`` frames clipped at
   the utterance's ends; the delta of log ``f0``, the Kaldi order-1
   filter ``d / sum d^2`` for ``d`` in ``[-delta_window, delta_window]``,
   the edge frames replicated.
10. The tail rule of pasting pitch onto features: ``frames`` rows, those
    past the track repeating its last frame, all zeros with no track.

``precision``: ``"float64"`` (the reference), ``"tf32"`` (the NCCF's
products read their operands rounded to TF32, as the tensor cores read
float32, and sum in float32: the control a notch below the
configuration's IEEE float32) and ``"viterbi32"`` (the Viterbi's costs in
float32 with no per-step shift, which strays from the float64 path on
long utterances: a second control).
"""

import math
from math import gcd

import numpy as np
import torch

from .fbank import _tf32

__all__ = ["PRECISIONS", "PitchSpec"]

PRECISIONS = ("float64", "tf32", "viterbi32")

_RESAMPLE_HW, _RESAMPLE_BETA = 10, 5.0
_LOWPASS_HW, _LOWPASS_BETA = 32, 5.0
_INTERP_HW, _INTERP_BETA = 8, 6.0
_TINY = 1e-30


def _kaiser(x, half_width, beta):
    """A Kaiser window at offsets ``x`` from its centre (zero beyond
    ``half_width``)."""
    arg = np.clip(1.0 - (np.asarray(x, np.float64) / half_width) ** 2, 0.0, None)
    return np.where(np.abs(x) <= half_width, np.i0(beta * np.sqrt(arg)) / np.i0(beta), 0.0)


class PitchSpec:
    """The numbers of a configuration's ``"pitch"`` block at the input
    ``rate``, and the tables built from them."""

    KEYS = ("min_f0", "max_f0", "frame_length_ms", "frame_shift_ms", "resample_rate",
            "lowpass_cutoff", "penalty_factor", "nccf_ballast", "soft_min_f0",
            "lag_resolution", "normalization_window", "delta_window")

    def __init__(self, pitch: dict, rate: int):
        missing = [k for k in self.KEYS if k not in pitch]
        if missing:
            raise ValueError(f"the pitch block lacks {missing}")
        p = {k: pitch[k] for k in self.KEYS}
        self.rate = int(rate)
        self.work_rate = float(p["resample_rate"])
        g = gcd(self.rate, int(self.work_rate))
        self.up, self.down = int(self.work_rate) // g, self.rate // g
        self.window = int(round(p["frame_length_ms"] * self.work_rate / 1000.0))
        self.shift = int(round(p["frame_shift_ms"] * self.work_rate / 1000.0))
        self.cutoff = float(p["lowpass_cutoff"])
        self.penalty = float(p["penalty_factor"])
        self.ballast = float(p["nccf_ballast"])
        self.soft_min_f0 = float(p["soft_min_f0"])
        self.resolution = float(p["lag_resolution"])
        self.norm_window = int(p["normalization_window"])
        self.delta_window = int(p["delta_window"])
        min_lag = self.work_rate / float(p["max_f0"])
        max_lag = self.work_rate / float(p["min_f0"])
        n = int(math.ceil(math.log(max_lag / min_lag) / math.log1p(self.resolution)))
        self.lags = min_lag * (1.0 + self.resolution) ** np.arange(n + 1)
        self.lags[-1] = max_lag
        self.lo_int = max(int(math.floor(min_lag)) - _INTERP_HW, 1)
        self.int_lags = np.arange(self.lo_int, int(math.ceil(max_lag)) + _INTERP_HW + 1)
        self.span = self.window + int(self.int_lags[-1])

    # -- host tables, float64 ------------------------------------------

    def resample_filter(self) -> np.ndarray:
        K = _RESAMPLE_HW * max(self.up, self.down)
        cutoff = 1.0 / max(self.up, self.down)
        t = np.arange(-K, K + 1, dtype=np.float64)
        h = cutoff * np.sinc(cutoff * t) * _kaiser(t, K, _RESAMPLE_BETA)
        return h * (self.up / h.sum())

    def lowpass_filter(self) -> np.ndarray:
        t = np.arange(-_LOWPASS_HW, _LOWPASS_HW + 1, dtype=np.float64)
        c = 2.0 * self.cutoff / self.work_rate
        h = c * np.sinc(c * t) * _kaiser(t, _LOWPASS_HW, _LOWPASS_BETA)
        return h / h.sum()

    def interpolation(self) -> np.ndarray:
        """``(integer lags, grid lags)``: the NCCF's map onto the grid."""
        d = self.lags[None, :] - self.int_lags[:, None].astype(np.float64)
        m = np.sinc(d) * _kaiser(d, _INTERP_HW, _INTERP_BETA)
        s = m.sum(axis=0)
        return m / np.where(np.abs(s) > 1e-3, s, 1.0)

    def transitions(self) -> np.ndarray:
        log = np.log(self.lags)
        return self.penalty * (log[:, None] - log[None, :]) ** 2

    # -- frame counts ---------------------------------------------------

    def frame_count(self, n: int) -> int:
        """Tracked frames of an ``n``-sample utterance."""
        m = -(-int(n) * self.up // self.down)
        return (m - self.span) // self.shift + 1 if m >= self.span else 0

    # -- the track and the columns --------------------------------------

    def _resample(self, x):
        if (self.up, self.down) == (1, 1):
            return x
        h = torch.tensor(self.resample_filter(), dtype=x.dtype, device=x.device)
        K = (h.shape[0] - 1) // 2
        n = x.shape[0]
        m = torch.arange(-(-n * self.up // self.down), device=x.device)
        first = -torch.div(-(m * self.down - K), self.up, rounding_mode="floor")
        i = first[:, None] + torch.arange(2 * K // self.up + 2, device=x.device)[None, :]
        tap = K + m[:, None] * self.down - i * self.up
        ok = (tap >= 0) & (tap <= 2 * K) & (i >= 0) & (i < n)
        vals = x[i.clamp(0, n - 1)] * h[tap.clamp(0, 2 * K)]
        return torch.where(ok, vals, 0.0).sum(dim=1)

    def _lowpass(self, x):
        if not self.cutoff or self.cutoff >= self.work_rate / 2:
            return x
        h = torch.tensor(self.lowpass_filter(), dtype=x.dtype, device=x.device)
        padded = torch.nn.functional.pad(x, (_LOWPASS_HW, _LOWPASS_HW))
        return padded.unfold(0, h.shape[0], 1) @ h

    def _nccf(self, x, nf: int, precision: str):
        """``(pitch, voicing)`` NCCFs on the lag grid, ``(nf, lags)``."""
        ms = (x * x).sum() / max(x.shape[0], 1)
        b = self.ballast * self.window * ms
        starts = torch.arange(nf, device=x.device) * self.shift
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

    def _viterbi(self, nc, precision: str) -> np.ndarray:
        """The lowest-cost lag path of ``(nf, lags)`` local scores."""
        dtype = torch.float32 if precision == "viterbi32" else torch.float64
        nc = nc.to(dtype)
        trans = torch.tensor(self.transitions(), dtype=dtype, device=nc.device)
        cost = -nc[0]
        back = []
        for t in range(1, nc.shape[0]):
            best, arg = torch.min(cost[:, None] + trans, dim=0)
            back.append(arg)
            cost = best - nc[t]
        j = int(torch.argmin(cost))
        back = torch.stack(back).cpu().numpy() if back else np.zeros((0, nc.shape[1]), int)
        path = [j]
        for ptr in back[::-1]:
            j = int(ptr[j])
            path.append(j)
        return np.asarray(path[::-1])

    def track(self, signal, device="cpu", precision: str = "float64"):
        """``(f0, nccf)`` float64 tensors of one utterance's tracked
        frames."""
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        x = torch.as_tensor(np.asarray(signal, dtype=np.float64), device=device)
        x = self._lowpass(self._resample(x))
        nf = self.frame_count(len(signal))
        if nf == 0:
            return x.new_zeros(0), x.new_zeros(0)
        pitch, voicing = self._nccf(x, nf, precision)
        lags = torch.tensor(self.lags, dtype=x.dtype, device=x.device)
        discount = 1.0 - torch.clamp(self.soft_min_f0 * lags / self.work_rate, max=1.0)
        path = torch.as_tensor(self._viterbi(pitch * discount, precision), device=x.device)
        L = lags.shape[0]
        rows = torch.arange(nf, device=x.device)
        nccf = voicing[rows, path]
        jc = path.clamp(1, L - 2)
        y1, y2, y3 = voicing[rows, jc - 1], voicing[rows, jc], voicing[rows, jc + 1]
        curv = y1 + y3 - 2.0 * y2
        safe = torch.where(curv.abs() > 1e-12, curv, torch.ones_like(curv))
        delta = torch.where(curv.abs() > 1e-12, 0.5 * (y1 - y3) / safe, 0.0)
        delta = torch.where((path > 0) & (path < L - 1), delta.clamp(-0.5, 0.5), 0.0)
        log_lag = torch.log(lags[path]) + delta * math.log1p(self.resolution)
        return self.work_rate * torch.exp(-log_lag), nccf

    def features(self, signal, frames: int, device="cpu", precision: str = "float64"):
        """``(frames, 3)`` float64 numpy rows: POV, normalised log pitch,
        delta log pitch, past the track its last row, zeros with none."""
        f0, nccf = self.track(signal, device, precision)
        T = f0.shape[0]
        out = np.zeros((frames, 3))
        if T == 0:
            return out
        pov_feat = 2.0 * ((1.001 - nccf) ** 0.15 - 1.0)
        logf0 = torch.log(f0)
        a = nccf.abs()
        w = torch.sigmoid(-5.2 + 5.4 * torch.exp(7.5 * (a - 1.0)) + 4.8 * a
                          - 2.0 * torch.exp(-10.0 * a) + 4.2 * torch.exp(20.0 * (a - 1.0))) + 1e-6
        # inside[t, s]: frame s lies in frame t's window, clipped at the ends
        t = torch.arange(T, device=f0.device)
        lo = (t - self.norm_window // 2).clamp(min=0)
        hi = (t - self.norm_window // 2 + self.norm_window).clamp(max=T)
        inside = ((t[None, :] >= lo[:, None]) & (t[None, :] < hi[:, None])).double()
        norm = logf0 - (inside @ (w * logf0)) / (inside @ w).clamp(min=1e-6)
        W = self.delta_window
        d = torch.arange(-W, W + 1, device=f0.device)
        taps = d.double() / float((d * d).sum())
        idx = (t[:, None] + d[None, :]).clamp(0, T - 1)
        dlog = (logf0[idx] * taps).sum(dim=1)
        track = torch.stack([pov_feat, norm, dlog], dim=1).cpu().numpy()
        v = min(T, frames)
        out[:v] = track[:v]
        out[v:] = track[v - 1]
        return out
