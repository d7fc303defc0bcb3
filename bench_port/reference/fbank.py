"""Plain log-mel filter-bank features: the benchmark's reference.

A frozen, self-contained statement of what a configuration of
``bench_port/configs/`` computes, written from the published recipe
(Kaldi ``compute-fbank-feats`` framing and mel bank, HTK's mel scale) in
plain PyTorch.  It imports nothing of the program under test and takes
nothing the program built: the mel bank, the window, the DFT, the power,
the log and its floor are all worked out here from the configuration's
numbers.

Semantics (those of the configurations' ``"computer"`` block):

- frames of ``frame_length_ms`` every ``frame_shift_ms``, centred, the
  first frame starting ``frame_length // 2 - frame_shift // 2`` samples
  before sample 0 under ``kaldi_shift`` (else ``(frame_length + 1) // 2 -
  1``); samples outside the signal are its symmetric reflection (as
  ``numpy.pad(..., "symmetric")``), at any depth;
- ``(len + shift // 2) // shift`` frames, none for a signal shorter than
  half a frame plus one sample;
- a unit-normalised Hann window (``hanning(K) / (0.5 (K - 1))``), a DFT of
  the next power of two, the power (or magnitude) spectrum;
- ``num_filts`` filters triangular in mel (``1127 ln(1 + f / 700)``)
  between ``low_hz`` and ``high_hz``, each DFT bin weighted by twice the
  triangle (power) or twice its square root (magnitude);
- ``log(max(x, 1e-5))``.

``precision`` picks the arithmetic: ``"float64"`` (the reference),
``"float32"`` (IEEE float32, TF32 off) and ``"tf32"`` (every product's
operands rounded to TF32, as the tensor cores read them, summed in
float32): the last two are the controls, the precisions just below what
the configurations state.
"""

import contextlib
import math

import numpy as np
import torch

__all__ = ["LOG_FLOOR", "FbankSpec", "frame_count", "frames_done_after"]

LOG_FLOOR = 1e-5


def _mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_inv(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def frame_count(n: int, frame_length: int, frame_shift: int) -> int:
    """Frames of an ``n``-sample signal."""
    if n < frame_length // 2 + 1:
        return 0
    return (n + frame_shift // 2) // frame_shift


def frames_done_after(n: int, total: int, frame_length: int, frame_shift: int,
                      pad_left: int) -> int:
    """Frames a stream can have emitted once its first ``n`` samples of
    ``total`` have arrived: those that read no sample past ``n`` (the
    last frames, which read the right reflection, wait for the end)."""
    if n >= total:
        return frame_count(total, frame_length, frame_shift)
    ready = (n + pad_left - frame_length) // frame_shift + 1
    return max(0, min(ready, frame_count(total, frame_length, frame_shift)))


class FbankSpec:
    """The numbers of one configuration's ``"computer"`` block."""

    def __init__(self, computer: dict):
        bank = computer["bank"]
        if bank.get("name") != "fbank" or computer.get("name") != "stft":
            raise ValueError("the reference computes STFT fbank configurations only")
        if computer.get("frame_style", "centered") != "centered":
            raise ValueError("the reference computes centred frames only")
        if bank.get("analytic", False):
            raise ValueError("the reference computes real banks only")
        self.rate = int(bank["sampling_rate"])
        self.num_filts = int(bank["num_filts"])
        self.low_hz = float(bank.get("low_hz", 20.0))
        self.high_hz = float(bank.get("high_hz") or self.rate // 2)
        self.frame_length = int(0.001 * computer["frame_length_ms"] * self.rate)
        self.frame_shift = int(0.001 * computer["frame_shift_ms"] * self.rate)
        self.dft_size = 1 << (self.frame_length - 1).bit_length()
        self.use_power = bool(computer.get("use_power", False))
        self.use_log = bool(computer.get("use_log", True))
        self.include_energy = bool(computer.get("include_energy", False))
        if computer.get("kaldi_shift", False):
            self.pad_left = self.frame_length // 2 - self.frame_shift // 2
        else:
            self.pad_left = (self.frame_length + 1) // 2 - 1
        self.num_coeffs = self.num_filts + int(self.include_energy)

    # -- host tables, float64 ------------------------------------------

    def weights(self) -> np.ndarray:
        """``(dft // 2 + 1, num_filts)``: each bin's weight in each filter."""
        half = self.dft_size // 2 + 1
        lo, hi = _mel(self.low_hz), _mel(self.high_hz)
        step = (hi - lo) / (self.num_filts + 1)
        vertices = _mel_inv(lo + step * np.arange(self.num_filts + 2))
        w = np.zeros((half, self.num_filts))
        for f in range(self.num_filts):
            left = math.ceil(self.dft_size * vertices[f] / self.rate)
            right = int(self.dft_size * vertices[f + 2] / self.rate)
            idx = np.arange(left, min(half, right + 1))
            mel = _mel(self.rate * idx / self.dft_size)
            l_m, m_m, r_m = _mel(vertices[f: f + 3])
            tri = np.where(mel <= m_m, (mel - l_m) / (m_m - l_m), (r_m - mel) / (r_m - m_m))
            w[idx, f] = 2.0 * (tri if self.use_power else np.sqrt(tri))
        return w

    def dft(self):
        """Window-folded ``(frame_length, dft // 2 + 1)`` cos and sin."""
        K = self.frame_length
        window = np.hanning(K) / (0.5 * max(1, K - 1))
        ang = 2.0 * np.pi * np.outer(np.arange(K), np.arange(self.dft_size // 2 + 1)) / self.dft_size
        return np.cos(ang) * window[:, None], -np.sin(ang) * window[:, None]

    def filter_spans(self) -> np.ndarray:
        """``(num_filts, 2)``: each filter's first and one-past-last bin
        with a nonzero weight among bins ``0 .. dft // 2 - 1``."""
        w = self.weights()[: self.dft_size // 2] != 0
        spans = np.zeros((self.num_filts, 2), dtype=np.int64)
        for f in range(self.num_filts):
            nz = np.flatnonzero(w[:, f])
            if nz.size:
                spans[f] = nz[0], nz[-1] + 1
        return spans

    def frame_count(self, n: int) -> int:
        return frame_count(n, self.frame_length, self.frame_shift)

    def frames_done_after(self, n: int, total: int) -> int:
        return frames_done_after(n, total, self.frame_length, self.frame_shift, self.pad_left)

    # -- features ------------------------------------------------------

    def tables(self, device, precision: str = "float64"):
        dtype = torch.float64 if precision == "float64" else torch.float32
        cos, sin = self.dft()
        return tuple(torch.tensor(a, dtype=dtype, device=device)
                     for a in (cos, sin, self.weights()))

    def features(self, signal, device="cpu", precision: str = "float64", tables=None):
        """``(frames, num_filts)`` float64 numpy features of one signal."""
        if self.include_energy:
            raise ValueError("the reference computes banks without an energy column")
        sig = torch.as_tensor(np.asarray(signal, dtype=np.float64), device=device)
        n = sig.shape[0]
        nf = self.frame_count(n)
        if nf == 0:
            return np.zeros((0, self.num_coeffs))
        cos, sin, w = tables if tables is not None else self.tables(device, precision)
        pos = (torch.arange(nf, device=device)[:, None] * self.frame_shift - self.pad_left
               + torch.arange(self.frame_length, device=device)[None, :])
        period = 2 * n
        m = torch.remainder(pos, period)
        frames = sig[torch.where(m < n, m, period - 1 - m)].to(cos.dtype)
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        with _ieee():
            re, im = _matmul(frames, cos, precision), _matmul(frames, sin, precision)
            power = re * re + im * im
            spec = power if self.use_power else torch.sqrt(power)
            feats = _matmul(spec, w, precision)
        if self.use_log:
            feats = torch.log(torch.clamp_min(feats, LOG_FLOOR))
        return feats.to(torch.float64).cpu().numpy()


def _tf32(x):
    """``x`` (float32) rounded to TF32, as the tensor cores read a float32
    operand in TF32 mode: 10 mantissa bits, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def _matmul(a, b, precision: str):
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    return a @ b


@contextlib.contextmanager
def _ieee():
    """float32 products in IEEE float32 (TF32 off) inside the block; the
    caller's setting comes back after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
