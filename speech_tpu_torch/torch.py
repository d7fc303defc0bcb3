"""PyTorch compatibility layer.

The counterpart of :mod:`speech_tpu.torch`, with the reference's torch
module surface (reference: src/pydrobert/speech/torch.py): every class has
a ``from_*`` classmethod that converts the corresponding object of this
package (its computers, :mod:`speech_tpu_torch.pre` and
:mod:`speech_tpu_torch.post` instances), and the computers hold their
precomputed arrays as learnable :class:`torch.nn.Parameter`s (reference:
torch.py:362-366) on the computer's device: the GPU unless the computer
was built with ``device="cpu"``.

The computers run the *folded-weight* formulation (see
:mod:`speech_tpu_torch.ops.stft`): window -> rFFT -> |.|^p -> one matmul,
no per-filter truncated-response walk; the short-integration computer is
one FFT convolution against all FIRs (the reference's is a numpy
round-trip wrapper, reference: torch.py:475-522).  They are plain
differentiable tensor code: no hand-written kernel runs here.

Import it lazily, as ``import speech_tpu_torch.torch``: the package does
not import it.
"""

from typing import Collection, Optional

import numpy as np
import torch

from . import config
from .compute import SIFrameComputer, STFTFrameComputer
from .post import PostProcessor
from .pre import Dither, Preemphasize

__all__ = [
    "check_in",
    "check_positive",
    "pytorch_dither",
    "pytorch_preemphasize",
    "pytorch_si_frame_computer",
    "pytorch_stft_frame_computer",
    "PyTorchDither",
    "PyTorchPostProcessorWrapper",
    "PyTorchPreemphasize",
    "PyTorchShortIntegrationFrameComputer",
    "PyTorchShortTimeFourierTransformFrameComputer",
    "PyTorchSTFTFrameComputer",
    "PyTorchSIFrameComputer",
]


def check_in(name: str, val: str, choices: Collection[str]) -> None:
    """Raise :class:`ValueError` unless ``val`` is one of ``choices``.

    Public argument-validation helper mirroring the reference's torch
    surface (reference: torch.py:61-64).
    """
    if val not in choices:
        allowed = ", ".join(repr(c) for c in sorted(choices))
        raise ValueError(f"{name} must be one of {allowed}; got {val!r}")


def check_positive(name: str, val, nonnegative: bool = False) -> None:
    """Raise :class:`ValueError` unless ``val`` > 0 (>= 0 if nonnegative).

    Public argument-validation helper mirroring the reference's torch
    surface (reference: torch.py:67-70).
    """
    if val < 0 or (val == 0 and not nonnegative):
        kind = "non-negative" if nonnegative else "positive"
        raise ValueError(f"{name} must be {kind}; got {val}")


def pytorch_preemphasize(sig: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """``y[t] = x[t] - coeff * x[t-1]``, ``y[0] = x[0]``
    (reference: pre.py:112-115)."""
    return torch.cat([sig[:1], sig[1:] - coeff * sig[:-1]])


class PyTorchPreemphasize(torch.nn.Module):
    """Pre-emphasize a signal (torch twin of
    :class:`speech_tpu_torch.pre.Preemphasize`)."""

    def __init__(self, coeff: float = 0.97):
        super().__init__()
        self.coeff = float(coeff)

    @classmethod
    def from_preemphasize(cls, preemphasize: Preemphasize):
        return cls(preemphasize.coeff)

    def forward(self, sig: torch.Tensor) -> torch.Tensor:
        return pytorch_preemphasize(sig, self.coeff)

    def extra_repr(self) -> str:
        return f"coeff={self.coeff}"


def pytorch_dither(sig: torch.Tensor, coeff: float = 1.0) -> torch.Tensor:
    """Add Gaussian noise of standard deviation ``coeff``
    (reference: pre.py:67-104)."""
    return sig + coeff * torch.randn_like(sig)


class PyTorchDither(torch.nn.Module):
    """Additive Gaussian dither (torch twin of
    :class:`speech_tpu_torch.pre.Dither`).  Active in training mode only."""

    def __init__(self, coeff: float = 1.0):
        super().__init__()
        self.coeff = float(coeff)

    @classmethod
    def from_dither(cls, dither: Dither):
        return cls(dither.coeff)

    def forward(self, sig: torch.Tensor) -> torch.Tensor:
        if self.training and self.coeff:
            return pytorch_dither(sig, self.coeff)
        return sig

    def extra_repr(self) -> str:
        return f"coeff={self.coeff}"


@torch.jit.script_if_tracing
def pytorch_stft_frame_computer(
    sig: torch.Tensor,
    weights: torch.Tensor,
    frame_length: int,
    frame_shift: int,
    centered: bool = True,
    window: Optional[torch.Tensor] = None,
    dft_size: Optional[int] = None,
    use_log: bool = True,
    use_power: bool = False,
    include_energy: bool = False,
    kaldi_shift: bool = False,
    eps: float = config.LOG_FLOOR_VALUE,
) -> torch.Tensor:
    """Functional folded-weight STFT frame computer.

    ``weights``: nonnegative ``(dft_size//2 + 1, num_filts)`` half-spectrum
    filter matrix (conjugate wrap and the x2-real factor already folded in
    by :func:`speech_tpu_torch.ops.stft.fold_bank_to_weights`); features are
    ``matmul(|rfft(window * frames)|^p, weights)``.  Output/edge semantics
    match the host ``compute_full`` (reference: compute.py:574-607):
    ``(len + shift//2) // shift`` frames, symmetric padding.
    """
    if sig.ndim != 1:
        raise RuntimeError(f"Expected sig to be 1-dimensional; got {sig.ndim}")
    if dft_size is None:
        # next power of two, TorchScript-compatible (math.log2 is not)
        dft_size = 1
        while dft_size < frame_length:
            dft_size *= 2
    num_filts = weights.size(1)
    sig_len = sig.size(0)
    if sig_len < frame_length // 2 + 1:
        return sig.new_empty((0, num_filts + int(include_energy)))
    if not centered:
        pad_left = 0
    elif kaldi_shift:
        pad_left = frame_length // 2 - frame_shift // 2
    else:
        pad_left = (frame_length + 1) // 2 - 1
    num_frames = max(0, (sig_len + frame_shift // 2) // frame_shift)
    total_len = (num_frames - 1) * frame_shift - pad_left + frame_length
    pad_right = max(0, total_len - sig_len)
    if pad_left or pad_right:
        sig = torch.cat(
            [sig[:pad_left].flip(0), sig, sig[sig_len - pad_right :].flip(0)]
        )
    frames = sig.as_strided((num_frames, frame_length), (frame_shift, 1))
    outs = []
    if include_energy:
        energy = frames.square().sum(1) / frame_length
        if not use_power:
            energy = energy.sqrt()
        outs.append(energy)
    windowed = frames if window is None else frames * window
    spect = torch.fft.rfft(windowed, dft_size, 1)
    power = spect.real.square() + spect.imag.square()
    spec = power if use_power else power.clamp_min(0).sqrt()
    outs.append(spec @ weights)
    feats = torch.cat(
        [o.unsqueeze(1) if o.ndim == 1 else o for o in outs], dim=1
    )
    if use_log:
        feats = feats.clamp_min(eps).log()
    return feats


class PyTorchShortTimeFourierTransformFrameComputer(torch.nn.Module):
    """Torch module STFT computer with learnable window and filter weights.

    Build with :meth:`from_stft_frame_computer`; ``forward`` maps a 1-D
    signal to ``(num_frames, num_coeffs)``.
    """

    def __init__(
        self,
        weights: torch.Tensor,
        window: torch.Tensor,
        frame_shift: int,
        centered: bool = True,
        dft_size: Optional[int] = None,
        use_log: bool = True,
        use_power: bool = False,
        include_energy: bool = False,
        kaldi_shift: bool = False,
        eps: float = config.LOG_FLOOR_VALUE,
    ):
        super().__init__()
        self.weights = torch.nn.Parameter(weights)
        self.window = torch.nn.Parameter(window)
        self.frame_length = window.size(0)
        self.frame_shift = int(frame_shift)
        self.centered = bool(centered)
        self.dft_size = dft_size
        self.use_log = bool(use_log)
        self.use_power = bool(use_power)
        self.include_energy = bool(include_energy)
        self.kaldi_shift = bool(kaldi_shift)
        self.eps = float(eps)

    @classmethod
    def from_stft_frame_computer(cls, computer: STFTFrameComputer):
        device = computer.device
        return cls(
            torch.as_tensor(np.asarray(computer._weights, dtype=np.float32), device=device),
            torch.as_tensor(np.asarray(computer._window, dtype=np.float32), device=device),
            computer.frame_shift,
            centered=computer.frame_style == "centered",
            dft_size=computer.dft_size,
            use_log=computer._log,
            use_power=computer._power,
            include_energy=computer.includes_energy,
            kaldi_shift=computer.kaldi_shift,
        )

    def forward(self, sig: torch.Tensor) -> torch.Tensor:
        return pytorch_stft_frame_computer(
            sig,
            self.weights,
            self.frame_length,
            self.frame_shift,
            centered=self.centered,
            window=self.window,
            dft_size=self.dft_size,
            use_log=self.use_log,
            use_power=self.use_power,
            include_energy=self.include_energy,
            kaldi_shift=self.kaldi_shift,
            eps=self.eps,
        )


PyTorchSTFTFrameComputer = PyTorchShortTimeFourierTransformFrameComputer


@torch.jit.script_if_tracing
def pytorch_si_frame_computer(
    sig: torch.Tensor,
    firs: torch.Tensor,
    window: torch.Tensor,
    frame_shift: int,
    shift_eff: int,
    translation: int,
    use_log: bool = True,
    use_power: bool = False,
    include_energy: bool = False,
    eps: float = config.LOG_FLOOR_VALUE,
) -> torch.Tensor:
    """Functional vectorized SI computer (closed form of the reference's
    overlap-save machinery, reference: compute.py:613-999): one FFT
    convolution against all FIRs, pointwise modulus/power, windowed
    integration.  TorchScript-compatible; under ``torch.jit.trace`` it is
    scripted instead, so traces generalize across signal lengths."""
    if sig.ndim != 1:
        raise RuntimeError(f"Expected sig to be 1-dimensional; got {sig.ndim}")
    shift = frame_shift
    T = firs.size(1)
    sig_len = sig.size(0)
    target = (sig_len + shift // 2) // shift
    after_pad = (target * shift + T - 1 - shift_eff) // shift - 1
    num_frames = max(0, min(target, after_pad))
    num_coeffs = firs.size(0) + int(include_energy)
    if num_frames == 0:
        return sig.new_empty((0, num_coeffs))
    ny = (num_frames + 1) * shift
    # next power of two >= sig_len + T - 1 (int.bit_length and math.log2
    # are not TorchScript-compatible)
    fft_size = 1
    while fft_size < sig_len + T - 1:
        fft_size *= 2
    is_real = not firs.is_complex()
    if is_real:
        X = torch.fft.rfft(sig, fft_size)
        H = torch.fft.rfft(firs, fft_size, 1)
        conv = torch.fft.irfft(X.unsqueeze(0) * H, fft_size, 1)
    else:
        Xc = torch.fft.fft(sig.to(firs.dtype), fft_size)
        Hc = torch.fft.fft(firs, fft_size, 1)
        conv = torch.fft.ifft(Xc.unsqueeze(0) * Hc, fft_size, 1)
    n_idx = torch.arange(ny, device=sig.device) + shift_eff
    valid = (n_idx >= 0) & (n_idx < sig_len + T - 1)
    y = conv[:, n_idx.clamp(0, fft_size - 1)]
    y = torch.where(valid.unsqueeze(0), y, torch.zeros_like(y))
    if use_power:
        y_mod = y.square() if is_real else (y * y.conj()).real
    else:
        y_mod = y.abs()
    if include_energy:
        e_idx = torch.arange(ny, device=sig.device) + shift_eff - translation
        e_valid = (e_idx >= 0) & (e_idx < sig_len)
        xe = sig[e_idx.clamp(0, sig_len - 1)]
        xe = torch.where(e_valid, xe, torch.zeros_like(xe))
        e_mod = xe.square() if use_power else xe.abs()
        y_mod = torch.cat([e_mod.unsqueeze(0), y_mod])
    idx = (
        torch.arange(num_frames, device=sig.device).unsqueeze(1) * shift
        + torch.arange(2 * shift, device=sig.device).unsqueeze(0)
    )
    framed = y_mod[:, idx]  # (F, num_frames, 2*shift)
    feats = torch.einsum("fkt,t->kf", framed, window)
    if use_log:
        feats = feats.clamp_min(eps).log()
    return feats


class PyTorchShortIntegrationFrameComputer(torch.nn.Module):
    """Vectorized torch SI computer with learnable FIRs and window.

    Runs the closed form of the reference's overlap-save machinery (see
    :mod:`speech_tpu_torch.ops.si`): one FFT convolution against all FIRs,
    pointwise modulus/power, and a windowed integration gather.
    """

    def __init__(
        self,
        firs: torch.Tensor,
        window: torch.Tensor,
        frame_shift: int,
        shift_eff: int,
        translation: int,
        use_log: bool = True,
        use_power: bool = False,
        include_energy: bool = False,
        eps: float = config.LOG_FLOOR_VALUE,
    ):
        super().__init__()
        self.firs = torch.nn.Parameter(firs)
        self.window = torch.nn.Parameter(window)
        self.frame_shift = int(frame_shift)
        self.shift_eff = int(shift_eff)
        self.translation = int(translation)
        self.use_log = bool(use_log)
        self.use_power = bool(use_power)
        self.include_energy = bool(include_energy)
        self.eps = float(eps)

    @classmethod
    def from_si_frame_computer(cls, computer: SIFrameComputer):
        k = computer._kernel
        device = computer.device
        firs = np.asarray(k["firs"])
        firs = torch.as_tensor(
            firs.astype(np.complex64 if np.iscomplexobj(firs) else np.float32),
            device=device,
        )
        return cls(
            firs,
            torch.as_tensor(np.asarray(k["window"], dtype=np.float32), device=device),
            computer.frame_shift,
            k["shift_eff"],
            k["translation"],
            use_log=computer._log,
            use_power=computer._power,
            include_energy=computer.includes_energy,
        )

    def forward(self, sig: torch.Tensor) -> torch.Tensor:
        return pytorch_si_frame_computer(
            sig,
            self.firs,
            self.window,
            self.frame_shift,
            self.shift_eff,
            self.translation,
            use_log=self.use_log,
            use_power=self.use_power,
            include_energy=self.include_energy,
            eps=self.eps,
        )


PyTorchSIFrameComputer = PyTorchShortIntegrationFrameComputer


class PyTorchPostProcessorWrapper(torch.nn.Module):
    """Wrap a host post-processor for use in torch pipelines.

    A numpy round trip (CPU), matching the reference's wrapper semantics
    (reference: torch.py:435-472); gradients do not flow through.  For a
    differentiable device path use :mod:`speech_tpu_torch.ops.postops`.
    """

    def __init__(self, postprocessor: PostProcessor, axis: int = -1):
        super().__init__()
        self.postprocessor = postprocessor
        self.axis = axis

    @classmethod
    def from_postprocessor(cls, postprocessor: PostProcessor, axis: int = -1):
        return cls(postprocessor, axis)

    def forward(self, sig: torch.Tensor) -> torch.Tensor:
        dtype, device = sig.dtype, sig.device
        out = self.postprocessor.apply(
            sig.detach().cpu().double().numpy(), axis=self.axis
        )
        return torch.as_tensor(out).to(device=device, dtype=dtype)
