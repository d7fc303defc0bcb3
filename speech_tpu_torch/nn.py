"""Learnable feature frontends: the STFT computer as a trainable module.

The counterpart of :mod:`speech_tpu.nn`, as :class:`torch.nn.Module` s:
each learnable leaf of the JAX package's ``params`` dict is an
:class:`~torch.nn.Parameter` of the same name, each of its ``consts`` a
buffer, and ``forward`` is the JAX ``apply`` without the ``params`` and
``consts`` arguments.  Initial values are the JAX ``init()`` values, bit
for bit; :func:`params_from_jax` (or ``load_params`` of an ``.npz`` that
either package wrote) carries trained values across.

Unlike the inference path (:mod:`speech_tpu_torch.ops.stft`), the analysis
window is *not* folded into the DFT matrices here: it stays a separate
parameter so that its gradient exists.  Products run in IEEE float32 (or
float64) inside :func:`~speech_tpu_torch.ops.stft.ieee_float32`, the
counterpart of ``Precision.HIGHEST``.

Modules are built on ``"cuda"`` unless the caller passes ``device`` (an
:class:`STFTFrontend` follows its computer's device).
"""

import copy
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as TF

from . import config
from .compute import FrameComputer, STFTFrameComputer
from .alias import alias_factory_subclass_from_arg
from .ops import framing as _framing
from .ops import stft as _stft
from .ops._device import resolve_device
from .ops.stft import ieee_float32

__all__ = [
    "FeatureFrontend",
    "GaborFrontend",
    "PCEN",
    "STFTFrontend",
    "SincFrontend",
    "params_from_jax",
]


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[np.dtype(dtype).name]


def _dft_matrices(frame_length: int, dft_size: int):
    """Plain (windowless) real-DFT matrices ``C``, ``S``.

    ``Re X = (w * x) @ C``; ``Im X = (w * x) @ S``.
    """
    half_len = dft_size // 2 + 1
    t = np.arange(frame_length, dtype=np.float64)[:, None]
    b = np.arange(half_len, dtype=np.float64)[None, :]
    ang = 2 * np.pi * t * b / dft_size
    return np.cos(ang), -np.sin(ang)


def _safe_sqrt(x):
    """``sqrt`` with the zero one-sided subgradient at 0: d(sqrt)/dx is
    infinite there (an all-zero padded frame reaches it), and the inner
    ``where`` keeps that infinity out of the backward pass, where one
    ``where`` alone would still multiply it by zero into NaN."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), 0.0)


def _floor_log(x):
    return torch.log(torch.maximum(x, x.new_tensor(config.LOG_FLOOR_VALUE)))


class _Frontend(torch.nn.Module):
    """Checkpointing shared by the frontends: ``.npz`` files keyed by the
    parameter names, which are the JAX package's ``params`` keys."""

    def save_params(self, wfilename: str) -> None:
        """Checkpoint the learnable parameters to an ``.npz`` file."""
        np.savez(
            wfilename,
            **{k: v.detach().cpu().numpy() for k, v in self.named_parameters()},
        )

    def load_params(self, rfilename: str) -> dict:
        """Load a checkpoint written by :meth:`save_params` (of this
        package's module or of the JAX package's) into the parameters;
        returns them by name."""
        return params_from_jax(self, rfilename)


def params_from_jax(module: torch.nn.Module, params) -> dict:
    """Load a JAX frontend's ``params`` (a mapping of arrays, or the path
    of an ``.npz`` checkpoint) into ``module``'s parameters of the same
    names, cast to their dtype and device.  The keys must be exactly the
    module's parameters.  Returns the parameters by name."""
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as data:
            params = {k: data[k] for k in data.files}
    own = dict(module.named_parameters())
    if set(params) != set(own):
        raise ValueError(
            f"parameter keys {sorted(params)} != the module's {sorted(own)}"
        )
    with torch.no_grad():
        for name, p in own.items():
            value = torch.from_numpy(np.array(params[name]))  # a writable copy
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}"
                )
            p.copy_(value.to(dtype=p.dtype, device=p.device))
    return own


class STFTFrontend(_Frontend):
    """A trainable STFT feature frontend.

    ``frontend = STFTFrontend(computer)``; ``feats = frontend(signals,
    lengths)``.  Learnable parameters are the analysis ``window`` and the
    folded half-spectrum filter ``weights`` -- the reference's learnable
    ``_window``/``_filt_pack`` (reference: torch.py:362-412).  The windowless
    DFT matrices are the buffers ``dft_cos`` and ``dft_sin``.

    Parameters
    ----------
    computer
        A :class:`~speech_tpu_torch.compute.STFTFrameComputer` (or the
        kwargs to build one) whose precomputed arrays seed the parameters.
    dtype
        Parameter/computation dtype.
    device
        Where the module lives; defaults to the computer's device.
    """

    def __init__(
        self,
        computer: Union[STFTFrameComputer, Mapping, str],
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if not isinstance(computer, STFTFrameComputer):
            if isinstance(computer, Mapping) and device is not None:
                computer = {**computer, "device": device}
            computer = alias_factory_subclass_from_arg(FrameComputer, computer)
            if not isinstance(computer, STFTFrameComputer):
                raise ValueError("frontend requires an STFT computer")
        self._computer = computer
        self.dtype = _dtype(dtype)
        device = resolve_device(device if device is not None else computer._device)
        self.frame_length = computer.frame_length
        self.frame_shift = computer.frame_shift
        self.dft_size = computer.dft_size
        self.num_coeffs = computer.num_coeffs
        self.use_log = computer._log
        self.use_power = computer._power
        self.include_energy = computer.includes_energy
        self.pad_left = computer._pad_left

        def tensor(arr):
            return torch.tensor(arr, dtype=self.dtype, device=device)

        C, S = _dft_matrices(self.frame_length, self.dft_size)
        self.window = torch.nn.Parameter(tensor(computer._window))
        self.weights = torch.nn.Parameter(tensor(computer._weights))
        self.register_buffer("dft_cos", tensor(C))
        self.register_buffer("dft_sin", tensor(S))

    def apply_frames(self, frames):
        """Features for pre-assembled raw frames ``(..., frame_length)``."""
        with ieee_float32():
            windowed = frames * self.window
            re = torch.matmul(windowed, self.dft_cos)
            im = torch.matmul(windowed, self.dft_sin)
            power = re * re + im * im
            spec = power if self.use_power else _safe_sqrt(power)
            feats = torch.matmul(spec, self.weights)
        if self.use_log:
            feats = _floor_log(feats)
        if self.include_energy:
            energy = torch.sum(frames * frames, dim=-1) / self.frame_length
            if not self.use_power:
                energy = _safe_sqrt(energy)
            if self.use_log:
                energy = _floor_log(energy)
            feats = torch.cat([energy[..., None], feats], dim=-1)
        return feats

    def forward(self, signals, lengths=None, max_frames: Optional[int] = None):
        """Features for a batch of padded signals ``(batch, max_len)``.

        Returns ``(batch, max_frames, num_coeffs)``; rows past a signal's
        true frame count are reflected garbage the caller masks.
        """
        signals = torch.as_tensor(signals).to(device=self.window.device, dtype=self.dtype)
        batch, max_len = signals.shape
        if lengths is None:
            lengths = torch.full((batch,), max_len, device=signals.device)
        else:
            lengths = torch.as_tensor(lengths).to(signals.device)
        if max_frames is None:
            max_frames = _framing.frame_count_np(
                max_len, self.frame_length, self.frame_shift
            )
        padded = _framing.pad_signal(
            signals, lengths, self.frame_length, self.frame_shift, self.pad_left
        )
        frames = _framing.frame_padded(
            padded, max_frames, self.frame_length, self.frame_shift
        )
        return self.apply_frames(frames)

    def frame_counts(self, lengths):
        """Valid frame counts for true signal ``lengths``."""
        return _framing.frame_count(
            torch.as_tensor(lengths), self.frame_length, self.frame_shift
        )

    def export_computer(self, params: Optional[Mapping] = None) -> STFTFrameComputer:
        """Bake the trained parameters (or ``params``: ``window`` and
        ``weights``) into a fresh computer.

        Closes the train->serve loop: the returned
        :class:`~speech_tpu_torch.compute.STFTFrameComputer` carries the
        learned analysis ``window`` and half-spectrum filter ``weights``,
        and every consumer of a computer (``compute_batch``, the streaming
        classes, :class:`~speech_tpu_torch.parallel.ShardedExtractor`)
        runs the trained frontend unchanged, including the exact digit
        tiers, which derive their digit planes from the new weights when
        the new computer first builds its device parameters.  The
        original computer is left as it was.
        """
        if params is None:
            params = {"window": self.window, "weights": self.weights}

        def host(v):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
            return np.asarray(v, dtype=np.float64)

        window, weights = host(params["window"]), host(params["weights"])
        c = self._computer
        if window.shape != c._window.shape:
            raise ValueError(f"window shape {window.shape} != {c._window.shape}")
        if weights.shape != c._weights.shape:
            raise ValueError(
                f"weights shape {weights.shape} != {c._weights.shape}"
            )
        # leave the device parameters (built for the OLD window and
        # weights) out of the copy: the new computer builds its own
        saved = c._params
        c._params = None
        try:
            out = copy.deepcopy(c)
        finally:
            c._params = saved
        out._window = window
        out._weights = weights
        out._dft_cos, out._dft_sin = _stft.windowed_dft_matrices(window, out._dft_size)
        # fresh streaming state
        out._tail = np.zeros(0, dtype=np.float64)
        out._skip = 0
        out._first_frame = True
        out._started = False
        return out


def frame_count_np_int(sig_len: int, shift: int) -> int:
    """Centered frame count at pure pooling stride (window-free)."""
    return (sig_len + shift // 2) // shift


def _same_conv(x, taps):
    """Stride-1 correlation of ``x (B, 1, T)`` with ``taps (C, 1, W)`` with
    XLA's ``"SAME"`` padding: ``(W - 1) // 2`` zeros before, the rest
    after."""
    W = taps.shape[-1]
    lo = (W - 1) // 2
    with ieee_float32():
        return TF.conv1d(TF.pad(x, (lo, W - 1 - lo)), taps)


def _pooled_windows(energy, max_frames: int, shift: int, pool_size: int):
    """Pooling windows as a strided view.

    ``energy`` is ``(B, F, T)``; returns ``(B, F, max_frames, pool_size)``
    where window position ``p`` of frame ``k`` reads sample ``k * shift +
    p - pool_size // 2`` (zero past either edge).
    """
    pad = pool_size // 2
    need = (max_frames - 1) * shift + pool_size
    right = pad + max(0, need - (energy.shape[-1] + 2 * pad))
    padded = TF.pad(energy, (pad, right))
    return padded.unfold(-1, pool_size, shift)[:, :, :max_frames]


def _pooled_frame_counts(lengths, shift: int):
    return torch.div(torch.as_tensor(lengths) + shift // 2, shift, rounding_mode="floor")


class GaborFrontend(_Frontend):
    """LEAF-style learnable Gabor filterbank frontend.

    The counterpart of :class:`speech_tpu.nn.GaborFrontend`: a time-domain
    complex Gabor correlation, squared modulus, then per-channel Gaussian
    lowpass pooling at the frame shift (Zeghidour et al. 2021).  Parameters:
    per-filter center frequency ``eta`` (angular) and envelope width through
    ``log_sigma`` (samples), seeded from a
    :class:`~speech_tpu_torch.filters.GaborFilterBank` layout, and the
    per-channel pooling width through ``log_pool_sigma``.  Buffers ``t`` and
    ``pool_t`` hold the tap offsets.

    Filters materialize inside ``forward`` from ``(eta, log_sigma)``, so
    gradients move the filters' centers and bandwidths, not their taps.
    Compose with :class:`PCEN` (``use_log=False``) for the full LEAF recipe.
    """

    def __init__(
        self,
        bank=None,
        frame_shift_ms: float = 10.0,
        filter_size: Optional[int] = None,
        pool_size: Optional[int] = None,
        use_log: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        from .filters import GaborFilterBank, LinearFilterBank

        if bank is None:
            bank = GaborFilterBank("mel")
        elif not isinstance(bank, LinearFilterBank):
            bank = alias_factory_subclass_from_arg(LinearFilterBank, bank)
        if not isinstance(bank, GaborFilterBank):
            raise ValueError(
                "GaborFrontend seeds from a GaborFilterBank layout; got "
                f"{type(bank).__name__}"
            )
        eta0 = np.asarray(bank._centers_ang, np.float64)
        sigma0 = np.asarray(bank._stds, np.float64)
        self.num_filts = bank.num_filts
        self.sampling_rate = float(bank.sampling_rate)
        self.frame_shift = max(1, int(0.001 * frame_shift_ms * self.sampling_rate))
        if filter_size is None:
            # wide enough for the widest envelope at init (3 sigma each
            # side), in the ballpark of LEAF's 401 taps at 16 kHz
            filter_size = 2 * int(np.ceil(3 * sigma0.max())) + 1
            filter_size = min(filter_size, 2 * self.frame_shift * 4 + 1)
        if pool_size is None:
            pool_size = 2 * self.frame_shift + 1
        if filter_size % 2 == 0 or pool_size % 2 == 0:
            raise ValueError("filter_size and pool_size must be odd")
        self.filter_size = int(filter_size)
        self.pool_size = int(pool_size)
        self.use_log = bool(use_log)
        self.dtype = _dtype(dtype)
        device = resolve_device(device)

        def tensor(arr):
            return torch.tensor(arr, dtype=self.dtype, device=device)

        half, phalf = self.filter_size // 2, self.pool_size // 2
        self.eta = torch.nn.Parameter(tensor(eta0))
        self.log_sigma = torch.nn.Parameter(tensor(np.log(sigma0)))
        # LEAF initializes the pooling Gaussian at 0.4 * hop
        self.log_pool_sigma = torch.nn.Parameter(
            tensor(np.full(self.num_filts, float(np.log(0.4 * self.frame_shift))))
        )
        self.register_buffer("t", tensor(np.arange(-half, half + 1)))
        self.register_buffer("pool_t", tensor(np.arange(-phalf, phalf + 1)))

    def filters(self):
        """Materialize ``(filter_size, F)`` cosine and sine tap banks.

        Envelopes normalize to unit area so each filter's frequency
        response peaks at ~1 regardless of its width.
        """
        t = self.t[:, None]
        sigma = torch.exp(self.log_sigma)[None, :]
        env = torch.exp(-0.5 * (t / sigma) ** 2)
        env = env / torch.sum(env, dim=0, keepdim=True)
        phase = self.eta[None, :] * t
        return env * torch.cos(phase), env * torch.sin(phase)

    def pool_window(self):
        """Materialize the ``(pool_size, F)`` unit-sum Gaussian pooling."""
        t = self.pool_t[:, None]
        sigma = torch.exp(self.log_pool_sigma)[None, :]
        win = torch.exp(-0.5 * (t / sigma) ** 2)
        return win / torch.sum(win, dim=0, keepdim=True)

    def frame_counts(self, lengths):
        """Valid frame counts for true signal ``lengths``."""
        return _pooled_frame_counts(lengths, self.frame_shift)

    def forward(self, signals, lengths=None):
        """Features for padded signals ``(batch, max_len)``.

        Returns ``(batch, max_frames, num_filts)`` with frame ``k``
        centered at sample ``k * frame_shift``; rows past a signal's true
        frame count are pooled zeros the caller masks.  Zero-pad
        ``signals`` beyond each true length.
        """
        signals = torch.as_tensor(signals).to(device=self.eta.device, dtype=self.dtype)
        max_frames = frame_count_np_int(signals.shape[-1], self.frame_shift)
        cos_f, sin_f = self.filters()
        # one stride-1 correlation for all 2F tap banks: (B, 1, T) x
        # (2F, 1, W) SAME -> (B, 2F, T) modulation energies
        taps = torch.cat([cos_f.T, sin_f.T], dim=0)[:, None, :]
        resp = _same_conv(signals[:, None, :], taps)
        energy = resp[:, : self.num_filts] ** 2 + resp[:, self.num_filts :] ** 2
        win = self.pool_window()
        strided = _pooled_windows(energy, max_frames, self.frame_shift, self.pool_size)
        with ieee_float32():
            feats = torch.einsum("bfkp,pf->bkf", strided, win)
        if self.use_log:
            feats = _floor_log(feats)
        return feats


class SincFrontend(_Frontend):
    """SincNet-style learnable band-edge frontend (Ravanelli & Bengio 2018).

    The counterpart of :class:`speech_tpu.nn.SincFrontend`: each band-pass
    filter is a Hamming-windowed difference of ideal-lowpass sincs whose two
    edge frequencies are the only parameters (``low_hz``, ``band_hz``,
    constrained positive through ``min_low_hz + |low|`` and ``f1 +
    min_band_hz + |band|``, clipped at Nyquist), seeded equally spaced on a
    perceptual scale.  Buffers ``t`` (tap offsets) and ``window`` (the
    Hamming window).  A stride-1 correlation, squared response, pooling at
    the frame shift (``"avg"`` or ``"max"``), optional log compression.
    """

    def __init__(
        self,
        num_filts: int = 40,
        sampling_rate: float = 16000.0,
        scaling_function="mel",
        frame_shift_ms: float = 10.0,
        filter_size: Optional[int] = None,
        pool_size: Optional[int] = None,
        pooling: str = "avg",
        use_log: bool = True,
        min_low_hz: float = 30.0,
        min_band_hz: float = 50.0,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        from .scales import ScalingFunction

        if num_filts < 1:
            raise ValueError(f"num_filts must be positive, got {num_filts}")
        if pooling not in ("avg", "max"):
            raise ValueError(f"pooling must be 'avg' or 'max', got {pooling}")
        scale = alias_factory_subclass_from_arg(ScalingFunction, scaling_function)
        self.num_filts = int(num_filts)
        self.sampling_rate = float(sampling_rate)
        self.min_low_hz = float(min_low_hz)
        self.min_band_hz = float(min_band_hz)
        nyquist = self.sampling_rate / 2
        # seed: num_filts+1 edges equally spaced on the perceptual scale
        # (the SincNet initialization), leaving headroom for the
        # min_low/min_band floors the forward constraints re-add
        s_lo = scale.hertz_to_scale(self.min_low_hz)
        s_hi = scale.hertz_to_scale(
            max(nyquist - (self.min_low_hz + self.min_band_hz), self.min_low_hz + 1)
        )
        edges = np.asarray(
            [scale.scale_to_hertz(s) for s in np.linspace(s_lo, s_hi, self.num_filts + 1)],
            np.float64,
        )
        self.frame_shift = max(1, int(0.001 * frame_shift_ms * self.sampling_rate))
        if filter_size is None:
            # ~12.5 ms of taps (SincNet's 251 at 16 kHz is ~16 ms)
            filter_size = 2 * int(0.00625 * self.sampling_rate) + 1
        if pool_size is None:
            pool_size = 2 * self.frame_shift + 1
        if filter_size % 2 == 0 or pool_size % 2 == 0:
            raise ValueError("filter_size and pool_size must be odd")
        self.filter_size = int(filter_size)
        self.pool_size = int(pool_size)
        self.pooling = pooling
        self.use_log = bool(use_log)
        self.dtype = _dtype(dtype)
        device = resolve_device(device)

        def tensor(arr):
            return torch.tensor(arr, dtype=self.dtype, device=device)

        half = self.filter_size // 2
        n = np.arange(-half, half + 1, dtype=np.float64)
        self.low_hz = torch.nn.Parameter(
            tensor(np.maximum(edges[:-1] - self.min_low_hz, 1.0))
        )
        self.band_hz = torch.nn.Parameter(
            tensor(np.maximum(np.diff(edges) - self.min_band_hz, 1.0))
        )
        self.register_buffer("t", tensor(n))
        # periodic-style Hamming over the full support (SincNet's window)
        self.register_buffer("window", tensor(0.54 + 0.46 * np.cos(np.pi * n / max(half, 1))))

    def band_edges(self):
        """Constrained ``(f1, f2)`` band edges in Hz, each ``(F,)``."""
        f1 = self.min_low_hz + torch.abs(self.low_hz)
        f2 = torch.clamp(
            f1 + self.min_band_hz + torch.abs(self.band_hz), max=self.sampling_rate / 2
        )
        return f1, f2

    def filters(self):
        """Materialize the ``(filter_size, F)`` windowed-sinc tap bank."""
        f1, f2 = self.band_edges()
        t = self.t[:, None]
        g1 = 2 * (f1 / self.sampling_rate)[None, :]
        g2 = 2 * (f2 / self.sampling_rate)[None, :]
        taps = g2 * torch.sinc(g2 * t) - g1 * torch.sinc(g1 * t)
        return taps * self.window[:, None]

    def frame_counts(self, lengths):
        """Valid frame counts for true signal ``lengths``."""
        return _pooled_frame_counts(lengths, self.frame_shift)

    def forward(self, signals, lengths=None):
        """Features for padded signals ``(batch, max_len)``.

        Returns ``(batch, max_frames, num_filts)`` with frame ``k``
        centered at sample ``k * frame_shift``; rows past a signal's true
        frame count pool zeros the caller masks.  Zero-pad ``signals``
        beyond each true length.
        """
        signals = torch.as_tensor(signals).to(device=self.low_hz.device, dtype=self.dtype)
        max_frames = frame_count_np_int(signals.shape[-1], self.frame_shift)
        taps = self.filters()  # (W, F)
        resp = _same_conv(signals[:, None, :], taps.T[:, None, :])  # (B, F, T)
        windows = _pooled_windows(resp * resp, max_frames, self.frame_shift, self.pool_size)
        if self.pooling == "max":
            feats = torch.amax(windows, dim=-1).transpose(1, 2)
        else:
            feats = torch.mean(windows, dim=-1).transpose(1, 2)
        if self.use_log:
            feats = _floor_log(feats)
        return feats


class FeatureFrontend(_Frontend):
    """Identity frontend over PRECOMPUTED features.

    The counterpart of :class:`speech_tpu.nn.FeatureFrontend`: ``forward``
    takes a padded ``(batch, T, feature_dim)`` feature array and per-row
    FRAME counts, subtracts ``mean`` and divides by ``std`` where given
    (buffers), and zeroes rows past each count so batch padding cannot leak
    into the downstream heads.  ``frame_counts`` is the identity.  There are
    no parameters.
    """

    def __init__(self, feature_dim: int, mean=None, std=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        if feature_dim < 1:
            raise ValueError(f"feature_dim must be >= 1: {feature_dim}")
        self.num_coeffs = int(feature_dim)
        self.dtype = _dtype(dtype)
        device = resolve_device(device)
        for name, arr in (("mean", mean), ("std", std)):
            if arr is None:
                self.register_buffer(name, None)
                continue
            arr = np.asarray(arr, np.float64)
            if arr.shape != (self.num_coeffs,):
                raise ValueError(
                    f"{name} must have shape ({self.num_coeffs},), got {arr.shape}"
                )
            self.register_buffer(name, torch.tensor(arr, dtype=self.dtype, device=device))
        self._device = device

    def frame_counts(self, lengths):
        return torch.as_tensor(lengths).to(torch.int32)

    def forward(self, feats, lengths=None):
        feats = torch.as_tensor(feats).to(device=self._device, dtype=self.dtype)
        if self.mean is not None:
            feats = feats - self.mean
        if self.std is not None:
            feats = feats / self.std
        if lengths is not None:
            t = torch.arange(feats.shape[-2], device=feats.device)
            lengths = torch.as_tensor(lengths).to(feats.device)
            mask = t[None, :] < lengths[:, None]
            feats = feats * mask[..., None].to(feats.dtype)
        return feats


class PCEN(_Frontend):
    """Learnable per-channel energy normalization (Wang et al. 2017).

    The trainable form of :func:`speech_tpu_torch.ops.postops.pcen`:
    ``alpha``, ``delta`` and ``power`` are per-channel parameters learned
    through their logs (``log_alpha``, ``log_delta``, ``log_power``), and
    the smoother coefficient optionally through a logit
    (``smooth_logit``, with ``learn_smooth``).  Compose after an
    :class:`STFTFrontend` built with ``use_log=False``: PCEN replaces log
    compression.

    ``out = layer(feats)``, or ``out, state = layer(feats,
    init_state=state, return_state=True)`` when streaming.
    """

    def __init__(
        self,
        num_channels: int,
        smooth: float = 0.025,
        alpha: float = 0.98,
        delta: float = 2.0,
        power: float = 0.5,
        eps: float = 1e-6,
        learn_smooth: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if not 0.0 < smooth <= 1.0:
            raise ValueError(f"Expected smooth in (0, 1], got {smooth}")
        if learn_smooth and smooth >= 1.0:
            # the logit parameterization needs an interior point
            raise ValueError(
                "learn_smooth requires smooth < 1 (the initial logit of "
                "1.0 is infinite)"
            )
        self.num_channels = int(num_channels)
        self._smooth = float(smooth)
        self.eps = float(eps)
        self.learn_smooth = bool(learn_smooth)
        self.dtype = _dtype(dtype)
        device = resolve_device(device)

        def full(v):
            return torch.nn.Parameter(
                torch.full((self.num_channels,), float(v), dtype=self.dtype, device=device)
            )

        self.log_alpha = full(np.log(alpha))
        self.log_delta = full(np.log(delta))
        self.log_power = full(np.log(power))
        if self.learn_smooth:
            self.smooth_logit = full(np.log(self._smooth) - np.log1p(-self._smooth))

    def forward(self, features, init_state=None, time_axis: int = -2,
                return_state: bool = False):
        """PCEN of linear features ``(..., time, num_channels)``."""
        from .ops.postops import pcen

        smooth = torch.sigmoid(self.smooth_logit) if self.learn_smooth else self._smooth
        features = torch.as_tensor(features).to(device=self.log_alpha.device, dtype=self.dtype)
        return pcen(
            features,
            smooth=smooth,
            alpha=torch.exp(self.log_alpha),
            delta=torch.exp(self.log_delta),
            power=torch.exp(self.log_power),
            eps=self.eps,
            init_state=init_state,
            time_axis=time_axis,
            return_state=return_state,
        )
