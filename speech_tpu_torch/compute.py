"""Frame computers: signals -> feature matrices, in PyTorch.

The counterpart of :mod:`speech_tpu.compute` for the STFT filter-bank
computer and the short-integration computer (the latter's device path is
:mod:`speech_tpu_torch.ops.si`).  All filter math is precomputed on the host at construction (see
:mod:`speech_tpu_torch.ops.stft`); on the device a batch goes through
symmetric padding and then either one of the hand-written CUDA kernels of
:mod:`speech_tpu_torch.ops.stft_kernels` or the plain tensor path (framing
-> windowed rDFT as matmuls or ``torch.fft`` -> |.|^p -> matmul against the
folded filter weights -> log).

Streaming (`compute_chunk`/`finalize`) keeps the reference's exact frame
boundary and symmetric-padding semantics: a signal chunked arbitrarily
assembles the same virtual sample stream as `compute_full`.

Entry points run on ``"cuda"`` unless the computer was built with
``device="cpu"``; without a GPU and without a ``device`` they raise.
"""

import abc

from typing import Mapping, Optional, Union

import numpy as np
import torch

from . import config
from .aot import as_cache, using
from .alias import AliasedFactory, alias_factory_subclass_from_arg
from .filters import GammaWindow, HannWindow, LinearFilterBank, WindowFunction
from .ops import framing as _framing
from .ops._device import resolve_device
from .ops import si as _si
from .ops import stft as _stft
from .ops import stft_kernels as _kernels

__all__ = [
    "frame_by_frame_calculation",
    "params_from_jax",
    "resolve_device",
    "FrameComputer",
    "LinearFilterBankFrameComputer",
    "ShortIntegrationFrameComputer",
    "ShortTimeFourierTransformFrameComputer",
    "SIFrameComputer",
    "STFTFrameComputer",
]

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_COMPACT_TORCH = (torch.int16, torch.int8, torch.uint8)
_PRECISIONS = ("highest", "high", "default", "double", "accurate")
_TAIL_KEYS = ("mixed_scale", "mask", "w_hi", "w_lo", "w_nyq")
_SCALAR_KEYS = (
    "dft_cos_scale",
    "dft_sin_scale",
    "i8k_cos_scale",
    "pdk_cos_scale",
    "conv_re_scale",
    "conv_im_scale",
)


def _compact_transfer(dtype) -> bool:
    """Whether an input dtype crosses host->device as it is: small-integer
    PCM (int16/int8/uint8) moves at half (or a quarter of) the float32
    width and is upcast exactly on the device."""
    if isinstance(dtype, torch.dtype):
        return dtype in _COMPACT_TORCH
    dt = np.dtype(dtype)
    return (dt.kind == "i" and dt.itemsize <= 2) or (
        dt.kind == "u" and dt.itemsize == 1
    )


def _to_device(signals, dtype: torch.dtype, device: torch.device):
    """Signals on ``device``: cast to ``dtype`` on the host, except compact
    integer arrays, which move as they are (the caller upcasts them)."""
    if isinstance(signals, torch.Tensor):
        if not _compact_transfer(signals.dtype):
            signals = signals.to(dtype)
        return signals.to(device)
    arr = np.asarray(signals)
    if not _compact_transfer(arr.dtype):
        arr = arr.astype(_NUMPY_DTYPES[dtype], copy=False)
    return torch.tensor(arr, device=device)


def params_from_jax(params: Mapping[str, np.ndarray]) -> dict:
    """The JAX computer's ``params`` (as numpy arrays; ``i8k_offsets`` the
    group tuple; scalars as they are) -> the port's params on the CPU.

    bf16 digit matrices become (exactly equal) float32 and scalar scales
    Python floats.
    """
    out = {}
    for key, value in params.items():
        if key == "i8k_offsets":
            out[key] = tuple(
                (int(s), tuple(int(i) for i in xs), int(off), int(span))
                for s, xs, off, span in value
            )
        elif key in _SCALAR_KEYS:
            out[key] = float(np.asarray(value))
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "V":  # ml_dtypes bfloat16: integer digits
                arr = arr.astype(np.float32)
            out[key] = torch.tensor(arr)
    return out


class FrameComputer(AliasedFactory):
    """Construct features from a signal in fixed-length frames.

    A signal is treated as a (possibly overlapping) time series of frames,
    each transformed into a fixed-length coefficient vector.  Features can be
    computed chunk-by-chunk in a stream (`compute_chunk` then `finalize`) or
    all at once (`compute_full`); the two agree for any chunking
    (reference: compute.py:48-178).
    """

    _aot = None  # optional store of kernel libraries (see enable_aot)

    def enable_aot(self, store) -> None:
        """Take this computer's kernel libraries from a library store.

        ``store`` is a directory path or a
        :class:`speech_tpu_torch.aot.AOTCache`.  Libraries a previous
        process built load from it instead of rebuilding: the cold-start
        answer for the fused-kernel ``compute_batch`` routes.  A library
        this process loaded before the call is not loaded again; the
        store receives a copy of its file at the next launch, so a route
        exercised before the wiring still lands in the store.
        """
        self._aot = as_cache(store)

    @property
    @abc.abstractmethod
    def frame_style(self) -> str:
        """'causal' or 'centered' (reference: compute.py:76-84)."""
        ...

    @property
    @abc.abstractmethod
    def sampling_rate(self) -> float:
        """Samples per second of the target recording."""
        ...

    @property
    @abc.abstractmethod
    def frame_length(self) -> int:
        """Number of samples dictating a feature vector."""
        ...

    @property
    def frame_length_ms(self) -> float:
        """Milliseconds of audio dictating a feature vector."""
        return self.frame_length * 1000 / self.sampling_rate

    @property
    @abc.abstractmethod
    def frame_shift(self) -> int:
        """Samples absorbed between successive frame computations."""
        ...

    @property
    def frame_shift_ms(self) -> float:
        """Milliseconds between successive frame computations."""
        return self.frame_shift * 1000 / self.sampling_rate

    @property
    @abc.abstractmethod
    def num_coeffs(self) -> int:
        """Number of coefficients per frame."""
        ...

    @property
    @abc.abstractmethod
    def started(self) -> bool:
        """Whether a stream is in progress (chunk seen, not finalized)."""
        ...

    @abc.abstractmethod
    def compute_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """Compute some feature frames given the next chunk of audio."""
        ...

    @abc.abstractmethod
    def finalize(self) -> np.ndarray:
        """Conclude a stream, flushing any buffered samples into frames."""
        ...

    def compute_full(self, signal: np.ndarray) -> np.ndarray:
        """Compute an entire signal's feature matrix at once."""
        return frame_by_frame_calculation(self, signal)


class LinearFilterBankFrameComputer(FrameComputer):
    """Frame computers whose features derive from a linear filter bank;
    the energy coefficient, if any, sits at index 0
    (reference: compute.py:181-218)."""

    def __init__(
        self,
        bank: Union[LinearFilterBank, Mapping, str],
        include_energy: bool = False,
    ):
        self._bank = alias_factory_subclass_from_arg(LinearFilterBank, bank)
        self._include_energy = bool(include_energy)

    @property
    def bank(self) -> LinearFilterBank:
        """The filter bank features derive from."""
        return self._bank

    @property
    def includes_energy(self) -> bool:
        """Whether the first coefficient is a frame-energy coefficient."""
        return self._include_energy

    @property
    def num_coeffs(self) -> int:
        return self._bank.num_filts + int(self._include_energy)


class ShortTimeFourierTransformFrameComputer(LinearFilterBankFrameComputer):
    """Features by integrating filtered short-time Fourier transforms.

    The arguments are those of
    :class:`speech_tpu.compute.ShortTimeFourierTransformFrameComputer`,
    plus ``device``.  Precision tiers:

    - 'highest' (default), 'high', 'default': the float tiers.  The plain
      path and the CPU compute all three in IEEE float32.  On a GPU, the
      fused float kernel (``fft_mode="pallas"``) runs the DFT products on
      the TF32 tensor cores: three split passes (about float32 accuracy)
      for 'highest' and 'high', one TF32 pass for 'default' (within the
      reference's 1.5e-2 of its reduced tier).
    - 'double' and 'accurate': the exact digit tiers, float32 only.  On a
      GPU they run the fused int8 kernel when ``dft_size % 4 == 0`` (its
      pair schedule bakes in the tier), otherwise the plain digit path.
      Their params also carry the base-256 layout (``pdk_*``) that
      :func:`~speech_tpu_torch.ops.stft_kernels.stft_feats_double` takes;
      as in the JAX package, no route of the computer runs it.

    ``fft_mode="pallas"`` selects the fused float kernel on the float
    tiers (the name is the JAX package's).
    """

    aliases = {"stft"}

    def __init__(
        self,
        bank: Union[LinearFilterBank, Mapping, str],
        frame_length_ms: Optional[float] = None,
        frame_shift_ms: Optional[float] = 10,
        frame_style: Optional[str] = None,
        include_energy: bool = False,
        pad_to_nearest_power_of_two: bool = True,
        window_function: Optional[Union[WindowFunction, Mapping, str]] = None,
        use_log: bool = True,
        use_power: bool = False,
        kaldi_shift: bool = False,
        dtype: str = "float32",
        fft_mode: Optional[str] = None,
        precision: str = "highest",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if precision not in _PRECISIONS:
            raise ValueError(f"Invalid precision: {precision!r}")
        if fft_mode is not None and fft_mode not in config.VALID_FFT_MODES:
            raise ValueError(f"Invalid fft_mode: {fft_mode!r}")
        self._precision = precision
        bank = alias_factory_subclass_from_arg(LinearFilterBank, bank)
        self._rate = bank.sampling_rate
        self._frame_shift = int(0.001 * frame_shift_ms * self._rate)
        self._log = use_log
        self._power = use_power
        self._real = bank.is_real
        self._kaldi_shift = kaldi_shift
        dtype_name = np.dtype(dtype).name
        if dtype_name not in _TORCH_DTYPES:
            raise ValueError(f"Invalid dtype: {dtype!r}")
        self._dtype = _TORCH_DTYPES[dtype_name]
        if precision in ("double", "accurate") and self._dtype != torch.float32:
            raise ValueError(
                f"precision='{precision}' is a float32 digit-matmul tier; "
                "use dtype='float64' with the default precision instead"
            )
        self._fft_mode = fft_mode
        self._device = device
        if frame_style is None:
            frame_style = "centered" if bank.is_zero_phase else "causal"
        elif frame_style not in ("centered", "causal"):
            raise ValueError('Invalid frame style: "{}"'.format(frame_style))
        self._frame_style = frame_style
        if frame_length_ms is None:
            self._frame_length = max(
                max(right - left for left, right in bank.supports),
                # ensure at least one DFT bin is nonzero per filter
                int(
                    np.ceil(
                        2
                        * self._rate
                        / min(right - left for left, right in bank.supports_hz)
                    )
                ),
            )
        else:
            self._frame_length = int(0.001 * frame_length_ms * bank.sampling_rate)
        if window_function is None:
            window_function = (
                GammaWindow() if frame_style == "causal" else HannWindow()
            )
        else:
            window_function = alias_factory_subclass_from_arg(
                WindowFunction, window_function
            )
        self._window = window_function.get_impulse_response(self._frame_length)
        if pad_to_nearest_power_of_two:
            self._dft_size = int(2 ** np.ceil(np.log2(self._frame_length)))
        else:
            self._dft_size = self._frame_length
        self._weights = _stft.fold_bank_to_weights(bank, self._dft_size, use_power)
        self._dft_cos, self._dft_sin = _stft.windowed_dft_matrices(
            self._window, self._dft_size
        )
        self._pad_left = _framing.left_pad_width(
            frame_style, self._frame_length, self._frame_shift, kaldi_shift
        )
        # first centered frame consumes fewer fresh samples; its left side is
        # reflected (reference: compute.py:469-517)
        if frame_style == "centered":
            if kaldi_shift:
                self._first_frame_len = (
                    self._frame_length + 1
                ) // 2 + self._frame_shift // 2
            else:
                self._first_frame_len = self._frame_length // 2 + 1
        else:
            self._first_frame_len = self._frame_length
        # streaming state
        self._tail = np.zeros(0, dtype=np.float64)
        self._skip = 0
        self._first_frame = True
        self._started = False
        self._chunk_dtype = np.float64
        self._params = None
        super().__init__(bank, include_energy=include_energy)

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def frame_style(self) -> str:
        return self._frame_style

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def frame_length(self) -> int:
        return self._frame_length

    @property
    def frame_shift(self) -> int:
        return self._frame_shift

    @property
    def started(self) -> bool:
        return self._started

    @property
    def kaldi_shift(self) -> bool:
        return self._kaldi_shift

    @property
    def dft_size(self) -> int:
        return self._dft_size

    @property
    def device(self) -> torch.device:
        """Where this computer runs (``cuda`` unless given)."""
        return resolve_device(self._device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    @property
    def params(self) -> dict:
        """Device tensors (and the int8 group schedule and scalar scales)
        the feature pipeline consumes, built on first use."""
        if self._params is None:
            self._params = self.build_params(self.device)
        return self._params

    def _digit_tier(self) -> bool:
        return self._precision in ("double", "accurate")

    def param_keys(self) -> set:
        """The keys of :attr:`params` for this configuration."""
        keys = {"window", "weights", "dft_cos", "dft_sin"}
        if self._digit_tier():
            keys |= {"dft_group_mats", "dft_group_weights", "weights_lo"}
            keys |= {"dft_cos_scale", "dft_sin_scale"}
            if self._dft_size % 4 == 0:
                keys |= {p + k for p in ("i8k_", "pdk_") for k in _TAIL_KEYS}
                keys |= {"i8k_gmats", "i8k_cos_scale", "i8k_offsets"}
                keys |= {"pdk_mats", "pdk_cos_scale"}
        return keys

    def build_params(self, device) -> dict:
        """The host build of :attr:`params`, on ``device``."""
        np_dtype = _NUMPY_DTYPES[self._dtype]

        def tensor(arr, dt=np.float32):
            return torch.tensor(np.asarray(arr, dtype=dt), device=device)

        params = {
            "window": tensor(self._window, np_dtype),
            "weights": tensor(self._weights, np_dtype),
            "dft_cos": tensor(self._dft_cos, np_dtype),
            "dft_sin": tensor(self._dft_sin, np_dtype),
        }
        if self._digit_tier():
            mats, gw, cs, ss, _ = _stft.digit_group_matrices(
                self._dft_cos, self._dft_sin
            )
            params["dft_group_mats"] = tensor(mats)  # integer digits: exact
            params["dft_group_weights"] = tensor(gw)
            params["dft_cos_scale"] = float(cs)
            params["dft_sin_scale"] = float(ss)
            if self._dft_size % 4 == 0:
                # the base-256 digit kernel's layout (stft_feats_double)
                pdk = _stft.digit_kernel_matrices(
                    self._dft_cos,
                    self._dft_sin,
                    self._weights,
                    ndig=(
                        _stft._PAK_M_DIGITS
                        if self._precision == "accurate"
                        else _stft._PDK_M_DIGITS
                    ),
                )
                params["pdk_cos_scale"] = float(pdk.pop("cos_scale"))
                for name, arr in pdk.items():
                    params["pdk_" + name] = tensor(arr)
                i8 = _stft.int8_kernel_matrices(
                    self._dft_cos,
                    self._dft_sin,
                    self._weights,
                    cutoff=(
                        _stft._I8_ACC_CUTOFF
                        if self._precision == "accurate"
                        else _stft._I8_CUTOFF
                    ),
                )
                params["i8k_cos_scale"] = float(i8.pop("cos_scale"))
                params["i8k_offsets"] = i8.pop("offsets")
                params["i8k_gmats"] = tensor(i8.pop("gmats"), np.int8)
                for name, arr in i8.items():
                    params["i8k_" + name] = tensor(arr)
            params["weights_lo"] = tensor(
                self._weights - self._weights.astype(np.float32).astype(np.float64)
            )
        return params

    def load_params(self, params: Mapping) -> None:
        """Use ``params`` (for example :func:`params_from_jax` of the JAX
        computer's) in place of the host build, moved to this computer's
        device."""
        missing = self.param_keys() - set(params)
        if missing:
            raise ValueError(f"params lack {sorted(missing)}")
        device = self.device
        loaded = {}
        for key in self.param_keys():
            value = params[key]
            if isinstance(value, torch.Tensor):
                if key in ("window", "weights", "dft_cos", "dft_sin"):
                    value = value.to(device=device, dtype=self._dtype)
                else:
                    value = value.to(device)
            loaded[key] = value
        self._params = loaded

    @property
    def _static_spec(self) -> dict:
        return dict(
            dft_size=self._dft_size,
            use_log=self._log,
            use_power=self._power,
            include_energy=self._include_energy,
            log_floor=config.LOG_FLOOR_VALUE,
            fft_mode=self._fft_mode,
            precision=self._precision,
        )

    # ------------------------------------------------------------------
    # device path
    # ------------------------------------------------------------------

    def _use_kernel(self, device: torch.device) -> Optional[str]:
        """Which fused kernel a batch on ``device`` runs, or None for the
        plain tensor path: 'int8' for the digit tiers ('auto' selects it
        on a GPU; it needs ``dft_size % 4 == 0``), 'rows' for
        ``fft_mode='pallas'`` on the float tiers, and 'frames' (the
        framed twin) where the frame shift is not a multiple of 8, as the
        JAX package routes it.  On the CPU the kernels' plain versions run
        where the JAX package would run its kernels in interpret mode."""
        mode = self._fft_mode or config.FFT_MODE
        if self._digit_tier():
            if self._dft_size % 4:
                return None
            if mode == "pallas" or (mode == "auto" and device.type == "cuda"):
                return "int8"
            return None
        if mode != "pallas":
            return None
        return "frames" if self._frame_shift % 8 else "rows"

    def _padded_feats(self, padded, max_frames: int):
        """Features of symmetrically padded rows ``(batch, N)``."""
        route = self._use_kernel(padded.device)
        params = self.params
        if route is None:
            frames = _framing.frame_padded(
                padded, max_frames, self._frame_length, self._frame_shift
            )
            return _stft.stft_feats_from_frames(frames, params, **self._static_spec)
        with using(self._aot):
            return self._kernel_feats(route, padded, params, max_frames)

    def _kernel_feats(self, route: str, padded, params, max_frames: int):
        """:meth:`_padded_feats` through the kernel of ``route``."""
        spec = dict(
            use_log=self._log,
            use_power=self._power,
            include_energy=self._include_energy,
            log_floor=config.LOG_FLOOR_VALUE,
        )
        if route == "int8":
            return _kernels.stft_feats_int8(
                padded,
                params,
                num_frames=max_frames,
                frame_length=self._frame_length,
                frame_shift=self._frame_shift,
                dft_size=self._dft_size,
                **spec,
            )
        if route == "rows":
            return _kernels.stft_feats_rows(
                padded,
                params,
                num_frames=max_frames,
                frame_length=self._frame_length,
                frame_shift=self._frame_shift,
                precision=self._precision,
                **spec,
            )
        frames = _framing.frame_padded(
            padded.to(torch.float32),
            max_frames,
            self._frame_length,
            self._frame_shift,
        ).contiguous()
        return _kernels.stft_feats_frames(
            frames, params, precision=self._precision, **spec
        )

    # ------------------------------------------------------------------
    # batch API
    # ------------------------------------------------------------------

    def compute_full(self, signal: np.ndarray) -> np.ndarray:
        """Compute a full signal's feature matrix in one device call:
        ``(len + shift//2) // shift`` frames, symmetric padding on both
        edges (reference: compute.py:574-607)."""
        if self.started:
            raise ValueError("Already started computing frames")
        resolve_device(self._device)  # no GPU and no device: raise first
        signal = np.asarray(signal)
        ret_dtype = signal.dtype
        sig_len = signal.shape[0]
        num_frames = _framing.frame_count_np(
            sig_len, self._frame_length, self._frame_shift
        )
        if num_frames == 0:
            return np.empty((0, self.num_coeffs), dtype=ret_dtype)
        feats, _ = self.compute_batch(signal[None], np.array([sig_len]))
        return feats[0, :num_frames].cpu().numpy().astype(ret_dtype, copy=False)

    def compute_batch(self, signals, lengths):
        """Batched computation over padded signals (the production hot path).

        Parameters
        ----------
        signals
            ``(batch, max_len)`` array or tensor (padding values are
            ignored).  int16/int8/uint8 move to the device as they are and
            are upcast there.
        lengths
            ``(batch,)`` true lengths, on the host (numpy or a list) or as
            a tensor.

        Returns
        -------
        feats, frame_counts
            ``(batch, max_frames, num_coeffs)`` features and ``(batch,)``
            int32 valid frame counts, both tensors on the computer's
            device; rows at or beyond a signal's count are garbage and must
            be masked by the caller.
        """
        device = self.device
        signals = _to_device(signals, self._dtype, device)
        if signals.dim() != 2:
            raise ValueError(
                f"signals must be (batch, max_len), got {tuple(signals.shape)}"
            )
        signals = signals.to(self._dtype)
        batch, max_len = signals.shape
        max_frames = _framing.frame_count_np(
            max_len, self._frame_length, self._frame_shift
        )
        if not isinstance(lengths, torch.Tensor):
            lengths = np.asarray(lengths)
            if (
                max_len >= self._frame_length
                and lengths.shape == (batch,)
                and (lengths == max_len).all()
            ):
                # host-known all-full lengths: fully static padding
                padded = _framing.pad_signal_full(
                    signals, self._frame_length, self._pad_left
                )
                feats = self._padded_feats(padded, max_frames)
                counts = torch.full(
                    (batch,), max_frames, dtype=torch.int32, device=device
                )
                return feats, counts
            if ((lengths < 0) | (lengths > max_len)).any():
                raise ValueError(f"lengths must lie in [0, {max_len}]")
            lengths = torch.tensor(lengths, dtype=torch.int64, device=device)
        else:
            lengths = lengths.to(device=device, dtype=torch.int64)
        padded = _framing.pad_signal(
            signals, lengths, self._frame_length, self._frame_shift, self._pad_left
        )
        feats = self._padded_feats(padded, max_frames)
        counts = _framing.frame_count(lengths, self._frame_length, self._frame_shift)
        return feats, counts

    # ------------------------------------------------------------------
    # streaming API
    # ------------------------------------------------------------------
    #
    # Equivalent formulation of the reference's ring-buffer streaming
    # (reference: compute.py:462-572): once the first centered frame's
    # samples are available, its reflected left side is *prepended to the
    # stream*, after which streaming is a plain causal sliding window over
    # the virtual stream [reflection | signal].  State is the stream's
    # unconsumed tail (or a count of future samples to skip when
    # frame_shift > frame_length).

    def _feats_for_frames(self, frames: np.ndarray) -> np.ndarray:
        """Run host-assembled frames through the plain tensor path."""
        if frames.shape[0] == 0:
            return np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
        x = _to_device(frames, self._dtype, self.device)
        feats = _stft.stft_feats_from_frames(x, self.params, **self._static_spec)
        return feats.cpu().numpy().astype(self._chunk_dtype, copy=False)

    def compute_chunk(self, chunk: np.ndarray) -> np.ndarray:
        resolve_device(self._device)  # no GPU and no device: raise first
        chunk = np.asarray(chunk)
        self._chunk_dtype = chunk.dtype
        self._started = True
        chunk = chunk.astype(np.float64, copy=False)
        frame_length = self._frame_length
        frame_shift = self._frame_shift
        if self._first_frame and self._frame_style == "centered":
            stream = np.concatenate([self._tail, chunk])
            if len(stream) < self._first_frame_len:
                self._tail = stream
                return np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
            head = stream[: self._first_frame_len]
            prefix = np.pad(head, (self._pad_left, 0), "symmetric")
            stream = np.concatenate([prefix, stream[self._first_frame_len :]])
        else:
            if self._skip:
                consumed = min(self._skip, len(chunk))
                self._skip -= consumed
                chunk = chunk[consumed:]
            stream = np.concatenate([self._tail, chunk])
        num_frames = max(0, (len(stream) - frame_length) // frame_shift + 1)
        if num_frames:
            starts = np.arange(num_frames) * frame_shift
            frames = stream[starts[:, None] + np.arange(frame_length)[None, :]]
            feats = self._feats_for_frames(frames)
            self._first_frame = False
        else:
            feats = np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
        rem = len(stream) - num_frames * frame_shift
        if rem > 0:
            self._tail = stream[len(stream) - rem :]
            self._skip = 0
        else:
            self._tail = np.zeros(0, dtype=np.float64)
            self._skip = -rem
        return feats

    def finalize(self) -> np.ndarray:
        frame_length = self._frame_length
        frame_shift = self._frame_shift
        buf_len = len(self._tail) - self._skip
        if self._frame_style == "causal":
            pad_left = 0
        else:
            pad_left = self._pad_left
        num_frames = buf_len + frame_shift // 2
        if not self._first_frame:
            num_frames -= pad_left
            pad_left = 0
        num_frames //= frame_shift
        if num_frames >= 1:
            pad_right = (num_frames - 1) * frame_shift + frame_length - buf_len
            pad_right -= pad_left
            stream = np.pad(self._tail, (pad_left, pad_right), "symmetric")
            starts = np.arange(num_frames) * frame_shift
            frames = stream[starts[:, None] + np.arange(frame_length)[None, :]]
            feats = self._feats_for_frames(frames)
        else:
            feats = np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
        self._tail = np.zeros(0, dtype=np.float64)
        self._skip = 0
        self._first_frame = True
        self._started = False
        return feats


STFTFrameComputer = ShortTimeFourierTransformFrameComputer


class ShortIntegrationFrameComputer(LinearFilterBankFrameComputer):
    """Features by windowed short-time integration of filtered signals.

    Each filter is convolved with the whole signal, a pointwise modulus or
    power squashes the band to baseband, and a window of ``2*frame_shift``
    samples integrates it per frame (reference: compute.py:613-999); the
    closed form is in :mod:`speech_tpu_torch.ops.si`.

    The arguments are those of
    :class:`speech_tpu.compute.ShortIntegrationFrameComputer`, plus
    ``device``.  ``conv_mode``: 'matmul' (banded-Toeplitz block products,
    :func:`~speech_tpu_torch.ops.si.toeplitz_conv_blocks`), 'fft' (real-FFT
    products, overlap-save in blocks for long signals), 'direct'
    (``conv1d``) or 'auto' ('matmul' up to supports of ``16 *
    CONV_BLOCK`` samples, then 'fft').  Precision tiers: 'highest'
    (default), 'high' and 'default' all compute in IEEE float32 (or
    float64), on the card as on the CPU; 'double' and 'accurate' are the
    exact digit tiers of the convolution (float32 only; they force
    'matmul'), within 1e-5 of float64 on speech.  The digit tiers' band
    planes scale with the support squared, so banks whose planes would
    pass :data:`speech_tpu_torch.config.SI_DIGIT_PARAM_BYTE_LIMIT` are
    refused at construction.
    """

    aliases = {"si"}

    def __init__(
        self,
        bank: Union[LinearFilterBank, Mapping, str],
        frame_shift_ms: float = 10,
        frame_style: Optional[str] = None,
        include_energy: bool = False,
        pad_to_nearest_power_of_two: bool = True,
        window_function: Optional[Union[WindowFunction, Mapping, str]] = None,
        use_power: bool = False,
        use_log: bool = True,
        dtype: str = "float32",
        conv_mode: str = "auto",
        precision: str = "highest",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if conv_mode not in ("auto", "fft", "direct", "matmul"):
            raise ValueError(f"Invalid conv_mode: {conv_mode}")
        if precision not in _PRECISIONS:
            raise ValueError(f"Invalid SI precision: {precision!r}")
        dtype_name = np.dtype(dtype).name
        if dtype_name not in _TORCH_DTYPES:
            raise ValueError(f"Invalid dtype: {dtype!r}")
        self._dtype = _TORCH_DTYPES[dtype_name]
        if precision in ("double", "accurate"):
            if self._dtype != torch.float32:
                raise ValueError(
                    f"precision='{precision}' is a float32 digit-matmul "
                    "tier; use dtype='float64' with the default precision "
                    "instead"
                )
            if conv_mode == "fft" or conv_mode == "direct":
                raise ValueError(
                    f"precision='{precision}' requires the matmul "
                    "convolution"
                )
            conv_mode = "matmul"
        self._precision = precision
        self._conv_mode = conv_mode
        self._device = device
        bank = alias_factory_subclass_from_arg(LinearFilterBank, bank)
        self._rate = bank.sampling_rate
        self._frame_shift = int(0.001 * frame_shift_ms * self._rate)
        self._log = bool(use_log)
        self._power = bool(use_power)
        if frame_style is None:
            frame_style = "centered" if bank.is_zero_phase else "causal"
        elif frame_style not in ("centered", "causal"):
            raise ValueError('Invalid frame style: "{}"'.format(frame_style))
        self._frame_style = frame_style
        if window_function is None:
            window_function = (
                GammaWindow() if frame_style == "causal" else HannWindow()
            )
        else:
            window_function = alias_factory_subclass_from_arg(
                WindowFunction, window_function
            )
        window = window_function.get_impulse_response(2 * self._frame_shift)
        self._kernel = _si.build_si_kernel(
            bank, self._frame_shift, frame_style, window, include_energy
        )
        if precision in ("double", "accurate"):
            # the digit tiers' band planes scale with the squared support:
            # refuse an fbank-class bank here, with guidance, rather than
            # run out of device memory later
            T = self._kernel["max_support"]
            V = _si.CONV_BLOCK
            Kb = (-(-(T - 1) // V) if T > 1 else 0) + 1
            ndig = _stft._SAK_M_DIGITS if precision == "accurate" else _stft._M_DIGITS
            parts = 1 if self._kernel["is_real"] else 2
            est = ndig * parts * Kb * bank.num_filts * V * V * 4
            limit = config.SI_DIGIT_PARAM_BYTE_LIMIT
            if limit and est > limit:
                raise ValueError(
                    f"SI precision={precision!r} would build "
                    f"~{est / 2**30:.1f} GiB of digit parameter planes "
                    f"(max_support={T} taps, {bank.num_filts} filters, "
                    f"{ndig} digit planes x {parts} part(s)), above "
                    f"config.SI_DIGIT_PARAM_BYTE_LIMIT="
                    f"{limit / 2**30:.1f} GiB.  The digit tiers are "
                    "designed for gammatone/gabor-class supports "
                    "(hundreds of taps); for banks with very long "
                    "supports use precision='highest' (optionally "
                    "conv_mode='fft'), or raise the limit if the device "
                    "really has the memory."
                )
        # pad_to_nearest_power_of_two sizes only the reference's internal
        # block DFT, not its output; the FFT sizes here are independent
        # streaming state: raw samples seen and frames already emitted; the
        # float64 host history holds x from global index _hist_start
        self._seen = 0
        self._frames_done = 0
        self._hist = np.zeros(0, dtype=np.float64)
        self._hist_start = 0
        self._started = False
        self._chunk_dtype = np.float64
        self._params = None
        self._conv_block_params = None
        super().__init__(bank, include_energy=include_energy)

    # ------------------------------------------------------------------

    @property
    def frame_style(self) -> str:
        return self._frame_style

    @property
    def sampling_rate(self) -> float:
        return self._rate

    @property
    def frame_length(self) -> int:
        return self._kernel["frame_length"]

    @property
    def frame_shift(self) -> int:
        return self._frame_shift

    @property
    def started(self) -> bool:
        return self._started

    @property
    def max_support(self) -> int:
        """Length all filters are FIR-clamped to."""
        return self._kernel["max_support"]

    @property
    def device(self) -> torch.device:
        """Where this computer runs (``cuda`` unless given)."""
        return resolve_device(self._device)

    @property
    def _shift_eff(self) -> int:
        return self._kernel["shift_eff"]

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    @property
    def params(self) -> dict:
        """Device tensors of the pipeline: ``firs_re`` (and ``firs_im`` for
        complex banks; the convolutions only need the real products of the
        two parts) and the integration ``window``, built on first use."""
        if self._params is None:
            firs = self._kernel["firs"]
            np_dtype = _NUMPY_DTYPES[self._dtype]
            params = {
                "firs_re": np.asarray(firs.real, np_dtype),
                "window": np.asarray(self._kernel["window"], np_dtype),
            }
            if not self._kernel["is_real"]:
                params["firs_im"] = np.asarray(firs.imag, np_dtype)
            self._params = {
                k: torch.tensor(v, device=self.device) for k, v in params.items()
            }
        return self._params

    def _resolved_conv_mode(self) -> str:
        if self._conv_mode != "auto":
            return self._conv_mode
        T = self._kernel["max_support"]
        return "matmul" if T <= 16 * _si.CONV_BLOCK else "fft"

    def param_keys(self) -> set:
        """The keys of the params the pipeline takes in this configuration
        (the band matrices where it convolves by ``matmul``)."""
        keys = {"firs_re", "window"}
        parts = ["conv_re"]
        if not self._kernel["is_real"]:
            keys.add("firs_im")
            parts.append("conv_im")
        if self._resolved_conv_mode() == "matmul":
            suffixes = (
                ("_digits", "_scale") if self._precision in ("double", "accurate")
                else ("_blocks",)
            )
            keys |= {p + s for p in parts for s in suffixes}
        return keys

    def _build_conv_block_params(self) -> dict:
        firs = self._kernel["firs"]
        parts = [("conv_re", np.ascontiguousarray(firs.real))]
        if not self._kernel["is_real"]:
            parts.append(("conv_im", np.ascontiguousarray(firs.imag)))
        device = self.device
        blocks = {}
        for name, part in parts:
            band = _si.toeplitz_conv_blocks(part)
            if self._precision in ("double", "accurate"):
                if self._precision == "accurate":
                    planes, scale = _stft.digitize_matrix(
                        band, _stft._SAK_M_DIGITS, _stft._SAK_BASE, margin=True
                    )
                else:
                    planes, scale = _stft.digitize_matrix(band)
                blocks[name + "_digits"] = torch.tensor(planes, device=device)
                blocks[name + "_scale"] = float(scale)
            else:
                blocks[name + "_blocks"] = torch.tensor(
                    band.astype(_NUMPY_DTYPES[self._dtype]), device=device
                )
        return blocks

    def _params_for(self, spec: dict) -> dict:
        """Params for a pipeline spec: ``conv_mode='matmul'`` adds the band
        matrices (the digit tiers: their digit planes), built once."""
        params = self.params
        if spec["conv_mode"] != "matmul":
            return params
        if self._conv_block_params is None:
            self._conv_block_params = self._build_conv_block_params()
        return {**params, **self._conv_block_params}

    def load_params(self, params: Mapping) -> None:
        """Use ``params`` (for example :func:`params_from_jax` of the JAX
        computer's ``params`` and band matrices) in place of the host
        build, moved to this computer's device."""
        missing = self.param_keys() - set(params)
        if missing:
            raise ValueError(f"params lack {sorted(missing)}")
        device = self.device
        loaded = {}
        for key in self.param_keys():
            value = params[key]
            if isinstance(value, torch.Tensor):
                if key.endswith("_digits"):
                    value = value.to(device=device, dtype=torch.float32)
                else:
                    value = value.to(device=device, dtype=self._dtype)
            loaded[key] = value
        base = ("firs_re", "firs_im", "window")
        self._params = {k: v for k, v in loaded.items() if k in base}
        blocks = {k: v for k, v in loaded.items() if k not in base}
        self._conv_block_params = blocks or None

    def _spec(self, fft_size: int) -> dict:
        return dict(
            frame_shift=self._frame_shift,
            shift_eff=self._shift_eff,
            max_support=self._kernel["max_support"],
            is_real=self._kernel["is_real"],
            include_energy=self._include_energy,
            use_log=self._log,
            use_power=self._power,
            log_floor=config.LOG_FLOOR_VALUE,
            fft_size=fft_size,
            energy_offset=self._shift_eff - self._kernel["translation"],
            conv_mode=self._resolved_conv_mode(),
            precision=self._precision,
        )

    def _run(self, buf, sig_len, num_frames: int, spec: dict):
        return _si.si_feats_from_signal(
            buf, sig_len, num_frames, self._params_for(spec), **spec
        )

    # ------------------------------------------------------------------
    # batch API
    # ------------------------------------------------------------------

    def compute_full(self, signal: np.ndarray) -> np.ndarray:
        """One-shot SI features; ``(len + shift//2) // shift`` frames.  The
        signal goes into a zero buffer of the next power of two in length,
        as the reference buckets it, so that the FFT size (and with it the
        choice between one FFT and overlap-save) is the reference's."""
        if self._started:
            raise ValueError("Already started computing frames")
        device = self.device
        signal = np.asarray(signal)
        ret_dtype = signal.dtype
        sig_len = signal.shape[0]
        num_frames = int(self.frame_counts_np([sig_len])[0])
        if num_frames == 0:
            return np.empty((0, self.num_coeffs), dtype=ret_dtype)
        shift = self._frame_shift
        bucket_len = _si._next_pow2(max(sig_len, 1))
        max_frames = (bucket_len + shift // 2) // shift
        buf = np.zeros(bucket_len, dtype=_NUMPY_DTYPES[self._dtype])
        buf[:sig_len] = signal
        spec = self._spec(_si._next_pow2(bucket_len + self._kernel["max_support"]))
        feats = self._run(torch.tensor(buf, device=device), sig_len, max_frames, spec)
        return feats[:num_frames].cpu().numpy().astype(ret_dtype, copy=False)

    def frame_counts_np(self, lengths) -> np.ndarray:
        """Valid frame counts per signal length (host math)."""
        shift = self._frame_shift
        T = self._kernel["max_support"]
        lengths = np.asarray(lengths)
        target = (lengths + shift // 2) // shift
        after_pad = (target * shift + T - 1 - self._shift_eff) // shift - 1
        return np.maximum(0, np.minimum(target, after_pad))

    def compute_batch(self, signals, lengths):
        """Batched SI features over padded signals.

        ``signals``: ``(batch, max_len)`` array or tensor (int16/int8/uint8
        move to the device as they are and are upcast there); ``lengths``:
        ``(batch,)``.  Returns ``(feats, frame_counts)``, tensors on the
        computer's device; rows at or past a signal's count are garbage to
        be masked.  Padding values in ``signals`` must be zero (the
        convolution traverses them).
        """
        device = self.device
        signals = _to_device(signals, self._dtype, device)
        if signals.dim() != 2:
            raise ValueError(
                f"signals must be (batch, max_len), got {tuple(signals.shape)}"
            )
        signals = signals.to(self._dtype)
        batch, max_len = signals.shape
        shift = self._frame_shift
        T = self._kernel["max_support"]
        max_frames = (max_len + shift // 2) // shift
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.to(device=device, dtype=torch.int64)
        else:
            lengths = torch.tensor(np.asarray(lengths), dtype=torch.int64, device=device)
        spec = self._spec(_si._next_pow2(max_len + T))
        feats = self._run(signals, lengths, max_frames, spec)
        target = (lengths + shift // 2) // shift
        after_pad = (target * shift + T - 1 - self._shift_eff) // shift - 1
        counts = torch.clamp_min(torch.minimum(target, after_pad), 0)
        return feats, counts.to(torch.int32)

    # ------------------------------------------------------------------
    # streaming API
    # ------------------------------------------------------------------
    #
    # With S raw samples seen, the counted stream holds S - shift_eff
    # samples and frame k is emittable once counted >= (k + 2) * shift
    # (reference: compute.py:774-891).  Frames come from a sliding float64
    # host history of x through the same pipeline as compute_full.

    def _frames_avail(self) -> int:
        counted = self._seen - self._shift_eff
        return max(0, counted // self._frame_shift - 1)

    def compute_chunk(self, chunk: np.ndarray) -> np.ndarray:
        resolve_device(self._device)  # no GPU and no device: raise first
        chunk = np.asarray(chunk)
        if self._started:
            if chunk.dtype != self._chunk_dtype:
                raise ValueError("Chunk does not share a type with previous chunks")
        else:
            if not np.issubdtype(chunk.dtype, np.floating):
                raise ValueError("Chunk must be a float type")
            self._chunk_dtype = chunk.dtype
            self._started = True
        self._hist = np.concatenate([self._hist, chunk.astype(np.float64, copy=False)])
        self._seen += len(chunk)
        return self._emit(self._frames_avail())

    def _emit(self, f1: int) -> np.ndarray:
        f0, shift = self._frames_done, self._frame_shift
        T = self._kernel["max_support"]
        if f1 <= f0:
            return np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
        # the x span frames [f0, f1) need: the taps reach back T - 1
        need_start = f0 * shift + self._shift_eff - (T - 1)
        need_end = f1 * shift + shift - 1 + self._shift_eff  # inclusive
        bucket = _si._next_pow2(need_end - need_start + 1)
        buf = np.zeros(bucket, dtype=_NUMPY_DTYPES[self._dtype])
        lo = max(0, need_start)
        hi = min(self._seen, need_end + 1)
        if hi > lo:
            buf[lo - need_start : hi - need_start] = self._hist[
                lo - self._hist_start : hi - self._hist_start
            ]
        spec = self._spec(_si._next_pow2(bucket + T))
        # shift_eff in the window's coordinates: y_loc[n] is y[f0*shift +
        # n], x_loc[j] is x[need_start + j]
        spec["shift_eff"] = f0 * shift + self._shift_eff - need_start
        spec["energy_offset"] = spec["shift_eff"] - self._kernel["translation"]
        # the buffer is zero past the seen samples and no emitted frame
        # reads past them, so the whole bucket counts as valid
        feats = self._run(torch.tensor(buf, device=self.device), bucket, f1 - f0, spec)
        feats = feats.cpu().numpy().astype(self._chunk_dtype, copy=False)
        self._frames_done = f1
        # keep only the history future frames can still need
        keep_from = max(0, f1 * shift + self._shift_eff - (T - 1))
        if keep_from > self._hist_start:
            self._hist = self._hist[keep_from - self._hist_start :]
            self._hist_start = keep_from
        return feats

    def finalize(self) -> np.ndarray:
        feats = np.empty((0, self.num_coeffs), dtype=self._chunk_dtype)
        if self._started:
            shift = self._frame_shift
            total = max(self._frames_done, int(self.frame_counts_np([self._seen])[0]))
            if total > self._frames_done:
                # the reference zero-pads to ``target*shift + frame_length -
                # 1 - len`` samples and keeps at most ``target`` frames
                # (reference: compute.py:824-846)
                pad = (total + 1) * shift + self._shift_eff - self._seen
                if pad > 0:
                    self._hist = np.concatenate([self._hist, np.zeros(pad)])
                    self._seen += pad
                feats = self._emit(total)
        self._seen = 0
        self._frames_done = 0
        self._hist = np.zeros(0, dtype=np.float64)
        self._hist_start = 0
        self._started = False
        return feats


SIFrameComputer = ShortIntegrationFrameComputer


def frame_by_frame_calculation(
    computer: FrameComputer, signal: np.ndarray, chunk_size: int = 2 ** 10
) -> np.ndarray:
    """Compute an entire signal's features through successive chunk calls
    (reference: compute.py:1002-1039)."""
    if computer.started:
        raise ValueError("Already started computing frames")
    coeffs = []
    while len(signal):
        coeffs.append(computer.compute_chunk(signal[:chunk_size]))
        signal = signal[chunk_size:]
    coeffs.append(computer.finalize())
    return np.concatenate(coeffs)
