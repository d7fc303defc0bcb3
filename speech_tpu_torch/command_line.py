"""Corpus-scale feature extraction CLIs.

The counterpart of :mod:`speech_tpu.command_line` (reference-compatible
commands, reference: src/pydrobert/speech/command_line.py): utterances are
read on host threads, padded into length-sorted buckets, and pushed through
the computer's batched route -- the fused CUDA kernel where the computer
selects one (B2 at 'double'/'accurate', B1/B3 at ``fft_mode="pallas"``) --
via :class:`speech_tpu_torch.parallel.ShardedExtractor`.  Run a command as
``python -m speech_tpu_torch.command_line <command> ...``.

Device: the computer config's own ``"device"`` key; without it the
computer runs on ``"cuda"`` (and raises where there is no GPU).  Where a
:mod:`torch.distributed` process group of more than one process is running,
the extractor splits each batch over a ``"data"`` mesh of the group's
processes and only rank 0 writes outputs.

Determinism contract: with ``--seed``, utterance ``idx`` seeds
``numpy.random.RandomState(seed + idx)`` around its preprocessors, so
results are reproducible for any batch size, worker count, or device count,
and equal to the JAX package's noise draws.

Commands:

- ``signals-to-torch-feat-dir`` -- utt/path map -> one ``(T, F)`` float32
  ``.pt`` file per utterance, with ``--manifest`` resume.
- ``compute-feats-from-kaldi-tables`` -- Kaldi wave table -> Kaldi feature
  table (uses ``pydrobert-kaldi`` when installed, else native table I/O).
- ``torch-feat-dir-to-signals`` -- inverse of the first: feature ``.pt``
  dir -> Griffin-Lim-recovered wav files (no reference counterpart).
- ``copy-feats-tables`` -- Kaldi ``copy-feats``: table -> table copy with
  optional compression / text conversion, or table -> ``.pt`` dir and
  back (no reference counterpart; native table I/O).

The library store flags (``--aot-dir``, ``--aot-max-bytes``,
``--precompile``, ``--aot-prune``) are the JAX package's: the store
(:mod:`speech_tpu_torch.aot`) holds the built kernel libraries, so a run
over a store that ``--precompile`` warmed builds nothing.
"""

import argparse
import json
import threading
import logging
import os
import sys

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import config
from .alias import alias_factory_subclass_from_arg
from .compute import FrameComputer, LinearFilterBankFrameComputer
from .io import read_signal
from .post import PostProcessor
from .pre import PreProcessor

__all__ = [
    "compute_feats_from_kaldi_tables",
    "copy_feats_tables",
    "signals_to_torch_feat_dir",
    "torch_feat_dir_to_signals",
]

logger = logging.getLogger("speech_tpu_torch.command_line")


def _config_type(string):
    """JSON (or YAML, if available) string, file path, or preset name ->
    config object (reference: command_line.py:147-164; presets are this
    package's addition -- see :mod:`speech_tpu_torch.models.presets`)."""
    if string.lstrip().startswith(("{", "[", '"')):
        return json.loads(string)
    if not os.path.exists(string):
        from .models.presets import PRESETS, preset_config

        if string in PRESETS:
            return preset_config(string)
    with open(string) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore

            return yaml.safe_load(text)
        except ImportError:
            try:
                from ruamel.yaml import YAML  # type: ignore

                return YAML(typ="safe").load(text)
            except ImportError:
                raise argparse.ArgumentTypeError(
                    f"'{string}' is not JSON and no YAML parser is installed"
                )


def _nonneg_int_type(string):
    val = int(string)
    if val < 0:
        raise argparse.ArgumentTypeError(f"{string} is not non-negative")
    return val


_FORCE_AS_CHOICES = {
    "table",
    "wav",
    "hdf5",
    "npy",
    "npz",
    "pt",
    "sph",
    "kaldi",
    "file",
    "soundfile",
} | config.SOUNDFILE_SUPPORTED_FILE_TYPES


def _select_channel(signal: np.ndarray, channel: int, utt_id: str) -> np.ndarray:
    if channel == -1 and signal.ndim > 1 and signal.shape[0] > 1:
        raise ValueError(
            "Utterance {}: Channel is not specified but signal has shape "
            "{}".format(utt_id, signal.shape)
        )
    elif (channel != -1 and signal.ndim == 1) or (
        signal.ndim > 1 and channel >= signal.shape[0]
    ):
        raise ValueError(
            "Utterance {}: Channel specified as {} but signal has shape "
            "{}".format(utt_id, channel, signal.shape)
        )
    if signal.ndim != 1:
        signal = signal[channel]
    return signal


def _apply_learned_params(computer, rfilename: str):
    """Bake a trained ``STFTFrontend`` checkpoint into ``computer``.

    Accepts either a frontend-only checkpoint
    (:meth:`speech_tpu_torch.nn.STFTFrontend.save_params`, or the JAX
    package's: keys ``window``/``weights``) or a full KWS model checkpoint
    (:func:`speech_tpu_torch.models.kws.save_params`: keys under
    ``frontend/``), and returns a fresh computer carrying the learned
    parameters (see
    :meth:`~speech_tpu_torch.nn.STFTFrontend.export_computer`).
    """
    from .compute import ShortTimeFourierTransformFrameComputer
    from .nn import STFTFrontend

    if not isinstance(computer, ShortTimeFourierTransformFrameComputer):
        raise ValueError(
            "--learned-params requires an STFT computer config (learned "
            "checkpoints hold an analysis window + half-spectrum weights)"
        )
    with np.load(rfilename) as data:
        prefix = (
            "frontend/"
            if any(name.startswith("frontend/") for name in data.files)
            else ""
        )
        try:
            params = {
                "window": np.asarray(data[prefix + "window"], np.float64),
                "weights": np.asarray(data[prefix + "weights"], np.float64),
            }
        except KeyError as e:
            raise ValueError(
                f"checkpoint {rfilename} is missing {e.args[0]!r}; expected "
                "an STFTFrontend or models.kws checkpoint"
            ) from None
    return STFTFrontend(computer).export_computer(params)


def _build_processors(options):
    preprocessors = [
        alias_factory_subclass_from_arg(PreProcessor, cfg)
        for cfg in options.preprocess
    ]
    postprocessors = [
        alias_factory_subclass_from_arg(PostProcessor, cfg)
        for cfg in options.postprocess
    ]
    return preprocessors, postprocessors


class _VadTrimmer:
    """Keeps only voiced frames, Kaldi-pipeline style.

    ``--vad-trim CONFIG`` fuses Kaldi's ``compute-vad`` (energy VAD over
    the features' coefficient 0 — so the computer must be built with
    ``include_energy``) and ``select-voiced-frames`` into the extraction
    CLIs.  CONFIG is a JSON/YAML dict of
    :func:`speech_tpu_torch.ops.vad.energy_vad` keyword arguments (``{}`` for
    Kaldi's defaults).  The voicing decision reads the RAW (pre-
    ``--postprocess``) energy column, matching the Kaldi recipe order
    (VAD from plain MFCC/fbank energies, selection after CMVN), and the
    trim is applied after any ``--pitch`` columns, so rows stay aligned.
    """

    def __init__(self, computer, cfg):
        from .ops.vad import energy_vad_np

        if not computer.includes_energy:
            raise ValueError(
                "the computer config needs include_energy=true (the VAD "
                "reads the features' energy coefficient)"
            )
        kwargs = dict(cfg)
        self._fn = lambda e: energy_vad_np(e, **kwargs)
        # surface bad keys/values at startup, not mid-corpus
        self._fn(np.zeros(1))

    def __call__(self, raw, feats, utt_id):
        """Trim post-processed ``feats`` rows by VAD over ``raw[:, 0]``."""
        if feats.shape[0] != raw.shape[0]:
            raise ValueError(
                f"--vad-trim: postprocessors changed the frame count for "
                f"{utt_id} ({raw.shape[0]} -> {feats.shape[0]}), so voiced "
                "rows cannot be aligned; drop frame-count-changing "
                "postprocessors (e.g. stack) or trim before them"
            )
        mask = self._fn(np.asarray(raw[:, 0], np.float64))
        if not mask.any():
            print(
                f"--vad-trim: no frames of {utt_id} were judged voiced",
                file=sys.stderr,
            )
        return feats[mask]


class _PitchAppender:
    """Appends Kaldi-style pitch columns to each utterance's features.

    ``--pitch CONFIG`` takes keyword arguments for
    :func:`speech_tpu_torch.ops.pitch.pitch_feats` (``{}`` for defaults;
    ``frame_shift_ms`` defaults to the computer's so the track shares
    its frame grid).  Signals batch to the JAX package's power-of-two
    buckets (so rows match its CLI) and run on the computer's device; the
    three columns (POV, normalized log pitch, delta log pitch) are appended
    AFTER the ``--postprocess`` chain, row-aligned to the feature frame
    count -- the pitch track is a few frames shorter (its NCCF window spans
    ``frame_length + max_lag`` samples), so trailing rows repeat the last
    tracked frame, matching Kaldi's paste-feats + online-pitch tail
    behavior.  Each batch's pitch reads back synchronously, so ``--pitch``
    trades some of the extractor's dispatch/compute overlap for the extra
    columns.
    """

    def __init__(self, computer, cfg):
        self.kwargs = dict(cfg)
        self.kwargs.setdefault("frame_shift_ms", computer.frame_shift_ms)
        self.rate = computer.bank.sampling_rate
        self.device = computer.device
        self.mesh = None  # set by the CLI alongside the extractor's
        self.min_batch = 0  # set by the CLI to its batch size so the
        # trailing partial batch keeps the full batches' shape
        self._grid_warned = False

    @staticmethod
    def bucket_len(n):
        """The padded signal length a batch with max length ``n`` uses
        (pow2 with a floor that keeps short batches above the NCCF
        span)."""
        return max(1 << max(int(n) - 1, 0).bit_length(), 8192)

    def batch(self, signals):
        """1-D signal arrays -> per-utterance ``(valid_t, 3)`` float64."""
        from .ops.pitch import pitch_feats
        from .parallel import sharded_pitch_feats
        from .parallel.mesh import axis_size

        B = len(signals)
        lengths = np.array([s.shape[0] for s in signals], np.int32)
        L = self.bucket_len(int(lengths.max()))
        Bp = 1 << max(max(B, self.min_batch) - 1, 0).bit_length()
        dtype = (
            np.int16
            if all(s.dtype == np.int16 for s in signals)
            else np.float32
        )
        buf = np.zeros((Bp, L), dtype)
        lens = np.zeros((Bp,), np.int64)
        for i, s in enumerate(signals):
            buf[i, : s.shape[0]] = s
            lens[i] = s.shape[0]
        mesh = self.mesh
        if mesh is not None:
            # the sharded path splits over the mesh's data axis (not the
            # total device count -- they differ on multi-axis meshes)
            if "data" not in (mesh.mesh_dim_names or ()) or Bp % axis_size(
                mesh, "data"
            ):
                mesh = None  # every process runs the whole batch
        if mesh is not None:
            p3, valid = sharded_pitch_feats(
                buf, self.rate, lens, mesh, **self.kwargs
            )
            p3, valid = p3.full_tensor(), valid.full_tensor()
        else:
            p3, valid = pitch_feats(
                torch.from_numpy(buf).to(self.device),
                self.rate,
                lengths=torch.from_numpy(lens).to(self.device),
                return_valid=True,
                **self.kwargs,
            )
        p3 = p3.cpu().numpy().astype(np.float64)
        valid = valid.cpu().numpy()
        return [p3[i, : int(valid[i])] for i in range(B)]

    def one(self, signal):
        return self.batch([np.asarray(signal)])[0]

    def append(self, feats, p3, pre_rows=None):
        """Concatenate ``p3`` onto ``(T, F)`` feats, aligned to T rows.

        ``pre_rows`` is the frame count BEFORE the --postprocess chain;
        a frame-count-changing postprocessor (e.g. "stack") moves the
        features off the pitch track's frame grid, which row-for-row
        pasting cannot follow — warn (once) rather than misalign
        silently.
        """
        T = feats.shape[0]
        if pre_rows is not None and pre_rows != T and not self._grid_warned:
            self._grid_warned = True
            logger.warning(
                "--pitch pastes row-for-row, but a postprocessor changed "
                "the frame count (%d -> %d); the pitch columns stay on "
                "the computer's original frame grid",
                pre_rows,
                T,
            )
        out = np.zeros((T, p3.shape[-1]), feats.dtype)
        v = min(p3.shape[0], T)
        out[:v] = p3[:v]
        if 0 < v < T:
            out[v:] = p3[v - 1]
        return np.concatenate([feats, out], axis=-1)


def _signals_to_torch_feat_dir_parse_args(args):
    parser = argparse.ArgumentParser(
        description=signals_to_torch_feat_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "map",
        type=argparse.FileType("r"),
        help="Path to the file containing (<utterance>, <path>) pairs",
    )
    parser.add_argument(
        "computer_config",
        type=_config_type,
        nargs="?",
        default=None,
        help="JSON file or string configuring a FrameComputer; if "
        "unspecified, audio is stored directly with shape (S, 1)",
    )
    parser.add_argument("dir", help="Directory to output features to")
    parser.add_argument("--channel", type=int, default=-1)
    parser.add_argument("--preprocess", type=_config_type, default=tuple())
    parser.add_argument("--postprocess", type=_config_type, default=tuple())
    parser.add_argument("--force-as", default=None, choices=_FORCE_AS_CHOICES)
    parser.add_argument("--seed", type=_nonneg_int_type, default=None)
    parser.add_argument(
        "--learned-params",
        default=None,
        metavar="NPZ",
        help="Checkpoint of a trained STFTFrontend (or a models.kws "
        "checkpoint); its learned window/weights are baked into the "
        "computer before extraction",
    )
    parser.add_argument("--file-prefix", default="")
    parser.add_argument("--file-suffix", default=".pt")
    parser.add_argument(
        "--num-workers",
        type=_nonneg_int_type,
        default=0,
        help="Host threads reading and decoding audio (0: main thread). "
        "Does not affect determinism when used with --seed.",
    )
    parser.add_argument(
        "--manifest",
        type=argparse.FileType("a+"),
        default=None,
        help="File tracking completed utterances, for resuming",
    )
    parser.add_argument(
        "--batch-size",
        type=_nonneg_int_type,
        default=64,
        help="Utterances per device batch (0: one at a time on host)",
    )
    parser.add_argument(
        "--sort-window",
        type=_nonneg_int_type,
        default=8,
        help="Length-sort utterances within a window of this many device "
        "batches before bucketing them, so a batch pads to the length of "
        "similar-length neighbors rather than the corpus-wide straggler "
        "(host memory holds one window of audio; 1 keeps map-order batch "
        "composition). Per-utterance outputs and --seed noise are "
        "unaffected; only the write order changes.",
    )
    parser.add_argument(
        "--fine-buckets",
        action="store_true",
        help="Pad batches to {2^k, 3*2^(k-1)} length buckets instead of "
        "powers of two (less padding waste, up to twice the distinct "
        "batch shapes)",
    )
    parser.add_argument(
        "--profile",
        nargs="?",
        const="",
        default=None,
        metavar="TRACE_DIR",
        help="Log per-stage timings; with a directory argument, also "
        "capture a TensorBoard device trace there",
    )
    parser.add_argument(
        "--resample-from",
        type=_nonneg_int_type,
        default=None,
        metavar="HZ",
        help="Treat every mapped signal as sampled at this rate and "
        "polyphase-resample it to the computer's sampling rate on load "
        "(requires a computer config; raw sources like npy carry no "
        "rate of their own)",
    )
    parser.add_argument(
        "--pitch",
        type=_config_type,
        default=None,
        metavar="CONFIG",
        help="Append 3 Kaldi-style pitch columns (POV, normalized log "
        "pitch, delta log pitch) to each utterance's features, after the "
        "--postprocess chain. CONFIG is a JSON/YAML dict of "
        "speech_tpu_torch.ops.pitch.pitch_feats keyword arguments ('{}' for "
        "defaults; frame_shift_ms follows the computer's). Requires a "
        "computer config.",
    )
    parser.add_argument(
        "--speed-perturb",
        default=None,
        metavar="FACTORS",
        help="Comma-separated speed factors (e.g. '0.9,1.0,1.1', the "
        "Kaldi perturb_data_dir_speed set). Each utterance is emitted "
        "once per factor; copies at factor f are resampled to 1/f of "
        "the length (sox speed semantics) and named 'sp<f>-<utt_id>' "
        "(factor 1 keeps the plain id).",
    )
    _add_vad_trim_arg(parser)
    _add_aot_args(parser, precompile=True)
    return parser.parse_args(args)


def _add_aot_args(parser, precompile=False):
    parser.add_argument(
        "--aot-dir",
        default=None,
        metavar="DIR",
        help="On-disk store of the built kernel libraries "
        "(speech_tpu_torch.aot.AOTCache): CUDA kernels (nvcc) and the "
        "shorten decoder (g++) that ANY previous process built load from "
        "it instead of rebuilding, also on a machine with no compiler."
        + (
            " Populate it once with --precompile; later runs then "
            "start cold with zero builds."
            if precompile
            else " The first run populates it; later runs start cold "
            "with zero builds."
        ),
    )
    if precompile:
        parser.add_argument(
            "--precompile",
            action="store_true",
            help="Run every bucket this corpus needs once into --aot-dir "
            "and exit without writing features. Scans the corpus for "
            "signal lengths/dtypes, runs a zero batch of each (bucket x "
            "batch x dtype) grid point, and stores the libraries they "
            "load.",
        )
    parser.add_argument(
        "--aot-max-bytes",
        type=int,
        default=None,
        metavar="N",
        help="Byte cap on the --aot-dir store: after each store write "
        "(and under --aot-prune), least-recently-used libraries past "
        "the cap are evicted (hits refresh an entry's clock).",
    )
    parser.add_argument(
        "--aot-prune",
        action="store_true",
        help="Prune the --aot-dir store and exit: sweep libraries "
        "orphaned by a compiler upgrade (their fingerprint can never be "
        "served again where that compiler is installed) and evict LRU "
        "entries past --aot-max-bytes, then print what was removed.",
    )


def _make_aot(options):
    """AOTCache for --aot-dir (with the --aot-max-bytes cap), or None."""
    aot_dir = getattr(options, "aot_dir", None)
    if aot_dir is None:
        return None
    from .aot import AOTCache

    return AOTCache(
        aot_dir, max_bytes=getattr(options, "aot_max_bytes", None)
    )


def _handle_aot_prune(options) -> bool:
    """--aot-prune: sweep/evict the store and report.  True = handled
    (the caller exits 0 without doing any feature work)."""
    if not getattr(options, "aot_prune", False):
        return False
    if getattr(options, "aot_dir", None) is None:
        raise SystemExit("--aot-prune requires --aot-dir")
    res = _make_aot(options).prune()
    print(
        "aot store pruned: {orphans_removed} orphan(s) swept, "
        "{evicted} evicted, {kept} kept ({bytes} bytes)".format(**res)
    )
    return True


def _add_vad_trim_arg(parser):
    parser.add_argument(
        "--vad-trim",
        type=_config_type,
        default=None,
        metavar="CONFIG",
        help="Keep only voiced frames (Kaldi compute-vad + "
        "select-voiced-frames): energy VAD over the raw features' "
        "coefficient 0 (the computer config needs include_energy=true), "
        "trimmed after --postprocess and any --pitch columns. CONFIG is "
        "a JSON/YAML dict of speech_tpu_torch.ops.vad.energy_vad keyword "
        "arguments ('{}' for Kaldi's defaults).",
    )


def _parse_speed_factors(spec):
    """'0.9,1.0,1.1' -> [(out-id prefix, (up, down) or None), ...]."""
    from fractions import Fraction

    out = []
    seen = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            f = float(tok)
        except ValueError:
            raise ValueError(f"--speed-perturb: {tok!r} is not a number")
        if f <= 0:
            raise ValueError(f"--speed-perturb: factor {tok} must be positive")
        frac = Fraction(f).limit_denominator(32)
        if frac in seen:
            raise ValueError(f"--speed-perturb: duplicate factor {tok}")
        seen.add(frac)
        if frac == 1:
            out.append(("", None))
        else:
            out.append((f"sp{f:g}-", (frac.denominator, frac.numerator)))
    if not out:
        raise ValueError("--speed-perturb: no factors given")
    return out


_PRE_LOCK = threading.Lock()


def _compact_pcm(signal: np.ndarray) -> np.ndarray:
    """Downcast a float signal holding exact int16 PCM values to int16.

    Integer-PCM audio read as float (the common wav case) round-trips
    exactly; the batch paths then ship it to the device at half the
    float32 transfer width and upcast on the device (see
    :func:`speech_tpu_torch.compute._to_device`).  Signals with
    fractional, out-of-range, or non-finite values pass through
    unchanged.
    """
    if signal.dtype.kind != "f" or signal.size == 0:
        return signal
    lo, hi = signal.min(), signal.max()
    # NaN propagates into lo/hi and fails these comparisons
    if not (lo >= np.iinfo(np.int16).min and hi <= np.iinfo(np.int16).max):
        return signal
    if np.any(signal != np.trunc(signal)):
        return signal
    return signal.astype(np.int16)


def _load_utt(
    item,
    preprocessors,
    channel,
    force_as,
    seed,
    compact=False,
    resample=None,
    speed=None,
):
    idx, rest = item
    if len(rest) == 3:
        # --speed-perturb expansion: per-item ratio rides in the payload
        utt_id, path, speed = rest
    else:
        utt_id, path = rest
    try:
        signal = read_signal(path, dtype=np.float64, force_as=force_as, key=utt_id)
    except Exception as e:
        raise IOError(f"Utterance {utt_id}: {e}") from e
    signal = _select_channel(signal, channel, utt_id)
    if resample is not None:
        # (target, source) rates; before preprocessors so e.g. dither
        # noise is drawn at the rate the computer will see
        from .ops.resample import resample_np

        signal = resample_np(signal, resample[0], resample[1])
    if speed is not None:
        # (up, down) of the reduced 1/factor ratio (sox speed semantics;
        # after any rate conversion, before preprocessors — each
        # perturbed copy is an independent utterance, so e.g. dither is
        # drawn fresh per copy)
        from .ops.resample import resample_np

        signal = resample_np(signal, speed[0], speed[1])
    if preprocessors:
        # the host preprocessors draw from numpy's global RNG (reference
        # parity); serialize the seeded region so worker threads stay
        # deterministic under --seed
        with _PRE_LOCK:
            rng = np.random.RandomState(None if seed is None else seed + idx)
            orig = np.random.get_state()
            np.random.set_state(rng.get_state())
            try:
                for p in preprocessors:
                    signal = p.apply(signal, in_place=True)
            finally:
                np.random.set_state(orig)
    elif compact:
        signal = _compact_pcm(signal)
    return utt_id, signal


def signals_to_torch_feat_dir(args: Optional[Sequence[str]] = None) -> int:
    """Convert a map of signals to a directory of torch feature tensors.

    Reads a text file of ``<utt_id> <path>`` lines, computes features in
    device batches, and stores one ``(T, F)`` float32 tensor per utterance
    at ``dir/<file_prefix><utt_id><file_suffix>`` (reference:
    command_line.py:468-607).
    """
    try:
        options = _signals_to_torch_feat_dir_parse_args(args)
    except SystemExit as ex:
        return ex.code
    try:
        return _signals_to_torch_feat_dir(options)
    finally:
        # argparse opened these; close them on every exit path
        options.map.close()
        if options.manifest is not None:
            options.manifest.close()


def _data_mesh(computer):
    """A ``"data"`` mesh over the processes of the running
    :mod:`torch.distributed` group, on the computer's device type, where
    the group has more than one process; else None."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    from .parallel import make_mesh

    return make_mesh(("data",), devices=computer.device.type)


def _writes_outputs() -> bool:
    """Whether this process writes the outputs: the only process, or rank
    0 of a running :mod:`torch.distributed` group (the other ranks run the
    same batches, whose results every rank gathers)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _signals_to_torch_feat_dir(options) -> int:
    if _handle_aot_prune(options):
        return 0
    if options.seed is None:
        seed = None
    else:
        seed = options.seed
    utt2path = dict()
    for line_no, line in enumerate(options.map):
        line = line.strip()
        if not line:
            continue
        ls = line.split(" ")
        if len(ls) < 2:
            print(
                "Line {} of {}: not of format <utt_id> <path>".format(
                    line_no + 1, options.map.name
                ),
                file=sys.stderr,
            )
            return 1
        utt_id = ls[0]
        if utt_id in utt2path:
            print(
                'Line {} of {}: "{}" already exists as utterance'.format(
                    line_no + 1, options.map.name, utt_id
                ),
                file=sys.stderr,
            )
            return 1
        utt2path[utt_id] = " ".join(ls[1:])
    speed_factors = None
    if options.speed_perturb is not None:
        try:
            speed_factors = _parse_speed_factors(options.speed_perturb)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        # expand BEFORE the manifest filter: manifest entries name the
        # emitted (prefixed) utterances, so resume skips per copy
        expanded = dict()
        for utt_id, path in utt2path.items():
            for prefix, ratio in speed_factors:
                out_id = prefix + utt_id
                if out_id in expanded:
                    print(
                        f'--speed-perturb: output id "{out_id}" collides '
                        "with another map entry",
                        file=sys.stderr,
                    )
                    return 1
                expanded[out_id] = (path, ratio)
        utt2path = expanded
    if options.manifest is not None:
        options.manifest.seek(0)
        for line in options.manifest:
            utt2path.pop(line.strip(), None)
    if options.computer_config is None:
        computer = None
    else:
        computer = alias_factory_subclass_from_arg(
            FrameComputer, options.computer_config
        )
    if options.learned_params is not None:
        if computer is None:
            print(
                "--learned-params requires a computer config",
                file=sys.stderr,
            )
            return 1
        try:
            computer = _apply_learned_params(computer, options.learned_params)
        except (ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            return 1
    resample_rates = None
    if options.resample_from is not None:
        if options.resample_from <= 0:
            print(
                "--resample-from must be a positive rate, got "
                f"{options.resample_from}",
                file=sys.stderr,
            )
            return 1
        if computer is None:
            print(
                "--resample-from requires a computer config (the target "
                "rate is the computer's sampling rate)",
                file=sys.stderr,
            )
            return 1
        target = int(computer.bank.sampling_rate)
        if target != computer.bank.sampling_rate:
            print(
                "--resample-from requires an integer computer sampling "
                f"rate, got {computer.bank.sampling_rate}",
                file=sys.stderr,
            )
            return 1
        if target != options.resample_from:
            resample_rates = (target, options.resample_from)
    pitch = None
    if options.pitch is not None:
        if computer is None:
            print(
                "--pitch requires a computer config (the pitch track "
                "follows the computer's frame grid)",
                file=sys.stderr,
            )
            return 1
        if not isinstance(options.pitch, dict):
            print(
                f"--pitch expects a dict of pitch_feats options, got "
                f"{type(options.pitch).__name__}",
                file=sys.stderr,
            )
            return 1
        pitch = _PitchAppender(computer, options.pitch)
    vad_trim = None
    if options.vad_trim is not None:
        if computer is None:
            print(
                "--vad-trim requires a computer config (the VAD reads "
                "the features' energy coefficient)",
                file=sys.stderr,
            )
            return 1
        if not isinstance(options.vad_trim, dict):
            print(
                f"--vad-trim expects a dict of energy_vad options, got "
                f"{type(options.vad_trim).__name__}",
                file=sys.stderr,
            )
            return 1
        try:
            vad_trim = _VadTrimmer(computer, options.vad_trim)
        except (TypeError, ValueError) as e:
            print(f"--vad-trim: {e}", file=sys.stderr)
            return 1
    preprocessors, postprocessors = _build_processors(options)
    os.makedirs(options.dir, exist_ok=True)
    writes = _writes_outputs()
    if computer is not None:
        from .utils import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

    if speed_factors is None:
        items = list(enumerate(sorted(utt2path.items())))
    else:
        items = list(
            enumerate(sorted((u, p, r) for u, (p, r) in utt2path.items()))
        )
    if options.num_workers:
        pool = ThreadPoolExecutor(options.num_workers)
        mapper = pool.map
    else:
        pool = None
        mapper = map

    def save(utt_id, feats):
        if not writes:
            return
        # a host float32 tensor: either package's torch.load reads it
        feats = torch.as_tensor(np.ascontiguousarray(feats)).float()
        path = os.path.join(
            options.dir, options.file_prefix + utt_id + options.file_suffix
        )
        torch.save(feats, path)
        if options.manifest is not None:
            options.manifest.write(utt_id + "\n")
            options.manifest.flush()

    def postprocess(feats):
        for p in postprocessors:
            feats = p.apply(feats, axis=-1)
        return feats

    use_batched = (
        options.batch_size
        and isinstance(computer, LinearFilterBankFrameComputer)
        and hasattr(computer, "compute_batch")
    )
    extractor = None
    if use_batched:
        from .parallel import ShardedExtractor

        mesh = _data_mesh(computer)
        extractor = ShardedExtractor(
            computer,
            mesh,
            bucket="fine" if options.fine_buckets else "pow2",
            aot_dir=_make_aot(options),
        )
        if pitch is not None:
            pitch.mesh = mesh
            pitch.min_batch = options.batch_size
    if options.precompile:
        if extractor is None:
            print(
                "--precompile requires a computer config and a nonzero "
                "--batch-size (it runs the batched device routes)",
                file=sys.stderr,
            )
            return 1
        if options.aot_dir is None:
            print("--precompile requires --aot-dir", file=sys.stderr)
            return 1

    from .profiling import StageTimer, trace

    timer = StageTimer()

    def loader():
        it = mapper(
            lambda item: _load_utt(
                item,
                preprocessors,
                options.channel,
                options.force_as,
                seed,
                # device-batched path: ship exact-int16 PCM compactly
                # (compute_full would type its *output* off the input
                # dtype, so only the extractor path downcasts)
                compact=extractor is not None,
                resample=resample_rates,
            ),
            items,
        )
        while True:
            # the stage closes before the yield: the consumer's time
            # between two items is not reading
            with timer.stage("read"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def save_timed(utt_id, feats):
        with timer.stage("write"):
            save(utt_id, feats)

    if options.precompile:
        from math import gcd

        from .aot import precompile_extractor
        from .io import probe_signal_info

        def _resampled_len(n, up, down):
            g = gcd(int(up), int(down))
            L, M = int(up) // g, int(down) // g
            return -(-n * L // M)  # ops/resample.resample_np's n_out

        # size the grid from container headers where they are decisive
        # (wav-PCM/SPHERE/npy sample counts, adjusted by the exact
        # resample/speed length formulas): a full IO+decode sweep over a
        # large corpus only to learn lengths is the slow path, so it is
        # reserved for utterances whose length or compacted dtype a header
        # cannot determine
        lengths, dtypes = [], set()
        slow_items = []
        for item in items:
            _idx, rest = item
            speed = rest[2] if len(rest) == 3 else None
            path = rest[1]
            n = None
            info = probe_signal_info(path, options.force_as)
            if info is not None:
                n, _chans, native = info
                if resample_rates is not None:
                    n = _resampled_len(n, *resample_rates)
                if speed is not None:
                    n = _resampled_len(n, *speed)
                if preprocessors:
                    dtypes.add(np.dtype(np.float64))
                elif resample_rates is not None or speed is not None:
                    # polyphase output is fractional: never compacts
                    dtypes.add(np.dtype(np.float64))
                elif native in (np.dtype(np.int16), np.dtype(np.uint8)):
                    dtypes.add(np.dtype(np.int16))  # _compact_pcm path
                else:
                    n = None  # can't predict compaction: decode it
            if n is None:
                slow_items.append(item)
            else:
                lengths.append(int(n))
        if slow_items:
            print(
                f"precompile: decoding {len(slow_items)} utterance(s) "
                "without decisive headers "
                f"({len(lengths)} sized from headers)",
                file=sys.stderr,
            )
            for _utt_id, signal in mapper(
                lambda item: _load_utt(
                    item,
                    preprocessors,
                    options.channel,
                    options.force_as,
                    seed,
                    compact=True,
                    resample=resample_rates,
                ),
                slow_items,
            ):
                lengths.append(len(signal))
                dtypes.add(np.asarray(signal).dtype)
        if not lengths:
            print("no utterances to precompile for", file=sys.stderr)
            return 1
        n = precompile_extractor(
            extractor,
            lengths,
            batches=[options.batch_size],
            dtypes=sorted(dtypes, key=str),
            progress=lambda msg: print(msg, file=sys.stderr),
        )
        if pitch is not None:
            # the --pitch appender's own bucket grid (pow2 lengths with
            # its 8192 floor, pow2 batch), as the JAX package walks it
            for dtype in sorted(dtypes, key=str):
                seen = set()
                for m in lengths:
                    L = pitch.bucket_len(m)
                    if L in seen:
                        continue
                    seen.add(L)
                    n += 1
                    print(
                        f"precompile pitch bucket={L} "
                        f"batch={options.batch_size} "
                        f"dtype={np.dtype(dtype).name}",
                        file=sys.stderr,
                    )
                    pitch.batch(
                        [np.zeros(L, dtype)] * options.batch_size
                    )
        s = extractor.aot.stats
        print(
            f"precompiled {n} program grid points into {options.aot_dir} "
            f"(compiled {s['misses']}, already stored {s['hits']})",
            file=sys.stderr,
        )
        if pool is not None:
            pool.shutdown()
        return 0

    try:
        with trace(options.profile or None):
            if computer is None:
                for utt_id, signal in loader():
                    save_timed(utt_id, postprocess(signal[:, None]))
            elif extractor is not None:
                # extract_iter keeps one dispatched batch in flight so
                # host read/pad of batch i+1 overlaps device compute of
                # batch i; batches are length-sorted within a bounded
                # window so each pads (and transfers) to its own bucket
                # rather than the window-wide maximum
                bsz = options.batch_size
                window = max(1, options.sort_window) * bsz
                batch_utts = []  # utt lists, in dispatch order
                batch_sigs = []  # per-batch signals, kept iff --pitch

                def batch_stream():
                    wutts, wsigs = [], []

                    def drain():
                        order = sorted(
                            range(len(wsigs)), key=lambda i: len(wsigs[i])
                        )
                        for s in range(0, len(order), bsz):
                            idxs = order[s : s + bsz]
                            batch_utts.append([wutts[i] for i in idxs])
                            if pitch is not None:
                                batch_sigs.append([wsigs[i] for i in idxs])
                            yield [wsigs[i] for i in idxs]
                        wutts.clear()
                        wsigs.clear()

                    for utt_id, signal in loader():
                        wutts.append(utt_id)
                        wsigs.append(signal)
                        if len(wutts) >= window:
                            yield from drain()
                    yield from drain()

                for done, batch_feats in enumerate(
                    extractor.extract_iter(
                        # min_batch: trailing partial batches keep the
                        # full batches' shape
                        batch_stream(), min_batch=bsz, timer=timer
                    )
                ):
                    p3s = None
                    if pitch is not None:
                        with timer.stage("pitch"):
                            p3s = pitch.batch(batch_sigs[done])
                        batch_sigs[done] = None  # keep memory O(batch)
                    for j, (utt_id, feats) in enumerate(
                        zip(batch_utts[done], batch_feats)
                    ):
                        raw = np.asarray(feats, np.float64)
                        feats = postprocess(raw)
                        if p3s is not None:
                            feats = pitch.append(
                                feats, p3s[j], pre_rows=raw.shape[0]
                            )
                        if vad_trim is not None:
                            feats = vad_trim(raw, np.asarray(feats), utt_id)
                        save_timed(utt_id, feats)
            else:
                for utt_id, signal in loader():
                    with timer.stage("compute"):
                        raw = computer.compute_full(signal)
                        feats = postprocess(raw)
                        if pitch is not None:
                            feats = pitch.append(
                                np.asarray(feats, np.float64),
                                pitch.one(signal),
                                pre_rows=raw.shape[0],
                            )
                        if vad_trim is not None:
                            feats = vad_trim(
                                np.asarray(raw), np.asarray(feats), utt_id
                            )
                    save_timed(utt_id, feats)
    finally:
        if pool is not None:
            pool.shutdown()
    if options.profile is not None:
        print(timer.summary(), file=sys.stderr)
        if extractor is not None and extractor.stats["kernel_samples"]:
            st = extractor.stats
            print(f"useful share: {100.0 * st['samples'] / st['kernel_samples']:.2f}% "
                  f"({st['samples']} real of {st['kernel_samples']} samples handed to "
                  f"the computer in {st['batches']} batches)", file=sys.stderr)
    return 0


def _compute_feats_from_kaldi_tables_parse_args(args):
    parser = argparse.ArgumentParser(
        description=compute_feats_from_kaldi_tables.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("wav_rspecifier", help="Input wave table rspecifier")
    parser.add_argument(
        "feats_wspecifier", help="Output feature table wspecifier"
    )
    parser.add_argument(
        "computer_config",
        type=_config_type,
        help="JSON file or string configuring a FrameComputer",
    )
    parser.add_argument("--min-duration", type=float, default=0.0)
    parser.add_argument(
        "--learned-params",
        default=None,
        metavar="NPZ",
        help="Checkpoint of a trained STFTFrontend (or a models.kws "
        "checkpoint); its learned window/weights are baked into the "
        "computer before extraction",
    )
    parser.add_argument("--channel", type=int, default=-1)
    parser.add_argument("--preprocess", type=_config_type, default=tuple())
    parser.add_argument("--postprocess", type=_config_type, default=tuple())
    parser.add_argument("--seed", type=_nonneg_int_type, default=None)
    parser.add_argument(
        "--batch-size",
        type=_nonneg_int_type,
        default=64,
        help="Utterances per device batch (0: one at a time on host)",
    )
    parser.add_argument(
        "--sort-window",
        type=_nonneg_int_type,
        default=1,
        help="Length-sort utterances within a window of this many device "
        "batches before bucketing them (cuts padding/transfer waste for "
        "mixed-length tables). Features are still written in table order "
        "— one window of audio+results is buffered on host, so the "
        "default of 1 keeps the strict O(batch) streaming footprint.",
    )
    parser.add_argument(
        "--fine-buckets",
        action="store_true",
        help="Pad batches to {2^k, 3*2^(k-1)} length buckets instead of "
        "powers of two (less padding waste, up to twice the distinct "
        "batch shapes)",
    )
    parser.add_argument(
        "--resample",
        action="store_true",
        help="Polyphase-resample utterances whose table sample rate "
        "differs from the computer's instead of skipping them (the "
        "default mirrors the reference: warn and produce no output)",
    )
    parser.add_argument(
        "--pitch",
        type=_config_type,
        default=None,
        metavar="CONFIG",
        help="Append 3 Kaldi-style pitch columns (POV, normalized log "
        "pitch, delta log pitch) to each utterance's features, after the "
        "--postprocess chain. CONFIG is a JSON/YAML dict of "
        "speech_tpu_torch.ops.pitch.pitch_feats keyword arguments ('{}' for "
        "defaults; frame_shift_ms follows the computer's).",
    )
    _add_vad_trim_arg(parser)
    cmvn = parser.add_mutually_exclusive_group()
    cmvn.add_argument(
        "--cmvn-stats-out",
        default=None,
        metavar="WSPECIFIER",
        help="Accumulate Kaldi-layout CMVN sufficient statistics (a (2, "
        "F+1) [sums|count ; sumsqs|_] double matrix per speaker) over the "
        "features as written, and store them in this table on exit — the "
        "compute-cmvn-stats step of a Kaldi pipeline. Speakers come from "
        "--utt2spk (default: one entry per utterance).",
    )
    cmvn.add_argument(
        "--apply-cmvn",
        default=None,
        metavar="RSPECIFIER",
        help="Normalize each utterance with its speaker's statistics from "
        "this table before writing — the apply-cmvn step of a Kaldi "
        "pipeline. Speakers come from --utt2spk; utterances whose speaker "
        "has no stats warn and produce no output.",
    )
    parser.add_argument(
        "--utt2spk",
        default=None,
        metavar="FILE",
        help="'<utt> <spk>' map for --cmvn-stats-out/--apply-cmvn "
        "(utterances missing from the map fall back to per-utterance keys)",
    )
    parser.add_argument(
        "--cmvn-norm-vars",
        action="store_true",
        help="--apply-cmvn normalizes variance as well as mean (the Kaldi "
        "apply-cmvn --norm-vars flag; default mean-only, like Kaldi)",
    )
    parser.add_argument(
        "--compress",
        nargs="?",
        const="auto",
        default=None,
        choices=("auto", "1", "2", "3"),
        help="Write the feature table compressed (Kaldi compressed-matrix "
        "format; method 1 = per-column percentile bytes, 2 = uint16, 3 = "
        "uint8, auto = Kaldi's row-count heuristic). Always uses the "
        "native writer.",
    )
    parser.add_argument(
        "--segments",
        default=None,
        metavar="FILE",
        help="Kaldi segments file ('<utt> <recording> <start-sec> "
        "<end-sec>'; end -1 = recording end): cut utterances out of each "
        "recording before computing features (extract-segments fused in). "
        "The wave table then holds recordings; features are written per "
        "segment utterance, grouped by recording in table order.",
    )
    parser.add_argument(
        "--min-segment-length",
        type=float,
        default=0.1,
        help="Minimum --segments utterance length in seconds (Kaldi "
        "extract-segments default 0.1); shorter segments warn and skip",
    )
    parser.add_argument(
        "--max-overshoot",
        type=float,
        default=0.5,
        help="How far (seconds) a segment end may overshoot its recording "
        "and still be clamped rather than skipped (Kaldi "
        "--max-overshoot-tolerance)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    _add_aot_args(parser)
    return parser.parse_args(args)


def compute_feats_from_kaldi_tables(args: Optional[Sequence[str]] = None) -> int:
    """Store features from a kaldi archive in a kaldi archive.

    Intended to replace Kaldi's "compute-<something>-feats" scripts in a
    Kaldi pipeline (reference: command_line.py:245-359).  Uses
    ``pydrobert-kaldi`` when installed, else the native pure-Python table
    I/O in :mod:`speech_tpu_torch.io.kaldi_tables`.
    """
    try:
        options = _compute_feats_from_kaldi_tables_parse_args(args)
    except SystemExit as ex:
        return ex.code
    if options.verbose:
        logging.basicConfig(level=logging.INFO)
    if _handle_aot_prune(options):
        return 0
    try:
        from pydrobert.kaldi.io import open as kaldi_open  # type: ignore
        from pydrobert.kaldi.io.enums import KaldiDataType  # type: ignore

        base_is_double = KaldiDataType.BaseMatrix.is_double
    except ImportError:
        # native pure-Python table I/O (speech_tpu_torch.io.kaldi_tables): same
        # ark/scp formats, no bindings needed
        kaldi_open = None
        base_is_double = False
        logger.info("pydrobert-kaldi not found; using native table I/O")
    if options.seed is not None:
        np.random.seed(options.seed)
    computer = alias_factory_subclass_from_arg(
        FrameComputer, options.computer_config
    )
    if options.learned_params is not None:
        try:
            computer = _apply_learned_params(computer, options.learned_params)
        except (ValueError, OSError) as e:
            logger.error(str(e))
            return 1
    pitch = None
    if options.pitch is not None:
        if not isinstance(options.pitch, dict):
            print(
                f"--pitch expects a dict of pitch_feats options, got "
                f"{type(options.pitch).__name__}",
                file=sys.stderr,
            )
            return 1
        pitch = _PitchAppender(computer, options.pitch)
    vad_trim = None
    if options.vad_trim is not None:
        if not isinstance(options.vad_trim, dict):
            print(
                f"--vad-trim expects a dict of energy_vad options, got "
                f"{type(options.vad_trim).__name__}",
                file=sys.stderr,
            )
            return 1
        try:
            vad_trim = _VadTrimmer(computer, options.vad_trim)
        except (TypeError, ValueError) as e:
            print(f"--vad-trim: {e}", file=sys.stderr)
            return 1
    utt2spk = {}
    if options.utt2spk is not None:
        try:
            with open(options.utt2spk, encoding="utf-8") as u2s:
                for lineno, line in enumerate(u2s, 1):
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts) != 2:
                        print(
                            f"--utt2spk line {lineno} is not '<utt> <spk>': "
                            f"{line.rstrip()!r}",
                            file=sys.stderr,
                        )
                        return 1
                    utt2spk[parts[0]] = parts[1]
        except IOError:
            logger.error("Could not read --utt2spk %s", options.utt2spk)
            return 1
    segments = None
    if options.segments is not None:
        segments = {}
        try:
            with open(options.segments, encoding="utf-8") as seg_file:
                for lineno, line in enumerate(seg_file, 1):
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts) != 4:
                        print(
                            f"--segments line {lineno} is not '<utt> <rec> "
                            f"<start> <end>': {line.rstrip()!r}",
                            file=sys.stderr,
                        )
                        return 1
                    utt_id, rec_id = parts[0], parts[1]
                    try:
                        start, end = float(parts[2]), float(parts[3])
                    except ValueError:
                        start, end = -1.0, -1.0
                    if start < 0 or (end != -1.0 and end <= start):
                        print(
                            f"--segments line {lineno} has a bad time range: "
                            f"{line.rstrip()!r}",
                            file=sys.stderr,
                        )
                        return 1
                    segments.setdefault(rec_id, []).append(
                        (utt_id, start, end)
                    )
        except IOError:
            logger.error("Could not read --segments %s", options.segments)
            return 1
    cmvn_accs = {}
    cmvn_apply = None
    if options.apply_cmvn is not None:
        from .io.kaldi_tables import iter_table
        from .post import Standardize

        try:
            cmvn_apply = {
                spk: Standardize.from_stats(
                    mat, norm_var=options.cmvn_norm_vars
                )
                for spk, mat in iter_table(options.apply_cmvn)
            }
        except (IOError, ValueError) as e:
            logger.error(
                "Could not read CMVN stats %s: %s", options.apply_cmvn, e
            )
            return 1
    preprocessors, postprocessors = _build_processors(options)
    try:
        if kaldi_open is not None:
            wav_reader = kaldi_open(
                options.wav_rspecifier, "wm", value_style="bsd"
            )
        else:
            from .io.kaldi_tables import open_wave_reader

            wav_reader = open_wave_reader(options.wav_rspecifier)
    except IOError:
        logger.error(
            "Could not read the wave table %s", options.wav_rspecifier
        )
        return 1
    writes = _writes_outputs()
    # the ranks of a process group other than 0 run the same batches (every
    # rank gathers every row) and discard what they would write
    feats_wspecifier = (
        options.feats_wspecifier if writes else "ark:" + os.devnull
    )
    try:
        if kaldi_open is not None and options.compress is None:
            feat_writer = kaldi_open(feats_wspecifier, "bm", mode="w")
        else:
            # the native writer also serves --compress when bindings exist
            from .io.kaldi_tables import KaldiTableWriter

            compress = (
                False
                if options.compress is None
                else options.compress
                if options.compress == "auto"
                else int(options.compress)
            )
            feat_writer = KaldiTableWriter(feats_wspecifier, compress=compress)
    except IOError:
        logger.error(
            "Could not open the feat table %s for writing",
            options.feats_wspecifier,
        )
        return 1
    counts = {"utts": 0, "success": 0}

    def table_utterances():
        # one (utt, 2-D buffer, rate, duration) per utterance: the raw
        # table entries, or --segments slices cut out of each recording
        # (Kaldi extract-segments fused in; segment sample ranges are cut
        # at the TABLE's rate, before any resampling)
        if segments is None:
            for utt_id, (buff, samp_freq, duration) in wav_reader.items():
                yield utt_id, buff, samp_freq, duration
            return
        seen = set()
        for rec_id, (buff, samp_freq, _) in wav_reader.items():
            seen.add(rec_id)
            for utt_id, start, end in segments.get(rec_id, ()):
                first = int(round(start * samp_freq))
                last = (
                    buff.shape[1]
                    if end == -1.0
                    else int(round(end * samp_freq))
                )
                if last > buff.shape[1]:
                    if last - buff.shape[1] > options.max_overshoot * samp_freq:
                        logger.warning(
                            "Segment %s ends at %.2f but recording %s is "
                            "only %.2f long: producing no output",
                            utt_id,
                            end,
                            rec_id,
                            buff.shape[1] / samp_freq,
                        )
                        continue
                    last = buff.shape[1]
                if first >= last or (
                    last - first < options.min_segment_length * samp_freq
                ):
                    logger.warning(
                        "Segment %s is too short (%.3f sec): producing no "
                        "output",
                        utt_id,
                        (last - first) / samp_freq,
                    )
                    continue
                yield (
                    utt_id,
                    buff[:, first:last],
                    samp_freq,
                    (last - first) / samp_freq,
                )
        missing = sorted(
            rec for rec in segments if rec not in seen
        )
        if missing:
            logger.warning(
                "%d recordings in --segments were not in the wave table "
                "(e.g. %s)",
                len(missing),
                missing[0],
            )

    def valid_signals():
        # LAZY walk of the wave table — O(1) table entries in flight
        # (the reference iterates the same way: command_line.py:332-359);
        # validation/skip semantics and preprocessing happen here, in
        # table order, so --seed determinism is batch-size independent
        for utt_id, buff, samp_freq, duration in table_utterances():
            counts["utts"] += 1
            if duration < options.min_duration:
                logger.warning(
                    "File: %s is too short (%.2f sec): producing no output",
                    utt_id,
                    duration,
                )
                continue
            needs_resample = samp_freq != computer.bank.sampling_rate
            if needs_resample and not (
                options.resample
                and samp_freq == int(samp_freq)
                and computer.bank.sampling_rate
                == int(computer.bank.sampling_rate)
            ):
                logger.warning(
                    "Sample frequency mismatch for file %s: you specified "
                    "%.2f but data has %.2f: producing no output",
                    utt_id,
                    computer.bank.sampling_rate,
                    samp_freq,
                )
                continue
            cur_chan = options.channel
            if options.channel == -1 and buff.shape[0] > 1:
                logger.warning(
                    "Channel is not specified but you have data with %d "
                    "channels; defaulting to zero",
                    buff.shape[0],
                )
                cur_chan = 0
            elif options.channel >= buff.shape[0]:
                logger.warning(
                    "File with id %s has %d channels but you specified "
                    "channel %d, producing no output",
                    utt_id,
                    buff.shape[0],
                    options.channel,
                )
                continue
            buff = buff[cur_chan].astype(np.float64, copy=False)
            if needs_resample:
                from .ops.resample import resample_np

                buff = resample_np(
                    buff, int(computer.bank.sampling_rate), int(samp_freq)
                )
            for preprocessor in preprocessors:
                buff = preprocessor.apply(buff, in_place=True)
            if not preprocessors and use_batched:
                # exact-int16 PCM ships to the device at half width
                # (use_batched is bound before this generator first runs)
                buff = _compact_pcm(buff)
            yield utt_id, buff

    def emit(utt_id, feats, p3=None):
        pre_rows = feats.shape[0]
        raw = feats
        for postprocessor in postprocessors:
            feats = postprocessor.apply(feats, axis=-1)
        if p3 is not None:
            feats = pitch.append(
                np.asarray(feats, np.float64), p3, pre_rows=pre_rows
            )
        if vad_trim is not None:
            # per-utterance problems warn and skip, reference/Kaldi style
            try:
                feats = vad_trim(np.asarray(raw), np.asarray(feats), utt_id)
            except ValueError as e:
                logger.warning("%s: producing no output", e)
                return
            if not feats.shape[0]:
                # Kaldi select-voiced-frames omits all-unvoiced utterances
                return
        if cmvn_apply is not None:
            spk = utt2spk.get(utt_id, utt_id)
            std = cmvn_apply.get(spk)
            if std is None:
                logger.warning(
                    "No CMVN statistics for speaker %s (utterance %s): "
                    "producing no output",
                    spk,
                    utt_id,
                )
                return
            feats = std.apply(np.asarray(feats, np.float64))
        if options.cmvn_stats_out is not None and feats.shape[0]:
            from .post import Standardize

            spk = utt2spk.get(utt_id, utt_id)
            acc = cmvn_accs.get(spk)
            if acc is None:
                acc = cmvn_accs[spk] = Standardize()
            acc.accumulate(np.asarray(feats, np.float64))
        if not base_is_double:
            feats = feats.astype(np.float32)
        feat_writer.write(utt_id, feats)
        counts["success"] += 1
        if counts["success"] % 10 == 0:
            logger.info("Processed %d utterances", counts["success"])

    use_batched = (
        options.batch_size
        and isinstance(computer, LinearFilterBankFrameComputer)
        and hasattr(computer, "compute_batch")
    )
    if use_batched:
        # device micro-batches through the same bucketed mesh-sharded
        # path as signals-to-torch-feat-dir; extract_iter double-buffers
        # so host table decode overlaps device compute
        from .parallel import ShardedExtractor
        from .utils import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()
        mesh = _data_mesh(computer)
        extractor = ShardedExtractor(
            computer,
            mesh,
            bucket="fine" if options.fine_buckets else "pow2",
            aot_dir=_make_aot(options),
        )
        if pitch is not None:
            pitch.mesh = mesh
            pitch.min_batch = options.batch_size
        bsz = options.batch_size
        window = max(1, options.sort_window) * bsz

        def windows():
            utts, sigs = [], []
            for utt_id, buff in valid_signals():
                utts.append(utt_id)
                sigs.append(buff)
                if len(utts) >= window:
                    yield utts, sigs
                    utts, sigs = [], []
            if utts:
                yield utts, sigs

        # batches are length-sorted within each window so every batch pads
        # (and transfers) to its own bucket; results buffer per window and
        # are written back in exact table order (reference write-order
        # semantics: command_line.py:345-351)
        meta = []  # per dispatched batch: (window_idx, window positions)
        pending = {}  # window_idx -> [table-order utts, feats, batches left]

        def batch_stream():
            for widx, (utts, sigs) in enumerate(windows()):
                order = sorted(range(len(sigs)), key=lambda i: len(sigs[i]))
                groups = [
                    order[s : s + bsz] for s in range(0, len(order), bsz)
                ]
                pending[widx] = [
                    utts,
                    [None] * len(sigs),
                    len(groups),
                    [None] * len(sigs) if pitch is not None else None,
                ]
                for g in groups:
                    # the signals ride along iff --pitch (still O(window))
                    meta.append(
                        (widx, g, [sigs[i] for i in g] if pitch else None)
                    )
                    yield [sigs[i] for i in g]

        for done, feats_list in enumerate(
            extractor.extract_iter(batch_stream(), min_batch=bsz)
        ):
            widx, positions, sigs_b = meta[done]
            meta[done] = None  # keep held signals O(window)
            w = pending[widx]
            p3s = pitch.batch(sigs_b) if pitch is not None else None
            for k, (pos, feats) in enumerate(zip(positions, feats_list)):
                w[1][pos] = np.asarray(feats, np.float64)
                if p3s is not None:
                    w[3][pos] = p3s[k]
            w[2] -= 1
            if w[2] == 0:
                for pos, (utt_id, feats) in enumerate(zip(w[0], w[1])):
                    emit(utt_id, feats, None if w[3] is None else w[3][pos])
                del pending[widx]
    else:
        for utt_id, buff in valid_signals():
            emit(
                utt_id,
                computer.compute_full(buff),
                pitch.one(buff) if pitch is not None else None,
            )
    logger.info(
        "Done %d out of %d utterances", counts["success"], counts["utts"]
    )
    if options.cmvn_stats_out is not None and writes:
        from .io.kaldi_tables import KaldiTableWriter

        with KaldiTableWriter(options.cmvn_stats_out) as stats_writer:
            for spk in sorted(cmvn_accs):
                stats_writer.write(
                    spk, np.asarray(cmvn_accs[spk].stats, np.float64)
                )
        logger.info(
            "Wrote CMVN statistics for %d speakers to %s",
            len(cmvn_accs),
            options.cmvn_stats_out,
        )
    feat_writer.close()
    wav_reader.close()
    return 0 if counts["success"] else 1


def _torch_feat_dir_to_signals_parse_args(args):
    parser = argparse.ArgumentParser(
        description=torch_feat_dir_to_signals.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "dir",
        help="Directory of (T, F) float tensors (the "
        "signals-to-torch-feat-dir layout)",
    )
    parser.add_argument(
        "computer_config",
        type=_config_type,
        help="JSON file or string configuring the FrameComputer the "
        "features came from (must be an STFT computer)",
    )
    parser.add_argument("out_dir", help="Where to write <utt_id>.wav files")
    parser.add_argument("--file-prefix", default="", help="Input file prefix")
    parser.add_argument(
        "--file-suffix", default=".pt", help="Input file suffix"
    )
    parser.add_argument(
        "--n-iters",
        type=_nonneg_int_type,
        default=64,
        help="Griffin-Lim phase-recovery iterations",
    )
    parser.add_argument(
        "--momentum",
        type=float,
        default=0.99,
        help="Fast Griffin-Lim acceleration (0 = classic Griffin-Lim)",
    )
    parser.add_argument(
        "--batch-size",
        type=_nonneg_int_type,
        default=16,
        help="Utterances per device batch (within pow2 length buckets)",
    )
    parser.add_argument(
        "--peak-norm",
        type=float,
        default=None,
        metavar="FRAC",
        help="Peak-normalize each waveform to this fraction of int16 "
        "full scale (e.g. 0.95). Default writes the recovered sample "
        "values directly (features extracted from int16-range audio "
        "invert to int16-range waveforms), clipped at full scale.",
    )
    _add_aot_args(parser)
    return parser.parse_args(args)


def torch_feat_dir_to_signals(args: Optional[Sequence[str]] = None) -> int:
    """Invert a directory of torch feature tensors back to wav files.

    The inverse companion of ``signals-to-torch-feat-dir`` for (log)
    filter-bank features of an STFT computer (no reference
    counterpart): undoes the energy column / log / bank (ridge
    pseudo-inverse), recovers phase with fast Griffin-Lim -- all
    matmuls, device-batched over power-of-two length buckets with
    exact ragged masking (``ops/invert.py``) -- and writes one 16-bit
    PCM wav per utterance at the computer's sampling rate.  A
    40-filter mel bank pins only 40 numbers per frame, so this
    recovers the spectral envelope (intelligible, vocoder-grade), not
    the original waveform.
    """
    try:
        options = _torch_feat_dir_to_signals_parse_args(args)
    except SystemExit as ex:
        return ex.code
    if _handle_aot_prune(options):
        return 0
    if options.peak_norm is not None and not 0.0 < options.peak_norm <= 1.0:
        print(
            f"--peak-norm must be in (0, 1], got {options.peak_norm}",
            file=sys.stderr,
        )
        return 1
    computer = alias_factory_subclass_from_arg(
        FrameComputer, options.computer_config
    )
    from .compute import ShortTimeFourierTransformFrameComputer

    if not isinstance(computer, ShortTimeFourierTransformFrameComputer):
        print(
            "torch-feat-dir-to-signals requires an STFT computer config "
            "(the SI computer's modulus discards phase structure the "
            "inversion needs)",
            file=sys.stderr,
        )
        return 1
    pre, suf = options.file_prefix, options.file_suffix
    try:
        names = sorted(os.listdir(options.dir))
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1
    utts = [
        n[len(pre) : len(n) - len(suf)]
        for n in names
        if n.startswith(pre) and n.endswith(suf) and len(n) > len(pre) + len(suf)
    ]
    if not utts:
        print(f"no '{pre}*{suf}' files in {options.dir}", file=sys.stderr)
        return 1
    os.makedirs(options.out_dir, exist_ok=True)

    import wave

    from .ops.invert import feats_to_signal
    from .utils import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    # the inversion runs no hand-written kernel, so the store receives
    # only what the computer's own routes load
    computer.enable_aot(_make_aot(options))
    bsz = max(1, options.batch_size)
    F = computer.num_coeffs
    rate = int(round(computer.bank.sampling_rate))
    shift = computer.frame_shift
    device = computer.device

    def invert(batch, counts):
        """(B, T_pad, F) float32 + (B,) counts -> (B, T_pad*shift)."""
        y = feats_to_signal(
            torch.from_numpy(batch).to(device),
            computer,
            n_iters=options.n_iters,
            momentum=options.momentum,
            length=batch.shape[1] * shift,
            lengths=torch.from_numpy(counts).to(device),
        )
        return y.cpu().numpy()

    def write_wav(utt, y, n_samples):
        y = y[:n_samples]
        if options.peak_norm is not None:
            peak = np.abs(y).max()
            if peak > 0:
                y = y * (options.peak_norm * 32767.0 / peak)
        pcm = np.clip(np.round(y), -32767, 32767).astype(np.int16)
        with wave.open(os.path.join(options.out_dir, utt + ".wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())

    n_done = 0
    buckets = {}  # T_pad -> [(utt, feats (T, F) float32), ...]

    def flush(T_pad):
        group = buckets.pop(T_pad)
        for s in range(0, len(group), bsz):
            part = group[s : s + bsz]
            counts = np.zeros(bsz, np.int32)
            batch = np.zeros((bsz, T_pad, F), np.float32)
            for i, (_, f) in enumerate(part):
                counts[i] = f.shape[0]
                batch[i, : f.shape[0]] = f
            ys = invert(batch, counts)
            for i, (utt, f) in enumerate(part):
                write_wav(utt, ys[i], f.shape[0] * shift)

    for utt in utts:
        path = os.path.join(options.dir, pre + utt + suf)
        try:
            feats = np.asarray(torch.load(path).numpy(), np.float32)
        except Exception as e:
            print(f"{utt}: {e}: producing no output", file=sys.stderr)
            continue
        if feats.ndim != 2 or feats.shape[1] != F or not feats.shape[0]:
            print(
                f"{utt}: expected (T > 0, {F}) features, got "
                f"{feats.shape}: producing no output",
                file=sys.stderr,
            )
            continue
        T_pad = 1 << max(feats.shape[0] - 1, 0).bit_length()
        buckets.setdefault(T_pad, []).append((utt, feats))
        n_done += 1
        if len(buckets[T_pad]) >= bsz:
            flush(T_pad)
    for T_pad in sorted(buckets):
        flush(T_pad)
    return 0 if n_done else 1


def _copy_feats_tables_parse_args(args):
    parser = argparse.ArgumentParser(
        description=copy_feats_tables.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "rspecifier",
        help="Input: an ark/scp rspecifier, or 'dir:PATH' for a directory "
        "of per-utterance .pt/.npy feature files",
    )
    parser.add_argument(
        "wspecifier",
        help="Output: an ark / ark,t / ark,scp wspecifier, or 'dir:PATH' "
        "for a directory of per-utterance .pt files",
    )
    parser.add_argument(
        "--compress",
        nargs="?",
        const="auto",
        default=None,
        choices=("auto", "1", "2", "3"),
        help="Compress table output (Kaldi compressed-matrix methods)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    return parser.parse_args(args)


def copy_feats_tables(args: Optional[Sequence[str]] = None) -> int:
    """Copy a feature table, converting its storage format on the way.

    The Kaldi ``copy-feats`` companion (no reference counterpart), on the
    native table I/O: ark/scp <-> ark / ark,t (text) / ark,scp, with
    ``--compress`` for Kaldi compressed matrices, plus ``dir:PATH``
    endpoints bridging per-utterance ``.pt``/``.npy`` feature directories
    (``signals-to-torch-feat-dir`` output) into Kaldi pipelines and back.
    """
    try:
        options = _copy_feats_tables_parse_args(args)
    except SystemExit as ex:
        return ex.code
    if options.verbose:
        logging.basicConfig(level=logging.INFO)
    from .io.kaldi_tables import KaldiTableWriter, iter_table

    def entries():
        if options.rspecifier.startswith("dir:"):
            path = options.rspecifier[4:]
            for fn in sorted(os.listdir(path)):
                utt, dot, suffix = fn.rpartition(".")
                if suffix == "pt":
                    yield utt, torch.load(
                        os.path.join(path, fn), map_location="cpu"
                    ).numpy()
                elif suffix == "npy":
                    yield utt, np.load(os.path.join(path, fn))
        else:
            yield from iter_table(options.rspecifier)

    count = 0
    try:
        if options.wspecifier.startswith("dir:"):
            out_dir = options.wspecifier[4:]
            os.makedirs(out_dir, exist_ok=True)
            for utt, mat in entries():
                torch.save(
                    torch.from_numpy(np.asarray(mat)),
                    os.path.join(out_dir, f"{utt}.pt"),
                )
                count += 1
        else:
            compress = (
                False
                if options.compress is None
                else options.compress
                if options.compress == "auto"
                else int(options.compress)
            )
            with KaldiTableWriter(
                options.wspecifier, compress=compress
            ) as writer:
                for utt, mat in entries():
                    writer.write(utt, np.asarray(mat))
                    count += 1
    except (IOError, OSError) as e:
        logger.error("copy-feats-tables failed: %s", e)
        return 1
    logger.info("Copied %d entries", count)
    return 0 if count else 1


def main(args: Optional[Sequence[str]] = None) -> int:
    """Dispatch ``python -m speech_tpu_torch.command_line <command> ...``."""
    parser = argparse.ArgumentParser(prog="speech_tpu_torch.command_line")
    parser.add_argument(
        "command",
        choices=(
            "signals-to-torch-feat-dir",
            "compute-feats-from-kaldi-tables",
            "torch-feat-dir-to-signals",
            "copy-feats-tables",
        ),
    )
    if args is None:
        args = sys.argv[1:]
    ns, rest = parser.parse_known_args(args)
    if ns.command == "signals-to-torch-feat-dir":
        return signals_to_torch_feat_dir(rest)
    if ns.command == "torch-feat-dir-to-signals":
        return torch_feat_dir_to_signals(rest)
    if ns.command == "copy-feats-tables":
        return copy_feats_tables(rest)
    return compute_feats_from_kaldi_tables(rest)


if __name__ == "__main__":
    sys.exit(main())
