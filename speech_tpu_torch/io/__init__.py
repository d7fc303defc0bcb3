"""Signal I/O: multi-format reading with filename-based dispatch.

The PyTorch port's own copy of :mod:`speech_tpu.io` (numpy only; tested
bit-equal against it).

``read_signal`` mirrors the reference's 10-way dispatch
(reference: src/pydrobert/speech/util.py:338-510): Kaldi tables and streams,
wave files, HDF5, numpy binaries/archives, PyTorch tensors, NIST SPHERE
(including shorten compression), raw binary, and soundfile-supported formats.
Optional backends degrade gracefully when unimportable.
"""

import io as _io

from re import match
from typing import Any, BinaryIO, Optional, Union

import numpy as np

from .. import config
from .sphere import read_sphere_header, sphere_read_signal  # noqa: F401
from . import kaldi_tables  # noqa: F401

__all__ = [
    "kaldi_tables",
    "probe_signal_info",
    "read_signal",
    "sphere_read_signal",
    "wds_read_signal",
]


def _kaldi_table_read(rfilename, dtype, key, **kwargs):
    try:
        from pydrobert.kaldi.io import open as io_open  # optional bindings
    except ImportError:
        # native pure-Python fallback (same ark/scp formats, no bindings)
        from .kaldi_tables import table_read

        return table_read(rfilename, dtype, key)

    if key is None:
        key = 0
    if dtype is None:
        dtype = "bm"
    if isinstance(key, str):
        with io_open(rfilename, dtype, mode="r+", **kwargs) as table:
            return table[key]
    with io_open(rfilename, dtype, mode="r", **kwargs) as table:
        for _ in range(key):
            if not table.move():
                raise IndexError("table index out of range")
        return table.value()


def _wav_read(rfilename, dtype, key, **kwargs):
    try:
        from scipy.io import wavfile
    except ImportError:
        wavfile = None
    if wavfile is not None:
        data = wavfile.read(rfilename, **kwargs)[1]
    else:
        # stdlib fallback: raw little-endian PCM frames, deinterleaved
        import wave

        with wave.open(rfilename, **kwargs) as wf:
            raw = wf.readframes(wf.getnframes())
            data = np.frombuffer(raw, dtype=f"<i{wf.getsampwidth()}")
            nchan = wf.getnchannels()
        if data.size % nchan:
            raise IOError(
                f"wave sample count ({data.size}) is not divisible by the "
                f"channel count ({nchan})"
            )
        if nchan > 1:
            data = data.reshape(-1, nchan)
    if dtype:
        data = data.astype(dtype)
    return data


def _hdf5_read(rfilename, dtype, key, **kwargs):
    import h5py

    with h5py.File(rfilename, "r", **kwargs) as h5f:
        if key:
            node = h5f[key]
        else:
            # no key: take the alphanumerically-first dataset in the file
            # (visititems recurses in that order and stops at the first
            # non-None return)
            node = h5f.visititems(
                lambda _, obj: obj if isinstance(obj, h5py.Dataset) else None
            )
            if node is None:
                raise IOError(f"no dataset found in {rfilename}")
        return np.array(node, dtype=dtype) if dtype else np.array(node)


def _npy_read(rfilename, dtype, key, **kwargs):
    data = np.load(rfilename, **kwargs)
    if dtype:
        data = data.astype(dtype)
    return data


def _npz_read(rfilename, dtype, key, **kwargs):
    archive = np.load(rfilename, **kwargs)
    data = archive[key] if key else archive["arr_0"]
    if dtype:
        data = data.astype(dtype)
    return data


def _torch_read(rfilename, dtype, key, **kwargs):
    import torch

    tensor = torch.load(rfilename, map_location="cpu", **kwargs)
    data = tensor.detach().numpy()
    return data.astype(dtype) if dtype else data


def _kaldi_stream_read(rfilename, dtype, key, **kwargs):
    try:
        from pydrobert.kaldi.io import open as io_open  # optional bindings
    except ImportError:
        from .kaldi_tables import stream_read

        return stream_read(rfilename, dtype)

    if dtype is None:
        dtype = "bm"
    with io_open(rfilename, mode="r", **kwargs) as inp_stream:
        return inp_stream.read(dtype)


def _fromfile_read(rfilename, dtype, key, **kwargs):
    if dtype:
        return np.fromfile(rfilename, dtype=dtype, **kwargs)
    return np.fromfile(rfilename, **kwargs)


_SOUNDFILE_SUBTYPE_DTYPES = {
    "FLOAT": np.float32,
    "DOUBLE": np.float64,
    "PCM_S8": np.int8,
    "PCM_U8": np.uint8,
    "PCM_32": np.int32,
    "PCM_24": np.int32,
}


def _soundfile_read(rfilename, dtype, key, **kwargs):
    import soundfile

    with soundfile.SoundFile(rfilename, **kwargs) as sf:
        # decode at the file's native width, THEN cast: asking soundfile
        # for a float dtype directly would rescale integer PCM to [-1, 1),
        # losing the raw sample values every other backend returns
        native = _SOUNDFILE_SUBTYPE_DTYPES.get(sf.subtype, np.int16)
        data = sf.read(dtype=native)
    return data if dtype is None else data.astype(dtype)


def _infer_force_as(rfilename: str) -> str:
    if match(r"^(ark|scp)(,\w+)*:", rfilename):
        return "table"
    suffix = rfilename.rsplit(".", maxsplit=1)[-1]
    if suffix in config.SOUNDFILE_SUPPORTED_FILE_TYPES:
        return suffix
    if rfilename.endswith(".wav"):
        return "wav"
    if rfilename.endswith(".hdf5"):
        return "hdf5"
    if rfilename.endswith(".npy"):
        return "npy"
    if rfilename.endswith(".npz"):
        return "npz"
    if rfilename.endswith(".pt"):
        return "pt"
    if rfilename.endswith(".sph"):
        return "sph"
    if rfilename.endswith("|"):
        return "kaldi"
    raise IOError(f"Unable to infer file type from {rfilename}. Set force_as.")


_READERS = {
    "table": _kaldi_table_read,
    "wav": _wav_read,
    "hdf5": _hdf5_read,
    "npy": _npy_read,
    "npz": _npz_read,
    "pt": _torch_read,
    "kaldi": _kaldi_stream_read,
    "file": _fromfile_read,
}


def read_signal(
    rfilename: Union[str, BinaryIO],
    dtype: Optional[Any] = None,
    key: Any = None,
    force_as: Optional[str] = None,
    **kwargs,
) -> np.ndarray:
    r"""Read a signal from a variety of sources.

    Dispatch on ``rfilename`` (reference: util.py:362-510):

    1.  ``(ark|scp)(,\w+)*:`` prefix: Kaldi table (via
        :mod:`pydrobert.kaldi` when installed, else the native reader in
        :mod:`speech_tpu_torch.io.kaldi_tables`); ``key`` selects an entry.
    2.  Suffix in ``config.SOUNDFILE_SUPPORTED_FILE_TYPES``: via soundfile.
    3.  ``.wav``: scipy (falling back to :mod:`wave`).
    4.  ``.hdf5``: h5py; ``key`` or depth-first search for the first dataset.
    5.  ``.npy`` / 6. ``.npz``: numpy binary/archive (``key`` or ``arr_0``).
    7.  ``.pt``: PyTorch tensor.
    8.  ``.sph``: NIST SPHERE (pcm/ulaw/alaw/shorten).
    9.  trailing ``|``: Kaldi input stream.
    10. otherwise: error (set ``force_as``).

    Parameters
    ----------
    rfilename
        Path, rspecifier, or open binary file (the latter requires
        ``force_as``).
    dtype
        Cast the result to this numpy dtype.
    key
        Entry selector for table/hdf5/npz types.
    force_as
        Bypass inference: one of ``'table' 'wav' 'hdf5' 'npy' 'npz' 'pt'
        'sph' 'kaldi' 'file' 'soundfile'`` or a soundfile-supported suffix.
    """
    if not isinstance(rfilename, str):
        if force_as is None:
            raise ValueError("cannot infer type from IO stream. Set force_as")
        if force_as in {"kaldi", "table"}:
            raise ValueError("kaldi types can't be read from an IO stream")
    elif force_as is None:
        force_as = _infer_force_as(rfilename)
    if force_as in _READERS:
        return _READERS[force_as](rfilename, dtype, key, **kwargs)
    if force_as == "sph":
        return sphere_read_signal(rfilename, dtype, key)
    if force_as == "soundfile" or force_as in config.SOUNDFILE_SUPPORTED_FILE_TYPES:
        return _soundfile_read(rfilename, dtype, key, **kwargs)
    avail = set(_READERS) | {"sph", "soundfile"} | config.SOUNDFILE_SUPPORTED_FILE_TYPES
    msg = f"force_as ('{force_as}') is not one of {sorted(avail)}."
    if force_as in config._BASE_SOUNDFILE_SUPPORTED_TYPES:
        msg += (
            "\n... but it could be, with the proper version of libsndfile "
            "and pysoundfile installed"
        )
    elif force_as in config._FULL_SOUNDFILE_SUPPORTED_TYPES:
        msg += (
            "\n... but pysoundfile may be able to handle it. "
            "Try setting force_as = 'soundfile'"
        )
    raise ValueError(msg)


def probe_signal_info(
    rfilename: str, force_as: Optional[str] = None
) -> Optional[tuple]:
    """Header-only ``(n_samples_per_channel, n_channels, native_dtype)``.

    For container formats whose headers carry the sample count — PCM wav
    (via :mod:`wave`), NIST SPHERE, and ``.npy`` — this answers without
    decoding any audio, which lets ``--precompile`` size its program grid
    over a large corpus in one cheap header pass instead of a full
    IO+decode sweep.  Returns ``None`` whenever only a real decode can
    tell (unknown container, float/compressed wav variants the ``wave``
    module rejects, archives needing a key, pipes, tables) — callers must
    fall back to :func:`read_signal`.

    ``native_dtype`` is the container's storage dtype (e.g. ``int16`` for
    PCM16 wav and every SPHERE coding), before any ``dtype=`` cast a
    reader would apply.
    """
    if not isinstance(rfilename, str):
        return None
    try:
        kind = force_as or _infer_force_as(rfilename)
    except IOError:
        return None
    try:
        if kind == "wav":
            import wave

            with wave.open(rfilename, "rb") as wf:
                if wf.getcomptype() not in ("NONE",):
                    return None
                width = wf.getsampwidth()
                dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
                if dtype is None:
                    return None
                return (
                    wf.getnframes(),
                    wf.getnchannels(),
                    np.dtype(dtype),
                )
        if kind == "sph":
            with open(rfilename, "rb") as f:
                (_, _, sampcount, _, chancount, _) = read_sphere_header(f)
            # every SPHERE coding (pcm/ulaw/alaw, shortened or not)
            # decodes to int16
            return int(sampcount), int(chancount), np.dtype(np.int16)
        if kind == "npy":
            from numpy.lib import format as npformat

            with open(rfilename, "rb") as f:
                version = npformat.read_magic(f)
                npformat._check_version(version)
                shape, _, dtype = npformat._read_array_header(f, version)
            if len(shape) == 1:
                return int(shape[0]), 1, np.dtype(dtype)
            if len(shape) == 2:
                return int(shape[0]), int(shape[1]), np.dtype(dtype)
            return None
    except Exception:
        return None
    return None


def wds_read_signal(key: str, data: bytes) -> Optional[np.ndarray]:
    """WebDataset decoder hook wrapping :func:`read_signal`.

    Returns None when the extension is unrecognized so other decoders get a
    chance (reference: util.py:513-544).  Kaldi types are unsupported.
    """
    try:
        force_as = _infer_force_as(key)
        return read_signal(_io.BytesIO(data), force_as=force_as)
    except Exception:
        return None
