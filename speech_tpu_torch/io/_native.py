"""Loader for the native (C++) shorten decoder.

Compiles ``speech_tpu_torch/csrc/shorten.cpp`` with the system C++
compiler on first use into ``build/speech_tpu_torch/`` at the root of the
checkout (named by the hash of the source and flags, beside the CUDA
kernels' libraries), and exposes it via ctypes.  Returns None when no
compiler or library is available, in which case callers fall back to the
pure-Python decoder in :mod:`speech_tpu_torch.io.sphere` (same output, bit
for bit).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

from ..ops._build import _build_dir

__all__ = ["get_shorten_lib", "decode_shorten_native"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "shorten.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _build_dir() / f"libshorten_{digest.hexdigest()[:16]}.so"


def _build() -> str:
    out = _so_path()
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    # build into a temp file then atomically rename, so concurrent
    # processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", tmp, str(_SRC)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


def get_shorten_lib():
    """The loaded native library, building it if necessary; None if
    unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(_build())
            fn = lib.stpu_decode_shorten
            fn.restype = ctypes.c_longlong
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
            ]
            _LIB = lib
        except Exception as e:  # no compiler, bad toolchain, ...
            warnings.warn(
                f"native shorten decoder unavailable ({e}); using the "
                "pure-Python fallback"
            )
            _LIB = None
        return _LIB


def decode_shorten_native(payload: bytes, out_len: int, ulaw_outward):
    """Decode a full shorten payload with the native library.

    Returns ``(samples, sampsdone, ftype)`` with ``samples`` an int32 array
    of interleaved post-fixup values, or None if the library is
    unavailable.  Raises IOError on malformed streams (same conditions as
    the Python decoder).
    """
    lib = get_shorten_lib()
    if lib is None:
        return None
    out = np.zeros(out_len, dtype=np.int32)
    table = np.ascontiguousarray(ulaw_outward, dtype=np.uint8)
    assert table.shape == (13, 256)
    ftype = ctypes.c_int(0)
    ret = lib.stpu_decode_shorten(
        payload,
        len(payload),
        out.ctypes.data_as(ctypes.c_void_p),
        out.size,
        table.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(ftype),
    )
    if ret == -6:
        # header fields exceed the native decoder's working limits but may
        # still be valid; let the caller use the pure-Python decoder
        return None
    if ret < 0:
        messages = {
            -1: "unexpected end of shorten bitstream",
            -2: "unsupported shorten version",
            -3: "bad shorten file type",
            -4: "bad shorten command",
        }
        raise IOError(messages.get(int(ret), f"shorten decode error {ret}"))
    return out, int(ret), int(ftype.value)
