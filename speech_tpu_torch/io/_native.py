"""Loader for the native (C++) shorten decoder.

Compiles ``speech_tpu_torch/csrc/shorten.cpp`` with the system C++
compiler on first use into the active library store
(:func:`speech_tpu_torch.aot.active_store`: by default
``build/speech_tpu_torch/`` at the root of the checkout, beside the CUDA
kernels' libraries), keyed by the source and flags under the g++ release
that built it, and exposes it via ctypes.  A warmed store serves a machine
with no compiler.  Returns None when no library can be had, in which case
callers fall back to the pure-Python decoder in
:mod:`speech_tpu_torch.io.sphere` (same output, bit for bit).
"""

import ctypes
import threading
import warnings
import weakref
from pathlib import Path

import numpy as np

from .. import aot

__all__ = ["get_shorten_lib", "decode_shorten_native"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "shorten.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC")
_LOCK = threading.Lock()
# store -> the loaded library, or None where it could not be had
_LIBS = weakref.WeakKeyDictionary()


def _so_path() -> str:
    """The file the loaded library came from."""
    return get_shorten_lib()._name


def get_shorten_lib(store=None):
    """The loaded native library from ``store`` (a path or an
    :class:`~speech_tpu_torch.aot.AOTCache`; None: the active store),
    building it if necessary; None if unavailable."""
    store = aot.as_cache(store) or aot.active_store()
    with _LOCK:
        if store in _LIBS:
            return _LIBS[store]
        try:
            lib = store.load_library("shorten", _SRC, _FLAGS, "g++")
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
        except Exception as e:  # no compiler, bad toolchain, ...
            warnings.warn(
                f"native shorten decoder unavailable ({e}); using the "
                "pure-Python fallback"
            )
            lib = None
        _LIBS[store] = lib
        return lib


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
