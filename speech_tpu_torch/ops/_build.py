"""Build and load the hand-written CUDA kernels.

Every ``speech_tpu_torch/csrc/*.cu`` compiles at first use into its own
shared library with a plain C interface, loaded with :mod:`ctypes`: no
PyTorch headers, so a build takes seconds.  All sources compile at once,
one ``nvcc`` each, which is why each kernel family keeps a source of its
own: ``stft_kernels.cu`` (B1/B3, the fused float kernel),
``int8_kernels.cu`` (B2, the int8 digit tiers on the tensor cores),
``double_kernels.cu`` (B4, the base-256 digit kernel) and
``layout_kernels.cu`` (the zero-padded rows of a packed batch).  Each
library exports its own ``stk_error_string`` for its own error codes.  The
libraries live in a :class:`speech_tpu_torch.aot.AOTCache`, keyed by
their source, flags and the card's compute capability under the nvcc
release that built them, so an edited source rebuilds, an unchanged one
loads as it is, and a warmed store serves a machine with no nvcc.  (The
host shorten decoder, ``csrc/shorten.cpp``, is built with g++ by
:mod:`speech_tpu_torch.io._native` into the same stores.)
"""

import ctypes
import threading
import weakref
from pathlib import Path
from typing import Dict

from .. import aot

__all__ = ["load_kernels"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
# store -> {source stem: CDLL}: each store is asked once a process
_by_store: "weakref.WeakKeyDictionary[aot.AOTCache, Dict[str, ctypes.CDLL]]" = (
    weakref.WeakKeyDictionary()
)


def _build_dir() -> Path:
    """``build/speech_tpu_torch`` beside the package (the default store)."""
    return aot.DEFAULT_DIR


def _nvcc() -> str:
    found = aot.find_compiler("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(nvcc on PATH or under $CUDA_HOME/bin, by default /usr/local/cuda)"
    )


def load_kernels(store=None) -> Dict[str, ctypes.CDLL]:
    """Load every kernel library from ``store`` (a path or an
    :class:`~speech_tpu_torch.aot.AOTCache`; None: the process default),
    building the missing ones; returns ``{source stem: CDLL}``."""
    store = aot.as_cache(store) or aot.default_store()
    with _lock:
        libs = _by_store.get(store)
        if libs is None:
            capability = aot.device_capability()
            libs = store.load_libraries([
                aot.Library(src.stem, src, NVCC_FLAGS, "nvcc", capability)
                for src in sorted(CSRC.glob("*.cu"))
            ])
            _by_store[store] = libs
        return libs
