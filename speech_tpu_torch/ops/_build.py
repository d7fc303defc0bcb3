"""Build and load the hand-written CUDA kernels.

Every ``speech_tpu_torch/csrc/*.cu`` compiles at first use into its own
shared library with a plain C interface, loaded with :mod:`ctypes`: no
PyTorch headers, so a build takes seconds.  All sources compile at once,
one ``nvcc`` each.  Libraries land in ``build/speech_tpu_torch/`` at the
root of the checkout, named by the hash of their source and flags, so an
edited source rebuilds and an unchanged one loads as it is.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["load_kernels"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    """``build/speech_tpu_torch`` beside the package."""
    return _PKG.parent / "build" / "speech_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    default = home / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(nvcc on PATH or under $CUDA_HOME/bin, by default /usr/local/cuda)"
    )


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir() / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel source; returns
    ``{source stem: CDLL}``."""
    with _lock:
        if _libs:
            return _libs
        sources = sorted(CSRC.glob("*.cu"))
        _build_dir().mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sources:
            target = _target(src)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((src, target, tmp, proc))
        errors = []
        for src, target, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name}:\n{log}")
                continue
            os.replace(tmp, target)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return _libs
