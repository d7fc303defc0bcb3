"""What the port's kernel-variant timers share
(``tools/torch_float_variants.py``, ``tools/torch_double_variants.py``):
edited copies of one kernel source built with the port's own nvcc flags,
a way to swap one in behind the kernel's wrapper, and CUDA-event timing.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_tpu_torch.ops import _build  # noqa: E402
from speech_tpu_torch.ops import stft_kernels as K  # noqa: E402


def card() -> str:
    """The GPU's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def build_variants(library: str, edits: dict) -> dict:
    """``{name: CDLL}``: ``library``'s own build as ``"kernel"`` and, for
    each ``name: [(old, new), ...]`` of ``edits``, its source with every
    ``old`` (which must occur once) replaced by ``new``, built in parallel
    into ``build/<library>_variants/``."""
    libs = {"kernel": _build.load_kernels()[library]}
    src = (_build.CSRC / f"{library}.cu").read_text()
    out = _build._build_dir().parent / f"{library}_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                sys.exit(f"{name}: the edit's target is not in the source once")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        )
    for name, proc in procs.items():
        if proc.wait() != 0:
            sys.exit(f"nvcc failed on the {name} variant")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def use(library: str, lib) -> None:
    """Route ``library``'s wrappers to ``lib`` from the next call on."""
    _build._libs[library] = lib
    K._launcher.cache_clear()


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``reps`` calls of ``fn``, by CUDA events,
    after one call that is not timed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
