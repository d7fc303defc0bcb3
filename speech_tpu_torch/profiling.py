"""Tracing and per-stage timing.

The counterpart of :mod:`speech_tpu.profiling`:

- :class:`StageTimer` -- wall-clock timers for host-visible pipeline stages
  (read, dispatch, collect, write), reportable as one summary line (a copy).
- :func:`trace` -- context manager around :class:`torch.profiler.profile`
  that writes a Chrome trace (TensorBoard-loadable) of the enclosed region.

The CLI exposes these via ``--profile [DIR]``.
"""

import contextlib
import logging
import time

from collections import defaultdict
from typing import Optional

import torch

__all__ = ["StageTimer", "trace"]

logger = logging.getLogger("speech_tpu_torch.profiling")


class StageTimer:
    """Accumulate wall-clock time per named pipeline stage.

    Use as ``with timer.stage("read"): ...``; ``summary()`` returns a
    one-line report, ``report()`` logs it.
    """

    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield self
        finally:
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    @property
    def totals(self) -> dict:
        """Seconds per stage."""
        return dict(self._totals)

    def summary(self) -> str:
        total = sum(self._totals.values())
        parts = [
            f"{name}: {secs:.3f}s/{self._counts[name]}x"
            for name, secs in sorted(
                self._totals.items(), key=lambda kv: -kv[1]
            )
        ]
        return f"stages ({total:.3f}s total): " + ", ".join(parts)

    def report(self, level: int = logging.INFO) -> None:
        if self._totals:
            logger.log(level, self.summary())


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a trace of the enclosed region into ``log_dir``: one
    ``<host>_<pid>.<n>.pt.trace.json`` Chrome trace, with the card's
    kernels and copies where a GPU is available and the host's operators
    only otherwise.

    No-op when ``log_dir`` is None or empty.
    """
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # Only profiler setup/teardown is guarded; exceptions raised by the
    # traced body itself must propagate untouched (a guarded second yield
    # would turn them into a RuntimeError from contextlib).
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    try:
        prof.__enter__()
    except RuntimeError as e:  # pragma: no cover - profiler quirks
        logger.warning("device trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except (RuntimeError, OSError) as e:  # pragma: no cover
                logger.warning("device trace teardown failed: %s", e)
