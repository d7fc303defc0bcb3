"""Tracing and per-stage timing.

The counterpart of :mod:`speech_tpu.profiling`:

- :class:`StageTimer` -- wall-clock timers for host-visible pipeline stages
  (read, dispatch, collect, write) and the stages nested in them (pad,
  launch, wait, unpack), reportable as one summary line; under an active
  profiler it marks each stage in the profiler's trace.
- :func:`trace` -- context manager around :class:`torch.profiler.profile`
  that writes a Chrome trace (TensorBoard-loadable) of the enclosed region.

The CLI exposes these via ``--profile [DIR]``.
"""

import contextlib
import logging
import threading
import time

from collections import defaultdict
from typing import Optional

import torch

__all__ = ["StageTimer", "trace"]

logger = logging.getLogger("speech_tpu_torch.profiling")


class _Open:
    """A running stage on its thread's stack."""

    __slots__ = ("start", "child_s")

    def __init__(self, start):
        self.start, self.child_s = start, 0.0


class StageTimer:
    """Accumulate wall-clock time per named pipeline stage.

    Use as ``with timer.stage("read"): ...``.  Stages may nest; each thread
    keeps its own stack, so stages that run on other threads never count
    as a stage's children.  ``totals`` are each stage's seconds;
    ``summary()`` returns a one-line report whose total counts outermost
    stages only and which gives each parent's self time (its seconds
    outside the stages nested in it); ``report()`` logs it.

    While a ``torch.profiler`` session is active (:func:`trace`), each
    stage also opens a ``record_function`` range of its name, so the
    profiler's trace shows the host stages on its own clock above the
    card's kernels and copies.
    """

    def __init__(self):
        self._totals = defaultdict(float)
        self._self = defaultdict(float)
        self._counts = defaultdict(int)
        self._outer = 0.0
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        ranged = None
        if torch.autograd._profiler_enabled():
            ranged = torch.profiler.record_function(name)
            ranged.__enter__()
        frame = _Open(time.perf_counter())
        stack.append(frame)
        try:
            yield self
        finally:
            end = time.perf_counter()
            # the stage it opened in (a generator suspended in its stage
            # may close after stages opened later: not the stack's top)
            k = len(stack) - 1 if stack[-1] is frame else stack.index(frame)
            outer = stack[k - 1] if k else None
            del stack[k]
            if ranged is not None:
                ranged.__exit__(None, None, None)
            secs = end - frame.start
            with self._lock:
                self._totals[name] += secs
                self._self[name] += secs - frame.child_s
                self._counts[name] += 1
                if outer is not None:
                    outer.child_s += secs
                else:
                    self._outer += secs

    @property
    def totals(self) -> dict:
        """Seconds per stage."""
        return dict(self._totals)

    def summary(self) -> str:
        parts = []
        for name, secs in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            part = f"{name}: {secs:.3f}s/{self._counts[name]}x"
            if self._self[name] < secs:
                part += f" (self {self._self[name]:.3f}s)"
            parts.append(part)
        return f"stages ({self._outer:.3f}s total): " + ", ".join(parts)

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
