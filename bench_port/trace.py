"""The traced window: ``torch.profiler`` over part of a run, reduced to
device intervals on the host's clock.

The profiler's own clock is tied to ``time.perf_counter`` by two anchor
events that the tracing thread records at the start and at the end, so
that the host spans of the benchmark (taken in any thread) can label the
device's idle gaps.  Copies (``Memcpy``/``Memset``) count as busy time
but not as compute kernels.
"""

import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["Trace", "Tracer", "union_s"]

ANCHOR = "bench_port.anchor"


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def union_s(intervals, lo, hi):
    """Seconds of ``[lo, hi]`` that the ``(start, end)`` intervals cover."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """Device activity of a traced window, on ``perf_counter`` seconds.

    ``lo``/``hi``: the window; ``ops``: ``(start, end, name)`` of every
    device operation in it (kernels and copies)."""

    def __init__(self, lo, hi, ops):
        self.lo, self.hi, self.ops = lo, hi, ops

    @property
    def window_s(self):
        return self.hi - self.lo

    @property
    def busy_s(self):
        return union_s([(s, e) for s, e, _ in self.ops], self.lo, self.hi)

    @property
    def kernels(self):
        return [(s, e, n) for s, e, n in self.ops if not _is_copy(n)]

    @property
    def kernel_s(self):
        """Summed device seconds of the compute kernels (no copies)."""
        return sum(max(0.0, min(e, self.hi) - max(s, self.lo)) for s, e, _ in self.kernels)

    def top_ops(self, n=10):
        by = {}
        for s, e, name in self.ops:
            d = min(e, self.hi) - max(s, self.lo)
            if d > 0:
                by[name[:80]] = by.get(name[:80], 0.0) + d
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, spans, names, n=10):
        """The device's idle seconds, each gap named by the host span of
        ``names`` that overlaps it most (``"none"`` where none does),
        summed by name, longest first."""
        intervals = [(s, e) for s, e, _ in self.ops]
        host = [(name, a, b) for name, a, b in spans.items if name in names]
        by = {}
        for g0, g1 in gaps(intervals, self.lo, self.hi):
            best, label = 0.0, "none"
            for name, a, b in host:
                o = min(b, g1) - max(a, g0)
                if o > best:
                    best, label = o, name
            by[label] = by.get(label, 0.0) + (g1 - g0)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Tracer:
    """Start and stop the profiler from one thread; :meth:`stop` returns
    the :class:`Trace` (the card synchronised first, so that every queued
    operation has ended)."""

    def __init__(self, device):
        self._device = device
        self._prof = None
        self._anchors = []
        # the first profiler of a process takes a second or more to start
        # (CUPTI and the profiler's own set-up): pay it here, in set-up
        self.start()
        if device.type == "cuda":
            torch.ones(1, device=device).add_(1)
        self.stop()
        self._anchors = []

    def _anchor(self):
        t0 = time.perf_counter()
        with record_function(ANCHOR):
            pass
        self._anchors.append(t0)

    def start(self):
        acts = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._anchor()
        return self._anchors[0]

    def stop(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._anchor()
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == ANCHOR)
        # profiler microseconds -> perf_counter seconds
        offsets = [h - m * 1e-6 for h, m in zip(self._anchors, marks)]
        off = sum(offsets) / len(offsets)
        # device operations only: a collective's annotation on the device's
        # timeline (``nccl:all_gather...``) spans its kernel a second time
        ops = [(e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off, e.name)
               for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        return Trace(self._anchors[0], self._anchors[-1], ops)
