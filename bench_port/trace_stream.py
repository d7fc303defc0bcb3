"""The traced window of a stream cell: :class:`bench_port.trace.Tracer`'s
device intervals, with every thread profiled (``StreamServer`` launches
its ticks from its own loop thread, whose ranges a profiler started in
another thread does not see otherwise), and beside them the device
intervals of the program's ``"stream.pitch"`` profiler ranges."""

import bisect

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .trace import ANCHOR, Tracer

__all__ = ["STREAM_PITCH_RANGE", "StreamTracer", "kernels_within", "ticks_within"]

STREAM_PITCH_RANGE = "stream.pitch"


def _all_threads():
    """The profiler's option that records every thread's ranges (None on
    a PyTorch without it: the ranges are then missing, and the readers of
    them read nothing)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class StreamTracer(Tracer):
    """A :class:`~bench_port.trace.Tracer` over every thread whose
    :class:`Trace` also has ``ranges[STREAM_PITCH_RANGE]``: the ``(start,
    end)`` device intervals of the program's ``"stream.pitch"`` ranges, on
    ``perf_counter`` seconds."""

    def start(self):
        acts = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        config = _all_threads()
        kw = {} if config is None else {"experimental_config": config}
        self._prof = profile(activities=acts, **kw)
        self._prof.__enter__()
        self._anchor()
        return self._anchors[0]

    def stop(self):
        trace = super().stop()
        events = self._prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == ANCHOR)
        offsets = [h - m * 1e-6 for h, m in zip(self._anchors, marks)]
        off = sum(offsets) / len(offsets)
        # a range reaching out of the window holds a record without its
        # times (a start of 0 was seen), and would take in kernels of other
        # ranges
        ranges = ((e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off)
                  for e in events if e.name == STREAM_PITCH_RANGE and e.device_type == DeviceType.CUDA)
        trace.ranges = {STREAM_PITCH_RANGE: sorted(
            (a, b) for a, b in ranges if trace.lo <= a and b <= trace.hi)}
        return trace


def kernels_within(trace, name: str = STREAM_PITCH_RANGE):
    """The compute kernels of ``trace`` that lie inside one of its device
    ranges ``name`` (None where the trace has no such ranges), as
    :func:`bench_port.trace_pitch.kernels_in` finds them, by bisection: a
    stream's window holds tens of thousands of kernels."""
    ranges = getattr(trace, "ranges", {}).get(name)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    reach = []  # the furthest end of the ranges that start at or before each
    for _, b in ranges:
        reach.append(max(b, reach[-1]) if reach else b)
    out = []
    for s, e, n in trace.kernels:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and reach[k] >= e:
            out.append((s, e, n))
    return out


def ticks_within(spans, trace):
    """The ``"stream.step"`` ticks that lie wholly inside the traced window,
    as the ``"stream.pitch"`` ranges kept in it do (the kind holds the
    server's loop between two ticks while the profiler starts and stops, so
    none straddles an edge there; a tick cut by an edge would count without
    its pitch range)."""
    return [(a, b) for a, b in spans.of("stream.step", trace.lo, trace.hi) if b <= trace.hi]
