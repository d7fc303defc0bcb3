"""The traced window of a pitch cell: :class:`bench_port.trace.Tracer`'s
device intervals, and beside them the device intervals of the program's
``"extract.pitch"`` profiler ranges (the profiler lays each range that
launched kernels onto the card's timeline, from its first kernel's start
to its last one's end)."""

from torch.autograd import DeviceType

from .trace import ANCHOR, Tracer

__all__ = ["PITCH_RANGE", "PitchTracer", "kernels_in", "kernels_outside"]

PITCH_RANGE = "extract.pitch"


class PitchTracer(Tracer):
    """A :class:`~bench_port.trace.Tracer` whose :class:`Trace` also has
    ``ranges[PITCH_RANGE]``: the ``(start, end)`` device intervals of the
    program's ``"extract.pitch"`` ranges, on ``perf_counter`` seconds."""

    def stop(self):
        trace = super().stop()
        events = self._prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == ANCHOR)
        offsets = [h - m * 1e-6 for h, m in zip(self._anchors, marks)]
        off = sum(offsets) / len(offsets)
        trace.ranges = {PITCH_RANGE: sorted(
            (e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off)
            for e in events if e.name == PITCH_RANGE and e.device_type == DeviceType.CUDA)}
        return trace


def kernels_in(trace, name: str = PITCH_RANGE):
    """The compute kernels of ``trace`` that lie inside one of its device
    ranges ``name`` (None where the trace has no such ranges)."""
    return _split(trace, name, True)


def kernels_outside(trace, name: str = PITCH_RANGE):
    """The compute kernels of ``trace`` that lie inside none of its device
    ranges ``name`` (None where the trace has no such ranges)."""
    return _split(trace, name, False)


def _split(trace, name, inside):
    ranges = getattr(trace, "ranges", {}).get(name)
    if not ranges:
        return None
    return [(s, e, n) for s, e, n in trace.kernels
            if any(a <= s and e <= b for a, b in ranges) is inside]
