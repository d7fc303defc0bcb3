"""Compute kernels on the card inside the program's ``"stream.pitch"``
ranges in the traced window (the ticks' and the closes' pitch work), over
the ``StreamPool.step`` ticks that lie wholly inside it, as the ranges
kept there do."""

from bench_port.trace_stream import kernels_within, ticks_within


def read(run):
    tr = run.trace
    inside = kernels_within(tr) if tr is not None else None
    if inside is None:
        return None  # no "stream.pitch" range on the card's timeline
    ticks = ticks_within(run.spans, tr)
    if not ticks:
        return None
    return len(inside) / len(ticks)
