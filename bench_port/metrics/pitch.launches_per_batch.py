"""Compute kernels on the card inside the program's ``"extract.pitch"``
ranges in the traced window, over those ranges (one a batch)."""

from bench_port.trace_pitch import PITCH_RANGE, kernels_in


def read(run):
    inside = kernels_in(run.trace) if run.trace is not None else None
    if inside is None:
        return None  # no "extract.pitch" range on the card's timeline
    return len(inside) / len(run.trace.ranges[PITCH_RANGE])
