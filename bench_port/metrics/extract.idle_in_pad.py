"""The share of the traced window in which the card is idle (no kernel and
no copy, as ``Trace.busy_s`` counts) while the host is inside an
``extract.pad`` span (``ShardedExtractor`` padding a batch's rows), both on
``time.perf_counter``'s clock, in percent."""

from bench_port.trace import gaps, union_s


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None  # every cell launches kernels: a trace without them lost its records
    pads = [(a, b) for a, b in run.spans.of("extract.pad") if b > tr.lo and a < tr.hi]
    if not pads:
        return None  # a program that does not split its "dispatch" stage
    idle = gaps([(s, e) for s, e, _ in tr.ops], tr.lo, tr.hi)
    return 100.0 * sum(union_s(pads, g0, g1) for g0, g1 in idle) / tr.window_s
