"""Kernels on the card in the traced window over the ``StreamPool.step``
ticks that began in it."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None  # a trace that lost the device's kernel records says nothing
    ticks = run.spans.of("stream.step", tr.lo, tr.hi)
    if not ticks:
        return None
    return len(tr.kernels) / len(ticks)
