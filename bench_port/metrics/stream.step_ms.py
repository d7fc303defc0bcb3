"""Mean host milliseconds of ``StreamPool.step`` a tick on the pool the
server holds (planning, the queued tick and its readback), timed around
the call, over the window."""


def read(run):
    spans = run.spans.of("stream.step", run.t0, run.t1)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
