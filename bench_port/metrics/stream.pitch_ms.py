"""Mean host milliseconds of the pitch share of a stream tick:
``StreamingAppendPitch._pitch_step`` (the tracker and the process-pitch
step, queued inside the program's ``"stream.pitch"`` range), timed around
the call, over the calls that start in the window."""


def read(run):
    spans = run.spans.of("stream.pitch", run.t0, run.t1)
    if not spans:
        return None  # a program whose streamer has no pitch share
    return sum(b - a for a, b in spans) / len(spans) * 1e3
