"""Mean milliseconds a batch of ``extract_iter``'s ``"dispatch"`` stage
(host padding into pinned memory, the queued copies and launches), from
the program's own stage split, over the window."""


def read(run):
    spans = run.spans.of("extract.dispatch", run.t0, run.t1)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
