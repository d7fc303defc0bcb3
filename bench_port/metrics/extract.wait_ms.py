"""Mean milliseconds a batch of the ``"wait"`` stage that ``ShardedExtractor``
nests in ``extract_iter``'s ``"collect"``: the host blocked on the card in
the readback (the pinned buffers, the queued copy to the host and the
stream's ``synchronize``); the spans that start in the window."""


def read(run):
    spans = run.spans.of("extract.wait", run.t0, run.t1)
    if not spans:
        return None  # a program that does not split its "collect" stage
    return sum(b - a for a, b in spans) / len(spans) * 1e3
