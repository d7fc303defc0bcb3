"""Mean milliseconds a batch of the ``"unpack"`` stage that
``ShardedExtractor`` nests in ``extract_iter``'s ``"collect"``: copying each
utterance's valid rows out of the pinned readback; the spans that start in
the window."""


def read(run):
    spans = run.spans.of("extract.unpack", run.t0, run.t1)
    if not spans:
        return None  # a program that does not split its "collect" stage
    return sum(b - a for a, b in spans) / len(spans) * 1e3
