"""Mean milliseconds a batch of the ``"pad"`` stage that ``ShardedExtractor``
nests in ``extract_iter``'s ``"dispatch"``: padding this process's rows of
the batch into a pinned host buffer (``ShardedExtractor._pad_rows``); the
spans that start in the window."""


def read(run):
    spans = run.spans.of("extract.pad", run.t0, run.t1)
    if not spans:
        return None  # a program that does not split its "dispatch" stage
    return sum(b - a for a, b in spans) / len(spans) * 1e3
