"""Mean milliseconds a batch of the ``"launch"`` stage that
``ShardedExtractor`` nests in ``extract_iter``'s ``"dispatch"``: the queued
copies and launches of the padded rows (``ShardedExtractor._run_block``: the
pinned lengths, the non-blocking copies and ``compute_batch`` up to its
return); the spans that start in the window."""


def read(run):
    spans = run.spans.of("extract.launch", run.t0, run.t1)
    if not spans:
        return None  # a program that does not split its "dispatch" stage
    return sum(b - a for a, b in spans) / len(spans) * 1e3
