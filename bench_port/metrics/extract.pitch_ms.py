"""Mean milliseconds a batch of the ``"pitch"`` stage that
``ShardedExtractor(pitch=...)`` nests in ``extract_iter``'s ``"dispatch"``
after ``"launch"``: queuing the pitch tracker on the batch's device rows
and joining its three columns to the features (``_with_pitch``); the
spans that start in the window."""


def read(run):
    spans = run.spans.of("extract.pitch", run.t0, run.t1)
    if not spans:
        return None  # a program that tracks no pitch in the extractor
    return sum(b - a for a, b in spans) / len(spans) * 1e3
