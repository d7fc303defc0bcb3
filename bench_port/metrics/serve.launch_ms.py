"""Mean host milliseconds of ``FeatureServer._launch`` a micro-batch
(padding the micro-batch and queuing its copies and launches), timed
around the call, over the window."""


def read(run):
    spans = run.spans.of("serve._launch", run.t0, run.t1)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
