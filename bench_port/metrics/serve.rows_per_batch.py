"""Requests completed over micro-batches dispatched in the window, from
``FeatureServer.stats`` (the program's counters)."""


def read(run):
    c = run.counters
    if not c.get("batches"):
        return None
    return c["completed"] / c["batches"]
