"""Mean milliseconds a request waited in ``FeatureServer``'s queue, from
its ``submit`` to the start of the first micro-batch launch that carries
it (the server's ``queue_wait_s`` counter over its ``completed``
requests), over the window."""


def read(run):
    c = run.counters
    if "queue_wait_s" not in c or not c.get("completed"):
        return None  # a program that does not count the queue's wait
    return 1e3 * c["queue_wait_s"] / c["completed"]
