"""The 95th percentile of every request of the window, from its due time
in the open-loop schedule to its future's result; a failed or refused
request counts as a miss."""

from bench_port.common import percentile


def read(run):
    lat = run.values.get("latency_s")
    if not lat:
        return None
    return min(percentile(lat, 95) * 1e3, 1e300)
