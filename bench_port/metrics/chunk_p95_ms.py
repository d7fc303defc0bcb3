"""The 95th percentile of every chunk of the window, from its due time at
real-time pacing to the moment ``iter_results`` yields the rows it
completes; a chunk whose rows never came counts as a miss."""

from bench_port.common import percentile


def read(run):
    lat = run.values.get("chunk_latency_s")
    if not lat:
        return None
    return min(percentile(lat, 95) * 1e3, 1e300)
