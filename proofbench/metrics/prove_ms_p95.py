"""The 95th percentile of every proof's latency in the window, each from
its call to its bytes on the host."""

import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
