"""Misses of the per-statement caches (counters `cache.miss.*`) over the
run: one a cache for a run's one statement (``spans.py``)."""

from proofbench import spans


def read(run):
    tot = spans.totals()
    if tot is None or not tot["spans"]:
        return None
    return sum(n for k, n in tot["counters"].items() if k.startswith("cache.miss."))
