"""The program's counters of its CUDA graph (``graph.capture``,
``graph.replay``, ``graph.eager``: one of the three a call of the fused
core), read after a run. A program without them gives nothing to read
(None); nothing here raises for their lack."""

from __future__ import annotations

from proofbench import spans

EVENTS = ("graph.replay", "graph.capture", "graph.eager")


def replay_share(run, entry: str) -> float | None:
    """graph.replay / (graph.replay + graph.capture + graph.eager) over the
    whole process, in %, where the mix's entry is `entry`; None elsewhere,
    without the tracer, or where no call of the core was counted."""
    if run.mix["entry"] != entry:
        return None
    tot = spans.totals()
    if tot is None:
        return None
    counts = [tot["counters"].get(k, 0) for k in EVENTS]
    if not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
