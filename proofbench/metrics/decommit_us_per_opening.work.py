"""The warm mean of the `decommit` span a proof over the openings it
serialized (counter ``decommit.openings`` over the span's count: every proof
of a run's statement opens as many), in µs an opening, where the entry is
`prove` (``spans.py``). None for a program without the counter."""

from proofbench import spans


def read(run):
    ms = spans.warm_ms(run, ["decommit"], entry="prove")
    tot = spans.totals()
    if ms is None or not tot["counters"].get("decommit.openings"):
        return None
    per_proof = tot["counters"]["decommit.openings"] / tot["spans"]["decommit"]["count"]
    return 1e3 * ms / per_proof
