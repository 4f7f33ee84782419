"""The warm mean of the `witness` span a proof over the words the compiled
witness loop wrote a proof (counter ``witness.cells`` over the span's count:
rows × columns), in ns a word, where the entry is `prove` (``spans.py``).
None for a program without the counter."""

from proofbench import spans


def read(run):
    ms = spans.warm_ms(run, ["witness"], entry="prove")
    tot = spans.totals()
    if ms is None or not tot["counters"].get("witness.cells"):
        return None
    per_proof = tot["counters"]["witness.cells"] / tot["spans"]["witness"]["count"]
    return 1e6 * ms / per_proof
