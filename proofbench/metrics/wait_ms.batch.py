"""The host's wait for a batch's packed result (span `wait`), warm mean a
proof in ms, where the entry is `prove_batch` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["wait"], entry="prove_batch")
