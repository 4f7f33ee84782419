"""The host's enqueue of a batch's fused core (span `enqueue`), warm mean a
proof in ms, where the entry is `prove_batch` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["enqueue"], entry="prove_batch")
