"""The host's enqueue of the fused core (span `enqueue`), warm mean a
proof in ms, where the entry is `prove` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["enqueue"], entry="prove")
