"""The enqueue of the Fiat-Shamir chain steps (span `chain`, 12 a stark-101
proof), warm mean a proof in ms, where the entry is `prove` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["chain"], entry="prove")
