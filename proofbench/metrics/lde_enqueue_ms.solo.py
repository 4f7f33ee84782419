"""The enqueue of the interpolation and the coset LDE (span `lde`), warm
mean a proof in ms, where the entry is `prove` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["lde"], entry="prove")
