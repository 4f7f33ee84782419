"""The enqueue of the FRI folds less their trees (span `fold`, self time;
10 a stark-101 proof), warm mean a proof in ms, where the entry is `prove`
(``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["fold"], own=True, entry="prove")
