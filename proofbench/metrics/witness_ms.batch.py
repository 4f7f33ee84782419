"""The witnesses of a batch on the host (span `witness`), warm mean a proof
in ms, where the entry is `prove_batch` (``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["witness"], entry="prove_batch")
