"""The host replays and decommits of a batch (spans `replay` and
`decommit`), warm mean a proof in ms, where the entry is `prove_batch`
(``spans.py``)."""

from proofbench import spans


def read(run):
    return spans.warm_ms(run, ["replay", "decommit"], entry="prove_batch")
