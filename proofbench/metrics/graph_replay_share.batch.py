"""The share of the fused core's calls that replayed a CUDA graph, in %,
over the run, where the entry is `prove_batch` (``graph_share.py``)."""

from proofbench import graph_share


def read(run):
    return graph_share.replay_share(run, "prove_batch")
