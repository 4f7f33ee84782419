"""`replay_decommit_ms.solo`, reported under a name of its own: the same reader
(``metrics/replay_decommit_ms.solo.py``) in the cells that list this name."""

from proofbench import run as bench_run


def read(run):
    return bench_run.reader("replay_decommit_ms.solo")(run)
