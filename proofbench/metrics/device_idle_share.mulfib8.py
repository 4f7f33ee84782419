"""`device_idle_share.solo`, reported under a name of its own: the same reader
(``metrics/device_idle_share.solo.py``) in the cells that list this name."""

from proofbench import run as bench_run


def read(run):
    return bench_run.reader("device_idle_share.solo")(run)
