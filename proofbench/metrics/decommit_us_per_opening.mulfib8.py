"""`decommit_us_per_opening.work`, reported under a name of its own: the same
reader (``metrics/decommit_us_per_opening.work.py``) in the cells that list
this name."""

from proofbench import run as bench_run


def read(run):
    return bench_run.reader("decommit_us_per_opening.work")(run)
