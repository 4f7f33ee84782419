"""`device_program_ms.solo`, reported under a name of its own: the same reader
(``metrics/device_program_ms.solo.py``) in the cells that list this name."""

from proofbench import run as bench_run


def read(run):
    return bench_run.reader("device_program_ms.solo")(run)
