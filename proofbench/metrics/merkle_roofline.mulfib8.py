"""`merkle_roofline`, reported under a name of its own: the same reader
(``metrics/merkle_roofline.py``) in the cells that list this name."""

from proofbench import run as bench_run


def read(run):
    return bench_run.reader("merkle_roofline")(run)
