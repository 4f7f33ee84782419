"""The process's first call of the mix's entry (its root span: the kernel
library's load, cold constants, lazy module loads) less nvcc (span
`library.build`, absent where the library was built), in s (``spans.py``)."""

from proofbench import spans


def read(run):
    tot = spans.totals()
    root = tot and tot["spans"].get(run.mix["entry"])
    if not root:
        return None
    build = tot["spans"].get("library.build", {}).get("first_total_ns", 0)
    return (root["first_total_ns"] - build) / 1e9
