"""The least time of one proof's row leaves, counted from the statement's
sizes (``yardstick/roofline.py``: d leaves, each reading a row of w words
and writing a 32-byte digest, `leaf_ops(w)` ops each), over the device time
a proof of the spans whose name holds ``sha256_leaf_rows`` in the profiled
stretch, in %. None where no such span ran."""

from proofbench.yardstick import roofline

KERNEL = "sha256_leaf_rows"


def read(run):
    st = run.stretch
    if st is None:
        return None
    measured = st.layer_s([KERNEL]) / st.proofs
    if measured <= 0:
        return None
    d, w = run.statement.eval_domain, run.statement.width
    return 100.0 * roofline.bound_s(d * (4 * w + 32), d * roofline.leaf_ops(w)) / measured
