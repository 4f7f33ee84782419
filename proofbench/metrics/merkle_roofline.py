"""The least time of one proof's leaf and node hashes, counted from the
statement's sizes (``yardstick/roofline.py`` `merkle_work`), over the
device time of the Merkle kernels (``kernels/``, layer "Merkle kernels")
a proof in the profiled stretch, in %."""

from proofbench.yardstick import roofline


def read(run):
    st = run.stretch
    if st is None:
        return None
    measured = st.layer_s(run.layers.get("Merkle kernels", [])) / st.proofs
    if measured <= 0:
        return None
    return 100.0 * roofline.bound_s(*roofline.merkle_work(run.statement)) / measured
