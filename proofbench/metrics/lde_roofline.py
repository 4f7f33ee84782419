"""The least time of one proof's inverse NTT of the trace and coset NTT,
counted from the statement's sizes (``yardstick/roofline.py`` `lde_work`),
over the device time of the LDE kernels (``kernels/``, layer "LDE kernels")
a proof in the profiled stretch, in %."""

from proofbench.yardstick import roofline


def read(run):
    st = run.stretch
    if st is None:
        return None
    measured = st.layer_s(run.layers.get("LDE kernels", [])) / st.proofs
    if measured <= 0:
        return None
    return 100.0 * roofline.bound_s(*roofline.lde_work(run.statement)) / measured
