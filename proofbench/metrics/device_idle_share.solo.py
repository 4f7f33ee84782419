"""1 − the union of device activity over the profiled stretch's wall time,
in %, where the entry is `prove` (a stretch whose kernel count equals the
launch counters, `devtrace.py`)."""


def read(run):
    st = run.stretch
    if run.mix["entry"] != "prove" or st is None:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
