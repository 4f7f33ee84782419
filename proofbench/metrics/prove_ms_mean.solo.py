"""The window's length over the proofs finished in it, one caller waiting
for each (closed loop), in ms: the mean a proof. Read in a traced run, so
each proof's spans wait for the device."""


def read(run):
    return 1e3 * run.window_s / run.proofs if run.proofs else None
