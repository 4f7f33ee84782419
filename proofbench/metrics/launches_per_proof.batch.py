"""The program's kernel launches (`ops.launch_counts()`) over the traced
window, over the proofs finished in it, where the entry is `prove_batch`."""


def read(run):
    if run.mix["entry"] != "prove_batch" or not run.proofs or not sum(run.launches.values()):
        return None
    return sum(run.launches.values()) / run.proofs
