"""The mean of the `replay_decommit` span of `prove(timings=)` over the traced
window's proofs, in ms (each span waits for the device)."""


def read(run):
    spans = [s["replay_decommit"] for s in run.spans if "replay_decommit" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
