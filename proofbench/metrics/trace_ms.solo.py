"""The mean of the `trace` span of `prove(timings=)` over the traced
window's proofs, in ms (each span waits for the device)."""


def read(run):
    spans = [s["trace"] for s in run.spans if "trace" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
