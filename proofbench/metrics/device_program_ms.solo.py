"""The mean of the `device_program` span of `prove(timings=)` over the traced
window's proofs, in ms (each span waits for the device)."""


def read(run):
    spans = [s["device_program"] for s in run.spans if "device_program" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
