"""The program's own spans and counters (``zkstark_tpu_torch.tracing``),
read after a run by the per-layer metrics that rest on them. They hold the
whole process: the warm-up calls, the window and the profiled stretch after
it. A program without the tracer gives nothing to read (None); nothing
here raises for its lack."""

from __future__ import annotations


def totals() -> dict | None:
    """``tracing.totals()``, or None where the program has no tracer."""
    try:
        from zkstark_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.totals()


def warm_ms(run, names: list, own: bool = False, entry: str | None = None) -> float | None:
    """The warm mean a proof, in ms, of the spans `names` together (their
    self time where `own`): (total − the first call's part) / (root calls −
    1) / the batch, the root being the span of the mix's entry (``prove``
    or ``prove_batch``). None where `entry` is given and is not the mix's,
    or where a span is missing or the root ran fewer than twice."""
    if entry is not None and run.mix["entry"] != entry:
        return None
    tot = totals()
    if tot is None:
        return None
    spans = tot["spans"]
    root = spans.get(run.mix["entry"])
    if root is None or root["count"] < 2 or any(n not in spans for n in names):
        return None
    key, first = ("self_ns", "first_self_ns") if own else ("total_ns", "first_total_ns")
    ns = sum(spans[n][key] - spans[n][first] for n in names)
    return ns / 1e6 / (root["count"] - 1) / int(run.mix["batch"])
