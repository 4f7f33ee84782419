"""The readers of the program's spans and counters (``spans.py`` and the
metrics that rest on it): nothing to read gives None, and synthetic totals
give the warm mean computed by hand."""

import pytest

from proofbench import run as bench_run
from zkstark_tpu_torch import tracing

SOLO = {"entry": "prove", "batch": 1, "warmup_calls": 2}
BATCH = {"entry": "prove_batch", "batch": 32, "warmup_calls": 2}
NEW = ["enqueue_ms.solo", "merkle_enqueue_ms.solo", "lde_enqueue_ms.solo",
       "chain_enqueue_ms.solo", "fold_enqueue_ms.solo", "witness_ms.batch", "enqueue_ms.batch",
       "wait_ms.batch", "replay_decommit_ms.batch", "first_call_s", "cache_misses"]


def span(count, total, first, own=None, first_own=None):
    return {"count": count, "total_ns": total, "self_ns": total if own is None else own,
            "first_total_ns": first, "first_self_ns": first if first_own is None else first_own}


# 5 calls of prove: the first 3.0 ms, each warm one 1.0 ms of enqueue
SOLO_TOTALS = {"spans": {
    "prove": span(5, 3_000_000_000 + 4 * 6_000_000, 3_000_000_000),
    "library.build": span(1, 2_000_000_000, 2_000_000_000),
    "enqueue": span(5, 3_000_000 + 4 * 1_000_000, 3_000_000),
    "merkle": span(60, 12 * 500_000 + 48 * 40_000, 12 * 500_000),
    "lde": span(5, 900_000 + 4 * 100_000, 900_000),
    "chain": span(60, 12 * 50_000 + 48 * 25_000, 12 * 50_000),
    "fold": span(50, 10 * 300_000 + 40 * 60_000, 10 * 300_000,
                 own=10 * 100_000 + 40 * 20_000, first_own=10 * 100_000),
}, "counters": {"cache.miss.composition_constants": 1, "cache.miss.constants_system": 1,
                "cache.miss.composition_program": 1, "cache.miss._zero_state": 1,
                "cache.evict": 7}}

# 3 calls of prove_batch of 32; the two warm ones per proof: 0.5 ms witness,
# 0.25 ms enqueue, 0.125 ms wait, 0.5 ms replay and decommit
BATCH_TOTALS = {"spans": {
    "prove_batch": span(3, 900_000_000 + 2 * 32 * 1_500_000, 900_000_000),
    "witness": span(3, 20_000_000 + 2 * 32 * 500_000, 20_000_000),
    "enqueue": span(3, 800_000_000 + 2 * 32 * 250_000, 800_000_000),
    "wait": span(3, 1_000_000 + 2 * 32 * 125_000, 1_000_000),
    "replay": span(96, 9_000_000 + 64 * 300_000, 9_000_000),
    "decommit": span(96, 7_000_000 + 64 * 200_000, 7_000_000),
}, "counters": {"cache.miss._zero_state": 1}}

WANT = {
    "enqueue_ms.solo": (SOLO, SOLO_TOTALS, 1.0),
    "merkle_enqueue_ms.solo": (SOLO, SOLO_TOTALS, 12 * 0.04),
    "lde_enqueue_ms.solo": (SOLO, SOLO_TOTALS, 0.1),
    "chain_enqueue_ms.solo": (SOLO, SOLO_TOTALS, 12 * 0.025),
    "fold_enqueue_ms.solo": (SOLO, SOLO_TOTALS, 10 * 0.02),
    "witness_ms.batch": (BATCH, BATCH_TOTALS, 0.5),
    "enqueue_ms.batch": (BATCH, BATCH_TOTALS, 0.25),
    "wait_ms.batch": (BATCH, BATCH_TOTALS, 0.125),
    "replay_decommit_ms.batch": (BATCH, BATCH_TOTALS, 0.5),
    "first_call_s": (SOLO, SOLO_TOTALS, 1.0),
    "cache_misses": (SOLO, SOLO_TOTALS, 4),
}


def a_run(mix):
    return bench_run.Run(cell={}, statement=None, mix=mix)


def test_every_new_metric_is_in_the_benchmark():
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    assert set(NEW) <= {m["name"] for m in bench["per_layer"]}
    assert set(WANT) == set(NEW)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    read = bench_run.reader(name)
    monkeypatch.setattr(tracing, "totals", lambda: {"spans": {}, "counters": {}})
    assert read(a_run(SOLO)) is None and read(a_run(BATCH)) is None
    # a program without the tracer: the import fails
    monkeypatch.setitem(__import__("sys").modules, "zkstark_tpu_torch.tracing", None)
    monkeypatch.delattr("zkstark_tpu_torch.tracing", raising=False)
    assert read(a_run(SOLO)) is None and read(a_run(BATCH)) is None


@pytest.mark.parametrize("name", NEW)
def test_warm_mean_from_synthetic_totals(name, monkeypatch):
    mix, totals, want = WANT[name]
    monkeypatch.setattr(tracing, "totals", lambda: totals)
    assert bench_run.reader(name)(a_run(mix)) == pytest.approx(want, rel=1e-12)
    # a cell of the other entry reads nothing from these spans
    other = BATCH if mix is SOLO else SOLO
    if name not in ("first_call_s", "cache_misses"):
        assert bench_run.reader(name)(a_run(other)) is None
