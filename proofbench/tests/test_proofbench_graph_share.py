"""The readers of the program's CUDA-graph counters (``graph_share.py`` and
``metrics/graph_replay_share.*``): a replay share from synthetic counters,
and None where there is nothing to read (a program without the counters, as
before the graph, or without the tracer) or the entry is another cell's."""

import pytest

from proofbench import run as bench_run
from zkstark_tpu_torch import tracing

SOLO = {"entry": "prove", "batch": 1, "warmup_calls": 2}
BATCH = {"entry": "prove_batch", "batch": 32, "warmup_calls": 2}
NEW = {"graph_replay_share.solo": SOLO, "graph_replay_share.batch": BATCH}
# 2 warm-up calls (one eager, one capture), 998 replays
COUNTERS = {"graph.eager": 1, "graph.capture": 1, "graph.replay": 998, "graph.evict": 3,
            "cache.miss._zero_state": 1}


def a_run(mix):
    return bench_run.Run(cell={}, statement=None, mix=mix)


def totals(counters):
    return lambda: {"spans": {}, "counters": counters}


def test_every_new_metric_is_in_the_benchmark():
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    by_name = {m["name"]: m for m in bench["per_layer"]}
    assert by_name["graph_replay_share.solo"]["workloads"] == ["stark101.solo"]
    assert by_name["graph_replay_share.batch"]["workloads"] == ["stark101.batch32"]


@pytest.mark.parametrize("name", NEW)
def test_share_of_replayed_calls(name, monkeypatch):
    read, mix = bench_run.reader(name), NEW[name]
    monkeypatch.setattr(tracing, "totals", totals(COUNTERS))
    assert read(a_run(mix)) == pytest.approx(99.8)
    other = BATCH if mix is SOLO else SOLO
    assert read(a_run(other)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    read, mix = bench_run.reader(name), NEW[name]
    # the parent's program: a tracer without the graph's counters
    monkeypatch.setattr(tracing, "totals", totals({"cache.miss._zero_state": 1}))
    assert read(a_run(mix)) is None
    # a program without the tracer: the import fails
    monkeypatch.setitem(__import__("sys").modules, "zkstark_tpu_torch.tracing", None)
    monkeypatch.delattr("zkstark_tpu_torch.tracing", raising=False)
    assert read(a_run(mix)) is None
