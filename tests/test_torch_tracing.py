"""The port's tracer (``zkstark_tpu_torch/tracing.py``): the spans each
entry point records, their self times, the per-statement caches' miss
counters, and the profiler annotations, on the CPU. One stark-101 prove for
the file; the rest on a 7-step statement."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, prove, prove_pipelined
from zkstark_tpu_torch.protocol import fused
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.batch import prove_batch
from zkstark_tpu_torch.protocol.config import StarkConfig

GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
GOLDEN_LEN = 7836
SECRET = 31415


def small(blowup: int = 4) -> StarkConfig:
    """A 7-step FibonacciSq statement (FRI rounds: log2 of 8·blowup − 2)."""
    p = STARK101.field.p
    last = int(STARK101.air.trace(7, SECRET, p)[-1])
    return StarkConfig(trace_len=7, blowup=blowup, boundary_last=last)


def per_proof(rounds: int) -> dict:
    """The spans of one fused proof's device program: its trees, chain steps
    and folds (``tracing.py``'s table)."""
    return {"enqueue": 1, "lde": 1, "merkle": 2 + rounds, "chain": 2 + rounds, "fold": rounds}


def counts() -> dict:
    return {k: v["count"] for k, v in tracing.totals()["spans"].items() if k != "cache.build"}


@pytest.fixture(scope="module")
def stark101():
    """One stark-101 prove with the annotations on: its proof and totals."""
    tracing.reset()
    with tracing.annotate():
        proof = prove(STARK101, STARK101_SECRET, device="cpu")
    return proof, tracing.totals()


def test_stark101_bytes_with_annotations(stark101):
    proof, _ = stark101
    assert len(proof.data) == GOLDEN_LEN
    assert proof.state.hex() == GOLDEN_STATE


def test_stark101_span_counts(stark101):
    _, tot = stark101
    got = {k: v["count"] for k, v in tot["spans"].items() if k != "cache.build"}
    assert got == {"prove": 1, "witness": 1, "upload": 1, "fetch": 1, "wait": 1, "replay": 1,
                   "decommit": 1, **per_proof(STARK101.fri_rounds)}
    assert got["merkle"] == got["chain"] == 12 and got["fold"] == 10


def test_self_times_add_up(stark101):
    spans = stark101[1]["spans"]
    for name, s in spans.items():
        assert 0 <= s["self_ns"] <= s["total_ns"], name
        assert s["first_self_ns"] <= s["first_total_ns"] <= s["total_ns"], name
    root = spans["prove"]
    children = ("witness", "upload", "enqueue", "fetch", "replay", "decommit")
    assert root["self_ns"] + sum(spans[c]["total_ns"] for c in children) == root["total_ns"]
    # each nanosecond of the root lies in exactly one span's self time
    assert sum(s["self_ns"] for s in spans.values()) == root["total_ns"]
    # one root call: all of it is the first
    assert all(s["first_total_ns"] == s["total_ns"] for s in spans.values())


@pytest.mark.parametrize("entry", ["prove_batch", "prove_pipelined"])
def test_span_counts_of_two_proofs(entry):
    cfg = small()
    fused._zero_state.cache_clear()
    tracing.reset()
    if entry == "prove_batch":
        prove_batch(cfg, [SECRET, SECRET], device="cpu")
        # one witness, upload, program and wait for the batch; the host work a proof
        want = {"witness": 1, "upload": 1, "wait": 1, **per_proof(cfg.fri_rounds)}
    else:
        prove_pipelined(cfg, [SECRET, SECRET], device="cpu")
        want = {"witness": 2, "upload": 2, "wait": 2,
                **{k: 2 * v for k, v in per_proof(cfg.fri_rounds).items()}}
    # no `sync`: without timings the prover never waits between its steps
    assert counts() == {entry: 1, "replay": 2, "decommit": 2, **want}
    # a batch size (B = 2 or 1) not seen since the cache was cleared: one new zero state
    assert tracing.totals()["counters"]["cache.miss._zero_state"] == 1


def test_timings_and_the_first_call():
    cfg = small()
    tracing.reset()
    prove(cfg, SECRET, device="cpu")
    timings = {}
    prove(cfg, SECRET, device="cpu", timings=timings)
    spans = tracing.totals()["spans"]
    # the first call is kept apart: all of its trees, not its first tree
    for name in ("prove", "merkle", "enqueue", "decommit"):
        assert 0 < spans[name]["first_total_ns"] < spans[name]["total_ns"], name
    trees = per_proof(cfg.fri_rounds)["merkle"]
    assert spans["merkle"]["first_total_ns"] > spans["merkle"]["total_ns"] // 2 // trees
    # timings: the second call's spans, each with a wait for the device
    assert sorted(timings) == ["device_program", "fetch", "replay_decommit", "trace"]
    assert spans["sync"]["count"] == 4
    ns = tracing.last_ns
    assert timings["device_program"] >= ns("enqueue") * 1e-9
    assert timings["replay_decommit"] >= (ns("replay") + ns("decommit")) * 1e-9
    assert sum(timings.values()) == pytest.approx(
        (ns("witness") + ns("upload") + ns("enqueue") + ns("fetch") + ns("replay")
         + ns("decommit") + spans["sync"]["total_ns"]) * 1e-9)


def cache_counters() -> dict:
    """The caches' counters (a CPU call of the fused core also counts
    ``graph.eager``)."""
    return {k: n for k, n in tracing.totals()["counters"].items() if k.startswith("cache.")}


def test_cache_misses_count_new_statements(monkeypatch):
    cpu = torch.device("cpu")
    cfg, other = small(4), small(8)
    pr.composition_constants(cfg, cpu)  # cfg's caches filled
    pr.composition_program(cfg)
    pr.decommit_layout(cfg)
    fused._zero_state(1, cpu)
    tracing.reset()
    prove(cfg, SECRET, device="cpu")
    assert not cache_counters()
    assert "cache.build" not in tracing.totals()["spans"]
    pr.composition_constants.cache_clear()
    pr.composition_program.cache_clear()
    pr.decommit_layout.cache_clear()
    prove(other, SECRET, device="cpu")
    pr.composition_constants(other, cpu)
    pr.composition_program(other)
    pr.decommit_layout(other)
    misses = cache_counters()
    assert misses == {"cache.miss.composition_constants": 1, "cache.miss.composition_program": 1,
                      "cache.miss.decommit_layout": 1}
    assert tracing.totals()["spans"]["cache.build"]["count"] == 3
    # the CPU takes its constants from host numpy: the card's system is built on demand
    pr.constants_system.cache_clear()
    pr.constants_system(other)
    pr.constants_system(other)
    assert tracing.totals()["counters"]["cache.miss.constants_system"] == 1
    # one byte of room: every new statement evicts the one before
    monkeypatch.setattr(pr, "_CONST_CACHE_BYTES", 1)
    pr.composition_constants(cfg, cpu)
    pr.composition_constants(other, cpu)
    assert tracing.totals()["counters"]["cache.evict"] == 2


def test_annotations_nest_under_the_profiler():
    """The mechanism; tests/test_torch_cli.py holds a whole prove's trace."""

    def nest():
        with tracing.span("prove"):
            with tracing.span("enqueue"):
                for _ in range(2):
                    with tracing.span("merkle"):
                        torch.ones(4).add_(1)
            with tracing.span("replay"):
                pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate():
            nest()
        nest()  # annotations off again: nothing on the profiler
    events = {}
    for e in prof.events():
        events.setdefault(e.name.split("#")[0], []).append(e)
    assert [len(events.get(n, [])) for n in ("prove", "enqueue", "merkle", "replay")] == [1, 1, 2, 1]
    root = events["prove"][0]
    assert root.name == f"prove#{root.name.split('#')[1]}" and int(root.name.split("#")[1]) > 0

    def within(e, outer):
        return outer.time_range.start <= e.time_range.start <= e.time_range.end \
            <= outer.time_range.end

    assert within(events["enqueue"][0], root) and within(events["replay"][0], root)
    assert all(within(e, events["enqueue"][0]) for e in events["merkle"])
    assert not within(events["replay"][0], events["enqueue"][0])


def test_reset_clears_totals():
    with tracing.span("prove"):
        with tracing.span("enqueue"):
            pass
    tracing.count("cache.evict")
    assert tracing.totals()["spans"]["enqueue"]["count"] >= 1
    tracing.reset()
    assert tracing.totals() == {"spans": {}, "counters": {}}
    assert tracing.last_ns("prove") == 0
