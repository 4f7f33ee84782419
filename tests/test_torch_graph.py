"""The policy around the fused core's CUDA graph (``protocol/graph.py``) and
the device tables a capture reads (``ops/tables.py``), on the CPU: which
calls run eagerly, capture or replay, the key, the size rule, the bound on
the graphs, the drop of a config's graphs with its constants, and a replay's
copies and launch counts. A stand-in capture and stand-in CUDA tensors (an
object with a CUDA device and a shape) take the card's place; the capture
itself runs in ``tests/test_torch_cuda_graph.py`` on the card."""

import threading
from types import SimpleNamespace

import pytest
import torch

from zkstark_tpu_torch import ops, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ops import ntt_kernel, tables
from zkstark_tpu_torch.protocol import STARK101, fused, graph
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig

CUDA0 = torch.device("cuda", 0)


def on_card(bsz: int, trace_len: int = STARK101.trace_len, device=CUDA0):
    """A stand-in for a (B, trace_len) trace tensor on a card."""
    return SimpleNamespace(device=device, shape=(bsz, trace_len))


def small(trace_len: int) -> StarkConfig:
    return StarkConfig(trace_len=trace_len, boundary_last=1)


class Recorder:
    """A core and a capture that record their calls; a captured "graph"
    replays by returning its key's tag."""

    def __init__(self, cold: int = 0):
        self.core_calls, self.captures, self.replays = [], [], []
        self.cold = cold  # captures that find a cold table first

    def core(self, cfg, traces, mesh):
        self.core_calls.append((cfg, traces.shape[0], mesh))
        return "eager"

    def capture(self, core, cfg, traces):
        if self.cold:
            self.cold -= 1
            raise tables.ColdTable("stand-in")
        self.captures.append((cfg, traces.shape[0]))
        return SimpleNamespace(replay=lambda t: self.replays.append(t) or "replayed")


def graph_counters() -> dict:
    return {k: n for k, n in tracing.totals()["counters"].items() if k.startswith("graph.")}


@pytest.fixture
def rec():
    tracing.reset()
    return Recorder()


def test_cpu_and_mesh_calls_never_capture(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    cpu = torch.zeros((1, STARK101.trace_len), dtype=torch.uint32)
    for _ in range(3):
        assert graphs(STARK101, cpu) == "eager"
        assert graphs(STARK101, on_card(1), mesh=object()) == "eager"
    assert rec.captures == [] and graphs.keys() == []
    assert len(rec.core_calls) == 6
    assert graph_counters() == {"graph.eager": 6}


def test_first_call_eager_second_captures_then_replays(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    got = [graphs(STARK101, on_card(1)) for _ in range(4)]
    # the capture's call replays for its result
    assert got == ["eager", "replayed", "replayed", "replayed"]
    assert len(rec.core_calls) == 1 and rec.captures == [(STARK101, 1)]
    assert len(rec.replays) == 3
    assert graph_counters() == {"graph.eager": 1, "graph.capture": 1, "graph.replay": 2}


def test_key_holds_config_batch_device_and_route(monkeypatch):
    monkeypatch.delenv("ZKSTARK_PEASE", raising=False)
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    key = graph.graph_key(STARK101, on_card(1), None)
    assert key == (STARK101, 1, CUDA0, False, False)
    others = [
        graph.graph_key(small(63), on_card(1, 63), None),
        graph.graph_key(STARK101, on_card(2), None),
        graph.graph_key(STARK101, on_card(1, device=torch.device("cuda", 1)), None),
    ]
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    others.append(graph.graph_key(STARK101, on_card(1), None))
    monkeypatch.delenv("ZKSTARK_PEASE")
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    others.append(graph.graph_key(STARK101, on_card(1), None))
    assert len({key, *others}) == 1 + len(others)


def test_keys_are_captured_apart(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    for bsz in (1, 2, 1, 2, 1, 2):
        graphs(STARK101, on_card(bsz))
    assert rec.captures == [(STARK101, 1), (STARK101, 2)]
    assert graph_counters() == {"graph.eager": 2, "graph.capture": 2, "graph.replay": 2}


def test_size_rule():
    """Eager from GRAPH_POINTS points × B up: at stark-101's 8,192 points,
    B = 127 takes a graph and B = 128 does not."""
    assert STARK101.eval_domain * 128 == graph.GRAPH_POINTS
    assert graph.graph_key(STARK101, on_card(127), None) is not None
    assert graph.graph_key(STARK101, on_card(128), None) is None
    big = StarkConfig(trace_len=(1 << 17) - 1, boundary_last=1)  # 2^20 points
    assert big.eval_domain == graph.GRAPH_POINTS
    assert graph.graph_key(big, on_card(1, big.trace_len), None) is None


def test_large_calls_stay_eager(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    for _ in range(3):
        graphs(STARK101, on_card(128))
    assert rec.captures == [] and len(rec.core_calls) == 3
    assert graph_counters() == {"graph.eager": 3}


def test_lru_bound_and_evict(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture, max_graphs=2)
    for bsz in (1, 2, 3):
        graphs(STARK101, on_card(bsz))
        graphs(STARK101, on_card(bsz))
    key = lambda bsz: graph.graph_key(STARK101, on_card(bsz), None)  # noqa: E731
    assert graphs.keys() == [key(2), key(3)]
    assert graph_counters()["graph.evict"] == 1
    graphs(STARK101, on_card(2))  # a replay makes B = 2 the most recent
    assert graphs.keys() == [key(3), key(2)]
    # B = 1 was seen: its next call captures again, and B = 3 goes
    graphs(STARK101, on_card(1))
    assert graphs.keys() == [key(2), key(1)]
    assert rec.captures == [(STARK101, b) for b in (1, 2, 3, 1)]
    assert graph_counters()["graph.evict"] == 2


def test_cold_table_abandons_the_capture(rec):
    """A capture that meets a cold table runs the call eagerly; the next
    call captures."""
    rec.cold = 1
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    got = [graphs(STARK101, on_card(1)) for _ in range(4)]
    assert got == ["eager", "eager", "replayed", "replayed"]
    assert len(rec.core_calls) == 2
    assert graph_counters() == {"graph.eager": 2, "graph.capture": 1, "graph.replay": 1}


def test_drop_takes_one_configs_graphs(rec):
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    other = small(63)
    for cfg, t in ((STARK101, on_card(1)), (STARK101, on_card(2)), (other, on_card(1, 63))):
        graphs(cfg, t)
        graphs(cfg, t)
    graphs.drop(STARK101)
    assert [k[0] for k in graphs.keys()] == [other]
    assert graph_counters()["graph.evict"] == 2


def test_constants_leaving_their_cache_drop_the_graphs(rec, monkeypatch):
    """`composition_constants.cache_clear()` and an eviction of a config's
    constants drop that config's graphs (the fused core's own `_GRAPHS`)."""
    graphs = graph.CoreGraphs(rec.core, rec.capture)
    monkeypatch.setattr(fused, "_GRAPHS", graphs)
    cpu = torch.device("cpu")
    a, b = small(7), small(15)
    for cfg in (a, b):
        graphs(cfg, on_card(1, cfg.trace_len))
        graphs(cfg, on_card(1, cfg.trace_len))
    pr.composition_constants.cache_clear()
    pr.composition_constants(a, cpu)
    pr.composition_constants.cache_clear()
    assert [k[0] for k in graphs.keys()] == [b]
    # one byte of room: b's constants evict a's, and then a's evict b's
    monkeypatch.setattr(pr, "_CONST_CACHE_BYTES", 1)
    pr.composition_constants(b, cpu)
    assert [k[0] for k in graphs.keys()] == [b]
    pr.composition_constants(a, cpu)
    assert graphs.keys() == []
    assert graph_counters()["graph.evict"] == 2
    pr.composition_constants.cache_clear()


def test_recording_refuses_cold_tables_and_keeps_warm_ones():
    cpu = torch.device("cpu")
    cfg = small(7)
    ntt_kernel._geo_tables.cache_clear()
    warm = ntt_kernel._geo_tables(5, 64, cfg.field, cpu)
    inv = pr.composition_constants(cfg, cpu)
    zero = fused._zero_state(3, cpu)
    pr.composition_constants.cache_clear()
    with tables.recording() as read:
        assert ntt_kernel._geo_tables(5, 64, cfg.field, cpu) is warm
        assert fused._zero_state(3, cpu) is zero
        with pytest.raises(tables.ColdTable):
            ntt_kernel._geo_tables(5, 128, cfg.field, cpu)
        with pytest.raises(tables.ColdTable):
            pr.composition_constants(cfg, cpu)
        with pytest.raises(RuntimeError):
            with tables.recording():
                pass
    assert read == [warm, zero]
    # nothing cold was built or cached; outside a recording the caches build
    assert ntt_kernel._geo_tables.cache_info().currsize == 1
    assert pr.composition_constants(cfg, cpu).equal(inv)
    with tables.recording() as read:
        assert pr.composition_constants(cfg, cpu) is read[0]
    assert tables._state.reads is None
    pr.composition_constants.cache_clear()


def test_recording_is_one_threads():
    """Another thread's lookups during a capture's recording build and are
    not recorded: the capture records its own thread's launches."""
    cpu = torch.device("cpu")
    field = small(7).field
    got = []
    with tables.recording() as read:
        t = threading.Thread(target=lambda: got.append(ntt_kernel._geo_tables(7, 256, field, cpu)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(got) == 1 and read == []


def test_replay_copies_in_and_out_and_counts_launches():
    """`CudaGraph.replay` with a stand-in graph: the trace goes into the
    static input, the result is a copy of the static output (a later replay
    leaves it alone), and the launches of one replay are counted."""
    static_in = torch.zeros((1, 4), dtype=torch.int32)
    static_out = torch.zeros(3, dtype=torch.int32)

    def run():  # the "graph": output = sum of the input
        static_out.fill_(int(static_in.sum()))

    g = graph.CudaGraph(SimpleNamespace(replay=run), static_in, static_out,
                        {"fs_chain": 12, "sha256_tree_tail": 12}, [])
    before = ops.launch_counts()
    first = g.replay(fp.as_u32(torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)))
    second = g.replay(fp.as_u32(torch.tensor([[5, 5, 5, 5]], dtype=torch.int32)))
    assert first.dtype == torch.uint32 and fp.as_i32(first).tolist() == [10] * 3
    assert fp.as_i32(second).tolist() == [20] * 3
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "fs_chain": 24, "sha256_tree_tail": 24}
    ops.add_launch_counts({"fs_chain": -24, "sha256_tree_tail": -24})
