"""The fused core's CUDA graph (``protocol/graph.py``) on the card: replayed
proofs equal eager ones byte for byte, solo, batched and pipelined with
results in flight, across configs, after the constants leave their cache
and after an eviction; a held result is never overwritten; a replay makes
no call that waits; and under torch.profiler the kernels of replayed calls
are the launch counters' count.

Marked `cuda`: without a CUDA device every test here skips. The file imports
no JAX:

    python -m pytest tests/test_torch_cuda_graph.py --noconftest -q

Each test proves through a graph cache of its own (`fresh`), so that which
call is eager, captured or replayed does not depend on the tests before it.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkstark_tpu_torch import ops, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.protocol import STARK101, fused, graph, prove, prove_pipelined
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.air import AIRS
from zkstark_tpu_torch.protocol.batch import fused_core_batch, prove_batch, prove_batch_pipelined
from zkstark_tpu_torch.protocol.config import StarkConfig

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
S = 3141592  # s and p − s: the two witnesses of one public output
P_S = STARK101.field.p - S


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch, dev):
    """A graph cache of the test's own in place of the fused core's; the
    graph counters start from zero."""
    graphs = graph.CoreGraphs(fused._core)
    monkeypatch.setattr(fused, "_GRAPHS", graphs)
    tracing.reset()
    return graphs


@pytest.fixture(scope="module")
def want(dev):
    """The host-synced proof on the card of each (config, secret): no graph
    carries that path."""
    got = {}

    def proof(cfg, secret):
        if (cfg, secret) not in got:
            got[cfg, secret] = prove(cfg, secret, device=dev, fused=False)
        return got[cfg, secret]

    return proof


def small() -> StarkConfig:
    air = AIRS["square-chain"]
    return StarkConfig(trace_len=255, air=air, boundary_last=int(air.trace(255, 271828)[-1]))


def counters() -> dict:
    return {k: n for k, n in tracing.totals()["counters"].items() if k.startswith("graph.")}


def test_replayed_proofs_equal_eager_ones(fresh, want, dev):
    got = [prove(STARK101, s, device=dev) for s in (S, P_S, S, P_S, S)]
    assert got == [want(STARK101, s) for s in (S, P_S, S, P_S, S)]
    assert counters() == {"graph.eager": 1, "graph.capture": 1, "graph.replay": 3}


def test_replayed_batches_equal_eager_ones(fresh, want, dev):
    secrets = [S, P_S] * 16
    for _ in range(4):
        assert prove_batch(STARK101, secrets, device=dev) == [want(STARK101, s) for s in secrets]
    assert counters() == {"graph.eager": 1, "graph.capture": 1, "graph.replay": 2}


def test_pipelined_with_results_in_flight(fresh, want, dev):
    secrets = [S, P_S] * 4
    assert prove_pipelined(STARK101, secrets, depth=2, device=dev) == \
        [want(STARK101, s) for s in secrets]
    batches = [[S, P_S, S], [P_S, P_S, S], [S, S, S], [P_S, S, P_S]]
    got = prove_batch_pipelined(STARK101, batches, depth=2, device=dev)
    assert got == [want(STARK101, s) for b in batches for s in b]
    assert counters()["graph.replay"] == (8 - 2) + (4 - 2)


def test_two_configs_interleaved(fresh, want, dev):
    other = small()
    for _ in range(4):
        assert prove(STARK101, S, device=dev) == want(STARK101, S)
        assert prove(other, 271828, device=dev) == want(other, 271828)
    assert {k[0] for k in fresh.keys()} == {STARK101, other}
    assert counters() == {"graph.eager": 2, "graph.capture": 2, "graph.replay": 4}


def test_after_cache_clear_and_eviction(monkeypatch, want, dev):
    graphs = graph.CoreGraphs(fused._core, max_graphs=1)
    monkeypatch.setattr(fused, "_GRAPHS", graphs)
    other = small()
    for cfg, s in ((STARK101, S), (STARK101, S), (other, 271828), (other, 271828)):
        assert prove(cfg, s, device=dev) == want(cfg, s)
    assert [k[0] for k in graphs.keys()] == [other]  # the bound of one evicted stark-101's
    pr.composition_constants.cache_clear()
    assert graphs.keys() == []
    # the constants are cold: the capture is abandoned, the call eager; then capture, replay
    tracing.reset()
    for s in (S, P_S, S):
        assert prove(STARK101, s, device=dev) == want(STARK101, s)
    assert counters() == {"graph.eager": 1, "graph.capture": 1, "graph.replay": 1}


def test_held_result_is_not_overwritten(fresh, dev):
    traces = [pr.upload(np.stack([STARK101.field.host_to_mont(STARK101.air.trace(
        STARK101.trace_len, s, STARK101.field.p))] * 2), dev) for s in (S, P_S)]
    for _ in range(2):
        fused_core_batch(STARK101, traces[0])
    held = fused_core_batch(STARK101, traces[0])  # a replay's result
    before = {k: fp.to_host(v).copy() for k, v in held.items() if not isinstance(v, list)}
    fused_core_batch(STARK101, traces[1])
    torch.cuda.synchronize()
    assert counters()["graph.replay"] == 2
    for k, v in before.items():
        np.testing.assert_array_equal(fp.to_host(held[k]), v, err_msg=k)
    assert not np.array_equal(before["roots"], fp.to_host(fused_core_batch(STARK101, traces[1])["roots"]))


def test_replay_waits_for_nothing(fresh, want, dev):
    for _ in range(2):
        prove(STARK101, S, device=dev)
    trace = pr.trace_to_device(STARK101, P_S, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = fused.PendingFetch(fused.fused_core_packed(STARK101, trace))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counters()["graph.replay"] == 1
    assert pr.finish_fused(STARK101, fused.unpack_out(STARK101, pending.wait())) == \
        want(STARK101, P_S)


def test_profiler_sees_every_replayed_kernel(fresh, dev):
    """The count the benchmark's device trace rests on: the kernel spans of
    replayed calls under torch.profiler equal the launch counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = [k for f in sorted((ROOT / "proofbench" / "kernels").glob("*.json"))
             for k in json.loads(f.read_text())["kernels"]]
    for _ in range(3):
        prove(STARK101, S, device=dev)
    torch.cuda.synchronize()
    before = sum(ops.launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in (S, P_S, S, P_S, S):
            prove(STARK101, s, device=dev)
        torch.cuda.synchronize()
    launches = sum(ops.launch_counts().values()) - before
    spans = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CUDA and any(n in e.name for n in names))
    assert counters()["graph.replay"] == 6
    assert launches == 5 * 48
    assert spans == launches
