"""Pipelined and fused proving in the port: the bytes of solo proving.

The cases of ``tests/test_pipelined.py`` for the port (`prove_pipelined` and
`prove_batch_pipelined` give the solo proof for every proof of the stream,
at several depths), and `prove(fused=True)` == `prove(fused=False)` == the
golden transcript of stark-101 and of its three-query variant. All on the
CPU.
"""

import pytest

from zkstark_tpu.protocol import prove as jax_prove
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.protocol import (
    STARK101,
    STARK101_Q3,
    STARK101_SECRET,
    prove,
    prove_pipelined,
    verify,
)
from zkstark_tpu_torch.protocol.air import fibonacci_sq_trace
from zkstark_tpu_torch.protocol.batch import prove_batch_pipelined
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.prover import ProverArtifacts

GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
GOLDEN_LEN = 7836
# the pinned values of tests/test_protocol_golden_q3.py
GOLDEN_Q3_STATE = "8a33e974201e1cd6e3b996d11adecfffaccd2cce2efb7253fb2eb5f7f3077eb1"
GOLDEN_Q3_LEN = 22628
GOLDEN_Q3_POINTS = [7267, 2339, 3245]


def _small():
    trace = fibonacci_sq_trace(63, 3141592)
    kw = dict(trace_len=63, blowup=8, boundary_last=int(trace[-1]))
    return JaxConfig(**kw), StarkConfig(**kw)


@pytest.fixture(scope="module")
def solo():
    jcfg, cfg = _small()
    want = jax_prove(jcfg, 3141592)
    got = prove(cfg, 3141592, device="cpu")
    assert (got.state, got.data) == (want.state, want.data)
    return got


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_bytes_identical(solo, depth):
    _, cfg = _small()
    proofs = prove_pipelined(cfg, [3141592] * 5, depth=depth, device="cpu")
    assert len(proofs) == 5
    for p in proofs:
        assert p.data == solo.data and p.state == solo.state


@pytest.mark.parametrize("depth", [1, 2])
def test_batch_pipelined_bytes_identical(solo, depth):
    _, cfg = _small()
    proofs = prove_batch_pipelined(cfg, [[3141592] * 3] * 3, depth=depth, device="cpu")
    assert len(proofs) == 9
    for p in proofs:
        assert p.data == solo.data and p.state == solo.state


def test_pipelined_empty_stream():
    _, cfg = _small()
    assert prove_pipelined(cfg, [], device="cpu") == []
    assert prove_batch_pipelined(cfg, [], device="cpu") == []


def test_pipelined_bad_secret_raises(solo):
    _, cfg = _small()
    with pytest.raises(ValueError):
        prove_pipelined(cfg, [3141592, 1], device="cpu")


def test_fused_and_host_synced_give_the_stark101_golden():
    fused = prove(STARK101, STARK101_SECRET, device="cpu")
    legacy = prove(STARK101, STARK101_SECRET, device="cpu", fused=False)
    assert fused == legacy
    assert len(fused.data) == GOLDEN_LEN
    assert fused.state.hex() == GOLDEN_STATE
    verify(fused, STARK101)


def test_fused_and_host_synced_give_the_q3_golden():
    art = ProverArtifacts()
    timings = {}
    fused = prove(STARK101_Q3, STARK101_SECRET, device="cpu", artifacts=art, timings=timings)
    legacy = prove(STARK101_Q3, STARK101_SECRET, device="cpu", fused=False)
    assert fused == legacy
    assert len(fused.data) == GOLDEN_Q3_LEN
    assert fused.state.hex() == GOLDEN_Q3_STATE
    assert art.query_indices == GOLDEN_Q3_POINTS
    assert sorted(timings) == ["device_program", "fetch", "replay_decommit", "trace"]
    verify(fused, STARK101_Q3)
