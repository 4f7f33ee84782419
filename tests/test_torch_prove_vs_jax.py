"""The port's proofs equal the JAX package's, byte for byte.

For each of the three AIRs at trace_len = 63 (a 512-point evaluation
domain), `zkstark_tpu_torch.prove(..., device="cpu")` must return the final
state and transcript of `zkstark_tpu.protocol.prove(cfg, secret)`. Two more
square-chain proofs lower the port's MIN_FOURSTEP so that every NTT of the
proof runs through the four-step glue, on the DIT and on the Pease route.
"""

import pytest

import zkstark_tpu.protocol as jproto
from zkstark_tpu.protocol import air as jair
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch import prove, verify
from zkstark_tpu_torch.ops import ntt_kernel
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol.config import StarkConfig, from_reference

SECRET = 31415
AIRS = ["fibonacci-sq", "fibonacci", "square-chain"]


def _configs(name):
    trace = jair.AIRS[name].trace(63, SECRET)
    kw = dict(trace_len=63, boundary_first=int(trace[0]), boundary_last=int(trace[-1]))
    return JaxConfig(air=jair.AIRS[name], **kw), StarkConfig(air=tair.AIRS[name], **kw)


@pytest.fixture(scope="module")
def jax_proofs():
    return {name: jproto.prove(_configs(name)[0], SECRET) for name in AIRS}


@pytest.mark.parametrize("name", AIRS)
def test_proof_equals_jax(jax_proofs, name):
    jcfg, cfg = _configs(name)
    got = prove(cfg, SECRET, device="cpu")
    want = jax_proofs[name]
    assert got.state == want.state
    assert got.data == want.data
    verify(got, cfg)
    assert from_reference(jcfg) == cfg


def test_fourstep_glue_in_a_whole_proof(jax_proofs, monkeypatch):
    monkeypatch.setattr(ntt_kernel, "MIN_FOURSTEP", 4)
    _, cfg = _configs("square-chain")
    got = prove(cfg, SECRET, device="cpu")
    want = jax_proofs["square-chain"]
    assert (got.state, got.data) == (want.state, want.data)


def test_pease_route_in_a_whole_proof(jax_proofs, monkeypatch):
    """Every NTT of the proof through the four-step glue on the Pease route
    (ZKSTARK_PEASE=on): the same bytes as the JAX proof."""
    monkeypatch.setattr(ntt_kernel, "MIN_FOURSTEP", 4)
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    _, cfg = _configs("square-chain")
    got = prove(cfg, SECRET, device="cpu")
    want = jax_proofs["square-chain"]
    assert (got.state, got.data) == (want.state, want.data)
