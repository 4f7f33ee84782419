"""The port's prove path as a whole, on the CPU (plain-torch twins).

stark-101 must give the reference's golden transcript byte for byte
(the values of tests/test_protocol_golden.py), and the JAX verifier, the
port's verifier and the C++ verifier must all accept it. Proof bytes cross
between the two packages' `Proof` containers unchanged.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch

import zkstark_tpu.protocol as jproto
from zkstark_tpu.protocol.config import alt_field_config as jax_alt_field_config
from zkstark_tpu_torch import STARK101, STARK101_SECRET, Proof, VerificationError, prove, verify
from zkstark_tpu_torch.protocol.config import STARK101_Q3, alt_field_config, from_reference
from zkstark_tpu_torch.protocol.prover import ProverArtifacts
from zkstark_tpu_torch.transcript import bincode

F_ROOT = "e7090678303730d51aee399664256de5f6476ec86fb4d45fbf0556535fb09f48"
CP_ROOT = "3607a328263e286599ab2e932debf372d39c88b0fdb349d58846e187ab7fb55d"
ALPHAS = [361545003, 3235878091, 2708123352]
BETAS = [
    4195595581, 3610452991, 724415084, 3295998851, 738561939,
    3410211472, 11579057, 583424291, 2291229637, 890278089,
]
FREE_TERM = 1478590336
QUERY_POINT = 7267
FINAL_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
TRANSCRIPT_LEN = 7836


@pytest.fixture(scope="module")
def golden():
    art = ProverArtifacts()
    timings = {}
    # the host-synced path: it alone keeps the trees and has per-phase spans
    proof = prove(
        STARK101, STARK101_SECRET, device="cpu", artifacts=art, timings=timings, fused=False
    )
    return proof, art, timings


def test_golden_transcript(golden):
    proof, art, _ = golden
    assert len(proof.data) == TRANSCRIPT_LEN
    assert proof.size() == TRANSCRIPT_LEN + 48
    r = bincode.Reader(proof.data)
    assert r.hash().hex() == F_ROOT
    assert [r.u32() for _ in range(3)] == ALPHAS
    assert r.hash().hex() == CP_ROOT
    for i in range(10):
        assert r.u32() == BETAS[i]
        r.hash()
    assert r.u32() == FREE_TERM
    assert r.u32() % 8176 == QUERY_POINT
    assert art.query_index == QUERY_POINT
    assert art.f_tree.root().hex() == F_ROOT
    assert art.layer_trees[0].root().hex() == CP_ROOT


def test_golden_final_state(golden):
    """The channel hash chain recomputed from the raw transcript bytes."""
    proof, _, _ = golden
    assert proof.state.hex() == FINAL_STATE
    r = bincode.Reader(proof.data)
    payloads = [r.hash()] + [bincode.ser_u32(r.u32()) for _ in range(3)] + [r.hash()]
    for _ in range(10):
        payloads += [bincode.ser_u32(r.u32()), r.hash()]
    payloads += [bincode.ser_u32(r.u32()), bincode.ser_u32(r.u32())]
    payloads += [bincode.ser_opening(*r.opening()) for _ in range(4)]
    payloads += [bincode.ser_fri_opening(*r.fri_opening()) for _ in range(10)]
    assert r.exhausted
    state = b"\x00" * 32
    for payload in payloads:
        state = hashlib.sha256(state + payload).digest()
    assert state == proof.state


def test_phase_timings_recorded(golden):
    _, _, timings = golden
    assert set(timings) == {
        "trace", "phase1_lde_commit", "phase2_composition", "phase3_fri", "phase4_decommit"
    }


def test_both_verifiers_accept(golden):
    proof, _, _ = golden
    assert verify(proof, STARK101).checks_passed == [
        "transcript-replay",
        "composition-identity",
        "trace-auth-paths",
        "fri-consistency",
        "fri-auth-paths",
    ]
    jproof = jproto.Proof.from_bytes(proof.to_bytes())
    jproto.verify(jproof, jproto.STARK101)
    assert Proof.from_bytes(jproof.to_bytes()) == proof


def test_native_verifier_accepts(golden):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ verifier")
    from zkstark_tpu_torch.native import verify_native

    proof, _, _ = golden
    verify_native(proof, STARK101)
    raw = bytearray(proof.data)
    raw[500] ^= 1
    with pytest.raises(VerificationError):
        verify_native(Proof(state=proof.state, data=bytes(raw)), STARK101)


def test_tampered_and_truncated_rejected(golden):
    proof, _, _ = golden
    for offset in (0, 33, 80, 500, 4000, len(proof.data) - 1):
        raw = bytearray(proof.data)
        raw[offset] ^= 0x01
        with pytest.raises(VerificationError):
            verify(Proof(state=proof.state, data=bytes(raw)), STARK101)
    with pytest.raises(VerificationError):
        verify(Proof(state=proof.state, data=proof.data[:1000]), STARK101)


def test_wrong_witness_rejected():
    with pytest.raises(ValueError, match="boundary"):
        prove(STARK101, secret=123456, device="cpu")


def test_no_silent_cpu_fallback():
    """device="cuda" without a CUDA device raises; it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        prove(STARK101, STARK101_SECRET, device="cuda")


def test_from_reference_stark101():
    assert from_reference(jproto.STARK101) == STARK101


def test_from_reference_alt_field_same_bytes():
    """A JAX config over the second prime, carried across, is the port's own
    `alt_field_config` and proves the same bytes in both packages."""
    jcfg = jax_alt_field_config(trace_len=63, secret=31415)
    cfg = alt_field_config(trace_len=63, secret=31415)
    assert cfg == from_reference(jcfg)
    assert cfg.field.p == jcfg.field.p == 2013265921
    want = jproto.prove(jcfg, 31415)
    got = prove(cfg, 31415, device="cpu")
    assert (got.state, got.data) == (want.state, want.data)
    verify(got, cfg)


def test_sparse_openings_match_host_trees(golden):
    """The device gathers of phase 4 equal the values and paths read from
    the full trees."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.protocol.openings import sparse_openings

    _, art, _ = golden
    x = art.query_index
    out = sparse_openings(
        STARK101,
        art.f_res,
        art.f_tree.levels,
        art.layer_res,
        [t.levels for t in art.layer_trees],
        [x],
    )
    f_res = fp.to_host(art.f_res)
    for si, k in enumerate((0, 1, 2)):
        assert out["open_f_vals"][0][si] == f_res[x + 8 * k]
        path = [bytes(np.asarray(d, ">u4").tobytes()) for d in out["open_f_paths"][0][si]]
        assert path == art.f_tree.auth_path(x + 8 * k)


def test_q3_golden():
    """Three queries: the pinned STARK101_Q3 transcript of the JAX package."""
    art = ProverArtifacts()
    proof = prove(STARK101_Q3, STARK101_SECRET, device="cpu", artifacts=art)
    assert len(proof.data) == 22628
    assert proof.state.hex() == "8a33e974201e1cd6e3b996d11adecfffaccd2cce2efb7253fb2eb5f7f3077eb1"
    assert art.query_indices == [7267, 2339, 3245]
    verify(proof, STARK101_Q3)
    jproto.verify(jproto.Proof.from_bytes(proof.to_bytes()), jproto.STARK101_Q3)
    assert from_reference(jproto.STARK101_Q3) == STARK101_Q3
