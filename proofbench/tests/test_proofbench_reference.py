"""The plain reference prover against the STARK 101 reference's golden
transcript (BASELINE.md) and against the port on the CPU."""

import dataclasses
import struct

import pytest

from proofbench.reference import prover, sha256
from proofbench.yardstick import statement

GOLDEN_SECRET = 3141592
P = 3221225473


def stark101(secret=GOLDEN_SECRET):
    st = statement.make("stark101", statement.load_config("stark101"), 1)
    last = int(statement.trace(st.air, st.trace_len, secret, P)[-1])
    return dataclasses.replace(st, secret=secret, boundary_last=last)


def parse_head(data: bytes, rounds: int, n_cons: int, q: int) -> dict:
    """Roots, draws, free term and queries from a transcript's head."""
    pos = 0

    def take(n):
        nonlocal pos
        pos += n
        return data[pos - n:pos]

    u32 = lambda: struct.unpack("<I", take(4))[0]  # noqa: E731
    out = {"f_root": take(32).hex(), "alphas": [u32() for _ in range(n_cons)],
           "cp_root": take(32).hex(), "betas": [], "fri_roots": []}
    for _ in range(rounds):
        out["betas"].append(u32())
        out["fri_roots"].append(take(32).hex())
    out["free_term"] = u32()
    out["queries"] = [u32() for _ in range(q)]
    return out


def test_golden_stark101():
    st = stark101()
    assert st.boundary_last == 2338775057
    state, data = prover.prove(st, GOLDEN_SECRET)
    head = parse_head(data, 10, 3, 1)
    assert len(data) == 7836
    assert head["f_root"] == "e7090678303730d51aee399664256de5f6476ec86fb4d45fbf0556535fb09f48"
    assert head["cp_root"] == "3607a328263e286599ab2e932debf372d39c88b0fdb349d58846e187ab7fb55d"
    assert head["alphas"] == [361545003, 3235878091, 2708123352]
    assert head["betas"] == [4195595581, 3610452991, 724415084, 3295998851, 738561939,
                             3410211472, 11579057, 583424291, 2291229637, 890278089]
    assert head["free_term"] == 1478590336
    assert head["queries"][0] % 8176 == 7267
    assert state.hex() == "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"


def test_tensor_hashes_equal_hashlib(monkeypatch):
    """The tensor path of the trees (wide levels) and the hashlib path give
    one proof."""
    st = stark101()
    want = prover.prove(st, GOLDEN_SECRET)
    monkeypatch.setattr(sha256, "HOST_MAX", 4)
    assert prover.prove(st, GOLDEN_SECRET) == want


def test_degree_fix_control_differs():
    st = stark101()
    assert prover.prove(st, GOLDEN_SECRET, degree_fix=False) != prover.prove(st, GOLDEN_SECRET)


@pytest.mark.parametrize("queries", [1, 2])
def test_square_chain_equals_port(queries):
    """A small square-chain statement, both witnesses, against the port's
    plain-torch path on the CPU, and the port's verifier accepts it."""
    from zkstark_tpu_torch.field.fp import field_for
    from zkstark_tpu_torch.protocol import Proof, StarkConfig, prove, verify
    from zkstark_tpu_torch.protocol.air import AIRS

    cfg = dict(air="square-chain", trace_len=511, blowup=8, coset_offset=5,
               n_queries=queries, field_p=P, field_generator=5, boundary_first=1)
    st = statement.make("small", cfg, 2**31 + 99)
    port = StarkConfig(trace_len=st.trace_len, blowup=8, coset_offset=5, boundary_first=1,
                       boundary_last=st.boundary_last, n_queries=queries,
                       air=AIRS["square-chain"], field=field_for(P))
    for k in (0, 1):
        s = st.witness(k)
        state, data = prover.prove(st, s)
        got = prove(port, s, device="cpu")
        assert (state, data) == (got.state, got.data)
        verify(Proof(state=state, data=data), port)


def test_statement_witnesses_share_the_output():
    square_chain = dict(statement.load_config("stark101"), air="square-chain")
    for name, base in (("stark101", statement.load_config("stark101")), ("square_chain", square_chain)):
        cfg = dict(base, trace_len=255)
        st = statement.make(name, cfg, 2**33 + 5)
        assert 1 <= st.secret < P and st.witness(1) == P - st.secret
        rows = [statement.trace(st.air, 255, st.witness(k), P) for k in (0, 1)]
        assert rows[0][-1] == rows[1][-1] == st.boundary_last
        assert (rows[0] != rows[1]).any()
        assert statement.make(name, cfg, 2**33 + 5) == st
