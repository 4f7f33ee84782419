"""The plain reference prover against the STARK 101 reference's golden
transcript (BASELINE.md) and against the port on the CPU."""

import dataclasses
import hashlib
import struct

import numpy as np
import pytest
import torch

from proofbench.reference import prover, sha256
from proofbench.yardstick import roofline, statement

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


# The reference's proofs of the four one-column AIRs before traces of w
# columns: SHA-256 of state ‖ data over both witnesses of seed 2^31 + 4243,
# sound and control, at 63 and 255 rows; and the yardstick's (bytes, ops).
FROZEN_SEED = 2**31 + 4243
FROZEN = {
    ("fibonacci-sq", 63): ("4680b8697f9672dd31c06b647311cc7482bfb0a74f2cbdcdebd11b10bef1340d",
                           "4e112c01d3baa6a3005a4ace8a6deebef7cb5523e0d13a93db4256038b5ec5d7"),
    ("fibonacci-sq", 255): ("fd0efb86c097ce6ceac2b0102664b65a0de5e4bf5ba27e0fc8839b8b971316b1",
                            "b5b4ae559991892664d0f6832caa3aeffa834c3f25a2e392bcc08a4df758e342"),
    ("square-chain", 63): ("4bf68a932d21b131abf18c8a3995f839f8c73d3e3702e8f3d2b7c01fed81fca4",
                           "0561705f4b35fdb3041fee614482d305cc55def67514e1f4c875c477817b7045"),
    ("square-chain", 255): ("10f70c63b0b150b3f017b1e15c3800713ad07ab5369f1ae33a4281b96493e8b0",
                            "c1369de42f91d1e2ca3ed9af20b5f33242285bcc443e4b4101b6f9013df375af"),
    ("fibonacci", 63): ("4b176550be8b91e81493d42e99ca3be77372f4834e1ad79ca997b48ad08c5aad",
                        "03b554ddd9de2360e9fdd445f5e563781ef0c71d4a502455f898bee0fce7bd98"),
    ("fibonacci", 255): ("0b3914a78aef1e90ea77ed9f24084a9eb9ac610e239b058c458d15bd2b3a374f",
                         "0f40291c0d5d619ffeddf6ac78cc33b8de771e922ea5f52b9524821cc881f6c7"),
    ("winterfell-work", 63): ("98c815fb5cdc4d78958a15b63025ad946702025bf62f69d7fd613be66c26bfac",
                              "eeb423774779a837799d35cd2311ca57596389fe7b956d58d43311ed38dbcb4a"),
    ("winterfell-work", 255): ("ba2a7f5e1ccd67d0193323a4e48e0ea7cab287e980374a9fd9b3e742b9d2af6e",
                               "5a5ec763fd893884c4914e16a5f839d0c8abefb0094fab6bccb6666125b03e88"),
}
FROZEN_WORK = {
    "stark101": ((1670240, 87213512), (45056, 648192)),
    "winterfell_work": ((1711275024, 89363774196), (46137344, 1277165568)),
}


@pytest.mark.parametrize("host_max", [sha256.HOST_MAX, 4], ids=["hashlib", "tensor"])
@pytest.mark.parametrize("air,trace_len", sorted(FROZEN))
def test_one_column_proofs_are_frozen(air, trace_len, host_max, monkeypatch):
    """w = 1 gives every byte it gave before the trace took w columns, on
    the hashlib leaves and on the tensor path."""
    monkeypatch.setattr(sha256, "HOST_MAX", host_max)
    base = "winterfell_work" if air == "winterfell-work" else "stark101"
    cfg = dict(statement.load_config(base), air=air, trace_len=trace_len)
    st = statement.make("frozen", cfg, FROZEN_SEED)
    assert st.width == 1
    got = []
    for fix in (True, False):
        h = hashlib.sha256()
        for w in st.cycle:
            state, data = prover.prove(st, w, degree_fix=fix)
            h.update(state + data)
        got.append(h.hexdigest())
    assert tuple(got) == FROZEN[air, trace_len]


@pytest.mark.parametrize("name", sorted(FROZEN_WORK))
def test_one_column_yardstick_is_frozen(name):
    st = statement.make(name, statement.load_config(name), FROZEN_SEED)
    assert (roofline.merkle_work(st), roofline.lde_work(st)) == FROZEN_WORK[name]


def test_leaf_ops_count_the_blocks_of_a_row():
    """One word is the frozen leaf, 16 varying words the node's first block;
    a row of 14 words needs a second block of padding alone."""
    assert roofline.leaf_ops(1) == roofline.SHA_LEAF
    assert roofline.schedule_ops(16) == 48 * 10 and roofline.schedule_ops(0) == 0
    assert roofline.leaf_ops(13) < roofline.leaf_ops(14) == (
        roofline.leaf_ops(13) - roofline.schedule_ops(13) + roofline.schedule_ops(14)
        + roofline.SHA_ROUNDS)


def test_wide_rows_tensor_path_equals_hashlib(monkeypatch):
    """Rows of 8 columns, one block a leaf, hashed as tensors equal hashlib's
    digests; rows of 14 go through hashlib on either setting."""
    rows = torch.randint(0, P, (64, 8), generator=torch.Generator().manual_seed(3))
    want = sha256.leaves(rows)
    monkeypatch.setattr(sha256, "HOST_MAX", 4)
    got = sha256.leaves(rows)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    raw = rows.numpy().astype(">u4").tobytes()
    assert sha256.digest_bytes(got, 5) == hashlib.sha256(raw[5 * 32:6 * 32]).digest()
    wide = torch.randint(0, P, (64, 14), generator=torch.Generator().manual_seed(4))
    assert isinstance(sha256.leaves(wide), np.ndarray)
