"""Winterfell's `mulfib8` on the port (``protocol/air.py``
`WinterfellMulfib8Air`): a trace of 8 columns, one register a column, 8
transitions of degree 2 across a row and the next, and boundaries on
columns 0, 1 and 6.

  * `prove(device="cpu")` equals the benchmark's plain reference
    (``proofbench/reference``, with its own copy of the AIR) byte for byte,
    at 63 and 255 rows, 32 and 1 queries, three seeded starts; the proof's
    length is `expected_proof_len`'s, and the Python verifier accepts it;
  * the verifier rejects a flipped word of an opened row, a proof of a trace
    whose columns 2 and 3 are swapped, and other public values;
  * the counters ``witness.cells``, ``merkle.row_leaves`` and
    ``decommit.openings`` of one proof;
  * the host-synced path, `prove_batch` and `prove_pipelined` give the fused
    prove's bytes, and every entry that proves traces of one column only
    (a mesh, the resumable prover, `verify_native`) raises ValueError, naming
    the width, before the witness or any launch;
  * on a card (marker `cuda`): the fused prove at 2,047 rows and 32 queries
    equals the CPU prove and the reference, a replayed CUDA graph equals the
    eager bytes, and ``sha256_leaf_rows`` equals its plain twin at w = 1, 2,
    8 and 13.

The file imports no JAX, so the card's part runs on a machine without it:

    python -m pytest tests/test_torch_mulfib8.py --noconftest -q
"""

import functools
import random

import numpy as np
import pytest
import torch

from proofbench.reference import prover as reference
from proofbench.yardstick import statement
from zkstark_tpu_torch import ops, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.native import verify_native
from zkstark_tpu_torch.protocol import Proof, StarkConfig, prove, prove_pipelined, verify
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.air import AIRS
from zkstark_tpu_torch.protocol.batch import prove_batch
from zkstark_tpu_torch.protocol.proof import expected_proof_len
from zkstark_tpu_torch.protocol.verifier import VerificationError

P = fp.FIELD101.p
MULFIB8 = AIRS["winterfell-mulfib8"]
_RNG = random.Random(2**31 + 25)
STARTS = [_RNG.randrange(2, P) for _ in range(3)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run starts six test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(trace_len: int, b: int, n_queries: int = 32, **kw) -> StarkConfig:
    """The statement of start b: s1[0] = b, and s6 at the last row."""
    last = int(MULFIB8.trace(trace_len, b, P)[6, -1])
    return StarkConfig(trace_len=trace_len, n_queries=n_queries, boundary_first=b,
                       boundary_last=last, air=MULFIB8, **kw)


def reference_proof(cfg: StarkConfig, b: int) -> tuple:
    """The plain reference's (state, data) of the port config's statement."""
    st = statement.Statement(
        name="mulfib8", air=cfg.air.name, trace_len=cfg.trace_len, blowup=cfg.blowup,
        coset_offset=cfg.coset_offset, n_queries=cfg.n_queries, p=P, generator=5,
        boundary_first=cfg.boundary_first, boundary_last=cfg.boundary_last, secret=b)
    return reference.prove(st, b)


@functools.lru_cache(maxsize=None)
def cpu_proof(trace_len: int, n_queries: int, b: int) -> Proof:
    return prove(config(trace_len, b, n_queries), b, device="cpu")


def head_bytes(cfg: StarkConfig) -> int:
    """The transcript's bytes before the first opening: roots, free term, draws."""
    return 32 * (2 + cfg.fri_rounds) + 4 + 4 * (cfg.n_constraints + cfg.fri_rounds
                                                + cfg.n_queries)


def test_the_trace_is_the_benchmarks():
    b = STARTS[0]
    rows = statement.trace("winterfell-mulfib8", 255, b, P)
    np.testing.assert_array_equal(MULFIB8.trace(255, b, P), rows.T)
    assert MULFIB8.width == 8 and len(config(63, b).constraints) == 11


@pytest.mark.parametrize("start", range(3))
@pytest.mark.parametrize("n_queries", [32, 1])
@pytest.mark.parametrize("trace_len", [63, 255])
def test_prove_equals_reference(trace_len, n_queries, start):
    b = STARTS[start]
    cfg = config(trace_len, b, n_queries)
    got = cpu_proof(trace_len, n_queries, b)
    assert (got.state, got.data) == reference_proof(cfg, b)
    assert len(got.data) == expected_proof_len(cfg)
    verify(got, cfg)


def test_published_size_proof_length():
    """131,071 rows on 2^20 points, 17 FRI rounds, 32 queries: 32 × 15,476 B
    of openings and 852 B of roots, free term and draws."""
    cfg = config(63, STARTS[0])
    big = StarkConfig(trace_len=131071, n_queries=32, boundary_last=0, air=MULFIB8)
    assert (big.eval_domain, big.fri_rounds, big.n_constraints) == (1 << 20, 17, 11)
    assert expected_proof_len(big) == 496084 == 32 * 15476 + head_bytes(big)
    assert cfg.fri_rounds == 6


@pytest.mark.parametrize("word", [0, 3, 7])
def test_verifier_rejects_a_flipped_row_word(word):
    b = STARTS[0]
    cfg = config(63, b)
    proof = cpu_proof(63, 32, b)
    data = bytearray(proof.data)
    data[head_bytes(cfg) + 4 * word] ^= 1  # the first query's row at shift 0
    with pytest.raises(VerificationError):
        verify(Proof(state=proof.state, data=bytes(data)), cfg)


def test_verifier_rejects_swapped_columns(monkeypatch):
    """A prover that commits the rows with columns 2 and 3 swapped (the
    boundaries on columns 0, 1 and 6 still hold) makes a proof the verifier
    rejects: the composition of that trace is no polynomial of low degree,
    so a FRI fold misses."""
    b = STARTS[1]
    cfg = config(63, b)
    want = cpu_proof(63, 32, b)
    honest = pr.witness_words

    def swapped(cfg_, secrets, device):
        words, last = honest(cfg_, secrets, device)
        words[:, [2, 3]] = words[:, [3, 2]].clone()
        return words, last

    monkeypatch.setattr(pr, "witness_words", swapped)
    proof = prove(cfg, b, device="cpu")
    assert proof != want
    with pytest.raises(VerificationError, match="fri"):
        verify(proof, cfg)


@pytest.mark.parametrize("public", ["boundary_last", "boundary_first"])
def test_verifier_rejects_other_public_values(public):
    b = STARTS[1]
    cfg = config(63, b)
    other = StarkConfig(**{**{k: getattr(cfg, k) for k in (
        "trace_len", "blowup", "coset_offset", "boundary_first", "boundary_last",
        "n_queries", "air", "field")}, public: (getattr(cfg, public) + 1) % P})
    with pytest.raises(VerificationError):
        verify(cpu_proof(63, 32, b), other)


def test_counters_of_one_proof():
    b = STARTS[2]
    cfg = config(63, b)
    tracing.reset()
    got = prove(cfg, b, device="cpu")
    counters = tracing.totals()["counters"]
    assert counters["witness.rows"] == 63
    assert counters["witness.cells"] == 63 * 8
    assert counters["merkle.row_leaves"] == cfg.eval_domain
    assert counters["decommit.openings"] == 32 * (2 + 1 + cfg.fri_rounds)
    assert counters["decommit.bytes"] == len(got.data) - head_bytes(cfg)


def test_other_entries_give_the_fused_bytes():
    """The host-synced path, a batch of two witnesses of the statement and
    a pipelined prove: each proof the solo fused prove's bytes."""
    b = STARTS[0]
    cfg = config(63, b)
    want = cpu_proof(63, 32, b)
    assert prove(cfg, b, device="cpu", fused=False) == want
    assert prove_batch(cfg, [b, b], device="cpu") == [want, want]
    assert prove_pipelined(cfg, [b], device="cpu") == [want]


def _refused(call) -> None:
    """`call` raises ValueError naming the width before the witness runs."""
    tracing.reset()
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="width 8"):
        call()
    assert "witness" not in tracing.totals()["spans"]
    assert ops.launch_counts() == before


def test_entries_of_one_column_refuse_width_8(tmp_path):
    from zkstark_tpu_torch.parallel import make_mesh
    from zkstark_tpu_torch.protocol.checkpoint import ResumableProver

    b = STARTS[0]
    cfg = config(63, b)
    mesh = make_mesh(2, device="cpu")
    _refused(lambda: prove(cfg, b, device="cpu", mesh=mesh))
    _refused(lambda: prove_batch(cfg, [b, b], mesh=mesh))
    _refused(lambda: ResumableProver(cfg, b, str(tmp_path / "ckpt"), device="cpu").run())
    _refused(lambda: verify_native(cpu_proof(63, 32, b), cfg))


# ---- on the card ----

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_ROWS = 2047  # 2^14 points: under graph.GRAPH_POINTS


@pytest.mark.cuda
def test_card_prove_equals_cpu_and_reference(dev):
    for b in STARTS[:2]:
        cfg = config(CARD_ROWS, b)
        got = prove(cfg, b, device=dev)
        assert got == prove(cfg, b, device="cpu")
        assert (got.state, got.data) == reference_proof(cfg, b)
        assert got == prove(cfg, b, device=dev, fused=False)
        verify(got, cfg)


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(dev, monkeypatch):
    from zkstark_tpu_torch.protocol import fused, graph

    monkeypatch.setattr(fused, "_GRAPHS", graph.CoreGraphs(fused._core))
    tracing.reset()
    cfgs = {b: config(CARD_ROWS, b) for b in STARTS[:2]}
    got = [prove(cfgs[b], b, device=dev) for b in STARTS[:2] * 3]
    assert {k: n for k, n in tracing.totals()["counters"].items() if k.startswith("graph.")} \
        == {"graph.eager": 2, "graph.capture": 2, "graph.replay": 2}
    for k, b in enumerate(STARTS[:2] * 3):
        assert got[k] == got[k % 2] == prove(cfgs[b], b, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 8, 13])
@pytest.mark.parametrize("trees,n", [(1, 2), (1, 1 << 14), (3, 1 << 10)])
def test_card_leaf_rows_equal_plain(dev, width, trees, n):
    from zkstark_tpu_torch.ops import sha256_kernel as sk

    gen = torch.Generator().manual_seed(width * 1000 + n + trees)
    host = torch.randint(0, 2**32, (trees, width, n), generator=gen, dtype=torch.int64)
    values = fp.as_u32(host.to(torch.int32))
    before = ops.launch_counts()["sha256_leaf_rows"]
    got = sk.leaf_hash_rows(values.to(dev))
    assert ops.launch_counts()["sha256_leaf_rows"] == before + 1
    assert torch.equal(fp.as_i32(got).cpu(), fp.as_i32(sk.leaf_hash_rows_plain(values)))
    if width == 1:
        assert torch.equal(fp.as_i32(got).cpu(),
                           fp.as_i32(sk.leaf_hash_plain(values.reshape(-1))))
