"""The decommit as one byte map (``protocol/prover.py`` `decommit_layout`,
`decommit`; ``transcript/channel.py`` `Channel.commit_cuts`), held against
its plain twin, kept here: each opening turned into bincode bytes level by
level (`bincode.ser_opening`, `bincode.ser_fri_opening` over
`digest_to_bytes`) and committed one `commit_bytes` at a time.

Random words in the opening shapes of stark-101, the work AIR (degree-3 FRI
rounds, 32 queries) at 2^12 points, a Fibonacci and a square-chain statement
and the second prime: the same state and transcript from a new channel and
from a seeded one, the same commit boundaries, the same counters, and the
same bytes from the fused core's dict, a batch's slice of it and a
checkpoint's loaded arrays. No JAX; CPU only, well under a second a case.
"""

import hashlib

import numpy as np
import pytest

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.hash.sha256 import digest_to_bytes
from zkstark_tpu_torch.protocol import checkpoint, fused
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.air import AIRS
from zkstark_tpu_torch.protocol.config import STARK101, StarkConfig, alt_field_config
from zkstark_tpu_torch.protocol.openings import map_leaves
from zkstark_tpu_torch.transcript import Channel, bincode

CONFIGS = {
    "stark101": STARK101,
    "work_2e12_q32": StarkConfig(trace_len=511, n_queries=32, boundary_first=3, boundary_last=5,
                                 air=AIRS["winterfell-work"]),
    "fibonacci_q3": StarkConfig(trace_len=255, n_queries=3, boundary_last=7,
                                air=AIRS["fibonacci"]),
    "square_chain_b4": StarkConfig(trace_len=127, blowup=4, n_queries=2, boundary_last=11,
                                   air=AIRS["square-chain"]),
    "alt_field_q3": alt_field_config(trace_len=63, n_queries=3),
}
CASES = pytest.mark.parametrize("name", sorted(CONFIGS))


def random_words(shape, rng) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def random_openings(cfg: StarkConfig, seed: int = 0) -> dict:
    """A proof's openings dict as the fused core's fetch gives it: views of
    one random packed vector (`fused.unpack_out`), roots and draws beside."""
    rng = np.random.default_rng(seed)
    size = sum(int(np.prod(s)) for v in fused.out_shapes(cfg).values()
               for s in (v if isinstance(v, list) else [v]))
    return fused.unpack_out(cfg, random_words(size, rng))


def plain_decommit(cfg: StarkConfig, channel: Channel, out: dict):
    """The twin: every opening serialized and committed on its own, in the
    reference's order (prover.rs:256-289, generalised to n_queries). Returns
    (state, data) and the transcript offset after each commit."""

    def path(p):
        return [digest_to_bytes(p[d]) for d in range(p.shape[0])]

    start, ends = len(channel.data), []

    def commit(payload: bytes):
        channel.commit_bytes(payload)
        ends.append(len(channel.data) - start)

    for qi in range(cfg.n_queries):
        for si in range(len(cfg.air.shifts)):
            commit(bincode.ser_opening(int(out["open_f_vals"][qi][si]),
                                       path(out["open_f_paths"][qi][si])))
        commit(bincode.ser_opening(int(out["open_cp_vals"][qi]), path(out["open_cp_paths"][qi])))
        for layer in range(cfg.fri_rounds):
            v, p = out["open_fri_vals"][layer][qi], out["open_fri_paths"][layer][qi]
            commit(bincode.ser_fri_opening(int(v[0]), int(v[1]), path(p[0]), path(p[1])))
    return channel.finalize(), ends


def seeded() -> Channel:
    """A channel that is not new, as the host-synced path may be given."""
    ch = Channel()
    ch.commit_hash(hashlib.sha256(b"prefix").digest())
    ch.get_u32()
    return ch


@CASES
@pytest.mark.parametrize("channel", [Channel, seeded])
def test_decommit_equals_the_plain_twin(name, channel):
    cfg = CONFIGS[name]
    out = random_openings(cfg, seed=len(name))
    queries = list(range(cfg.n_queries))
    proof = pr.decommit(cfg, channel(), out, queries)
    assert (proof.state, proof.data) == plain_decommit(cfg, channel(), out)[0]


@CASES
def test_cuts_are_the_twins_commit_boundaries(name):
    cfg = CONFIGS[name]
    layout = pr.decommit_layout(cfg)
    _, ends = plain_decommit(cfg, Channel(), random_openings(cfg))
    assert layout.cuts == tuple(ends)
    assert 4 * layout.index.size == ends[-1]
    # one distinct u64 length a path depth, and every source word in range
    assert layout.tail.size == 2 * cfg.fri_rounds
    assert layout.index.max() < layout.src_words


@CASES
def test_counters_read_openings_and_bytes_once(name):
    cfg = CONFIGS[name]
    ch = seeded()
    head = len(ch.data)
    tracing.reset()
    proof = pr.decommit(cfg, ch, random_openings(cfg), list(range(cfg.n_queries)))
    counters = tracing.totals()["counters"]
    assert counters["decommit.openings"] == cfg.n_queries * (len(cfg.air.shifts) + 1 + cfg.fri_rounds)
    assert counters["decommit.bytes"] == len(proof.data) - head


@CASES
def test_checkpoint_arrays_give_the_fused_bytes(name, tmp_path):
    """The host arrays a "fused" checkpoint saves and loads (lists of layers,
    the queries beside) decommit to the bytes of the fused core's dict."""
    cfg = CONFIGS[name]
    out = random_openings(cfg, seed=7)
    queries = list(range(cfg.n_queries))
    arrays = {k: out[k] for k in checkpoint.PHASE_KEYS["fused"] if k in out}
    arrays["queries_drawn"] = np.asarray(queries, dtype=np.int64)
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, "fused", seeded(), arrays)
    phase, ch, loaded = checkpoint.load(path)
    assert phase == "fused"
    got = pr.decommit(cfg, ch, loaded, [int(q) for q in loaded["queries_drawn"]])
    want = pr.decommit(cfg, seeded(), out, queries)
    assert (got.state, got.data) == (want.state, want.data)


@pytest.mark.parametrize("name", ["stark101", "work_2e12_q32"])
def test_each_proof_of_a_batch_equals_the_twin(name):
    """`prove_batch`'s host step decommits one proof's slice of the (B, ·)
    result at a time."""
    cfg, bsz = CONFIGS[name], 3
    rng = np.random.default_rng(3)
    shapes = fused.out_shapes(cfg, (bsz,))
    size = sum(int(np.prod(s)) for v in shapes.values() for s in (v if isinstance(v, list) else [v]))
    out = fused.unpack_tree(random_words(size, rng), shapes)
    for i in range(bsz):
        one = map_leaves(out, lambda a: a[i])
        proof = pr.decommit(cfg, Channel(), one, list(range(cfg.n_queries)))
        assert (proof.state, proof.data) == plain_decommit(cfg, Channel(), one)[0]


def test_layout_is_built_once_a_statement():
    cfg = CONFIGS["fibonacci_q3"]
    pr.decommit_layout.cache_clear()
    tracing.reset()
    for seed in (1, 2):
        pr.decommit(cfg, Channel(), random_openings(cfg, seed), list(range(cfg.n_queries)))
    assert tracing.totals()["counters"]["cache.miss.decommit_layout"] == 1


def test_openings_of_another_statement_are_refused():
    cfg, other = CONFIGS["fibonacci_q3"], CONFIGS["square_chain_b4"]
    with pytest.raises(ValueError, match="do not fit the statement"):
        pr.decommit(cfg, Channel(), random_openings(other), list(range(cfg.n_queries)))
    # the opening shapes agree, the queries do not
    with pytest.raises(ValueError, match="do not fit the statement"):
        pr.decommit(cfg, Channel(), random_openings(cfg), [0])


@pytest.mark.parametrize("cuts", [[3, 9, 16], [16], [5, 5, 16]])
def test_commit_cuts_is_commit_bytes_piece_by_piece(cuts):
    payload = np.arange(16, dtype=np.uint8) * 7
    got, want = seeded(), seeded()
    got.commit_cuts(payload, cuts)
    start = 0
    for end in cuts:
        want.commit_bytes(payload[start:end].tobytes())
        start = end
    assert got.finalize() == want.finalize()


@pytest.mark.parametrize("cuts", [[], [3, 15], [3, 17]])
def test_commit_cuts_must_end_at_the_payload(cuts):
    ch = Channel()
    with pytest.raises(ValueError, match="16 bytes"):
        ch.commit_cuts(bytes(16), cuts)
    assert ch.finalize() == Channel().finalize()

