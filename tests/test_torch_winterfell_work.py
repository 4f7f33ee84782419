"""Winterfell's `do_work` statement on the port (``protocol/air.py``
`WinterfellWorkAir`): a[0] = a public start, a[i] = a[i-1]³ + 42, one
transition of degree 3, so FRI folds log2(2n) rounds (``config.py``
`fri_rounds`) and not log2 n.

  * `prove(device="cpu")` equals the benchmark's plain reference
    (``proofbench/reference``, with its own copy of the AIR) byte for byte,
    at 63 and 255 rows, 32 and 1 queries, three seeded starts; the Python
    verifier accepts each proof and rejects a flipped byte or other public
    values;
  * the rounds of every AIR, the work proof's last FRI layer (one value
    repeated after log2(2n) folds, not after log2 n), a blowup too small for
    the composition's degree, `verify_native`'s refusal, and the decommit
    counters;
  * on a card (marker `cuda`): the fused prove at 2,047 rows and 32 queries
    equals the CPU prove and the reference, and a replayed CUDA graph equals
    the eager bytes.

The file imports no JAX, so the card's part runs on a machine without it:

    python -m pytest tests/test_torch_winterfell_work.py --noconftest -q
"""

import functools
import random

import pytest
import torch

from proofbench.reference import prover as reference
from proofbench.yardstick import statement
from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.native import verify_native
from zkstark_tpu_torch.protocol import Proof, StarkConfig, prove, verify
from zkstark_tpu_torch.protocol.air import AIRS
from zkstark_tpu_torch.protocol.proof import expected_proof_len
from zkstark_tpu_torch.protocol.verifier import VerificationError

P = fp.FIELD101.p
WORK = AIRS["winterfell-work"]
_RNG = random.Random(2**31 + 20)
STARTS = [_RNG.randrange(1, P) for _ in range(3)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run starts six test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(trace_len: int, start: int, n_queries: int = 32, **kw) -> StarkConfig:
    last = int(WORK.trace(trace_len, start, P)[-1])
    return StarkConfig(trace_len=trace_len, n_queries=n_queries, boundary_first=start,
                       boundary_last=last, air=WORK, **kw)


def reference_proof(cfg: StarkConfig, start: int) -> tuple:
    """The plain reference's (state, data) of the port config's statement."""
    st = statement.Statement(
        name="work", air=cfg.air.name, trace_len=cfg.trace_len, blowup=cfg.blowup,
        coset_offset=cfg.coset_offset, n_queries=cfg.n_queries, p=P, generator=5,
        boundary_first=cfg.boundary_first, boundary_last=cfg.boundary_last, secret=start)
    return reference.prove(st, start)


@functools.lru_cache(maxsize=None)
def cpu_proof(trace_len: int, n_queries: int, start: int) -> Proof:
    return prove(config(trace_len, start, n_queries), start, device="cpu")


@pytest.mark.parametrize("start", range(3))
@pytest.mark.parametrize("n_queries", [32, 1])
@pytest.mark.parametrize("trace_len", [63, 255])
def test_prove_equals_reference(trace_len, n_queries, start):
    s = STARTS[start]
    cfg = config(trace_len, s, n_queries)
    got = cpu_proof(trace_len, n_queries, s)
    assert (got.state, got.data) == reference_proof(cfg, s)
    assert len(got.data) == expected_proof_len(cfg)
    verify(got, cfg)


@pytest.mark.parametrize("at", ["root", "opening", "state"])
def test_verifier_rejects_a_flipped_byte(at):
    s = STARTS[0]
    proof = cpu_proof(63, 32, s)
    if at == "state":
        state, data = bytearray(proof.state), proof.data
        state[5] ^= 1
    else:
        state, data = proof.state, bytearray(proof.data)
        data[3 if at == "root" else len(data) - 100] ^= 1
    with pytest.raises(VerificationError):
        verify(Proof(state=bytes(state), data=bytes(data)), config(63, s))


@pytest.mark.parametrize("public", ["boundary_last", "boundary_first"])
def test_verifier_rejects_other_public_values(public):
    s = STARTS[1]
    cfg = config(63, s)
    other = StarkConfig(**{**{k: getattr(cfg, k) for k in (
        "trace_len", "blowup", "coset_offset", "boundary_first", "boundary_last",
        "n_queries", "air", "field")}, public: (getattr(cfg, public) + 1) % P})
    with pytest.raises(VerificationError):
        verify(cpu_proof(63, 32, s), other)


@pytest.mark.parametrize("name,extra", [("fibonacci-sq", 0), ("fibonacci", 0),
                                        ("square-chain", 0), ("winterfell-work", 1)])
@pytest.mark.parametrize("trace_len", [63, 1023, (1 << 20) - 1])
def test_fri_rounds_follow_the_composition_degree(name, extra, trace_len):
    cfg = StarkConfig(trace_len=trace_len, air=AIRS[name], boundary_last=0)
    n = trace_len + 1
    assert cfg.fri_rounds == n.bit_length() - 1 + extra
    assert cfg.eval_domain >> cfg.fri_rounds == (4 if extra else 8)


def test_last_fri_layer_is_constant_only_after_log2_2n_rounds():
    """The composition has degree 2(n − 2): after log2 n folds a layer of 8
    points still holds a line, after log2(2n) the 4 points are one value,
    the free term."""
    from zkstark_tpu_torch.protocol.prover import ProverArtifacts

    s = STARTS[2]
    cfg = config(63, s, n_queries=1)
    art = ProverArtifacts()
    got = prove(cfg, s, device="cpu", fused=False, artifacts=art)
    assert got == cpu_proof(63, 1, s)
    layers = [fp.to_host(r) for r in art.layer_res]
    assert len(layers) == 1 + cfg.fri_rounds == 1 + 7
    last, before = layers[-1], layers[6]
    assert last.shape == (4,) and len(set(last.tolist())) == 1
    assert before.shape == (8,) and len(set(before.tolist())) > 1


@pytest.mark.parametrize("blowup,ok", [(1, False), (2, False), (4, True)])
def test_blowup_below_the_composition_degree_is_refused(blowup, ok):
    if ok:
        assert config(63, STARTS[0], blowup=blowup).fri_rounds == 7
    else:
        with pytest.raises(ValueError, match="blowup"):
            config(63, STARTS[0], blowup=blowup)


def test_verify_native_refuses_the_work_air():
    s = STARTS[0]
    with pytest.raises(ValueError, match="7 FRI rounds.*log2\\(trace domain\\) = 6"):
        verify_native(cpu_proof(63, 32, s), config(63, s))


@pytest.mark.parametrize("n_queries", [32, 1])
def test_decommit_counts_openings_and_bytes_once_a_proof(n_queries):
    s = STARTS[1]
    cfg = config(63, s, n_queries)
    tracing.reset()
    got = prove(cfg, s, device="cpu")
    counters = tracing.totals()["counters"]
    openings = n_queries * (2 + 1 + cfg.fri_rounds)
    head = 32 * (2 + cfg.fri_rounds) + 4 + 4 * (cfg.n_constraints + cfg.fri_rounds + n_queries)
    assert counters["decommit.openings"] == openings
    assert counters["decommit.bytes"] == len(got.data) - head


# ---- on the card ----

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_ROWS = 2047  # 2^14 points: under graph.GRAPH_POINTS


@pytest.mark.cuda
def test_card_prove_equals_cpu_and_reference(dev):
    for s in STARTS[:2]:
        cfg = config(CARD_ROWS, s)
        got = prove(cfg, s, device=dev)
        assert got == prove(cfg, s, device="cpu")
        assert (got.state, got.data) == reference_proof(cfg, s)
        verify(got, cfg)


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(dev, monkeypatch):
    from zkstark_tpu_torch.protocol import fused, graph

    monkeypatch.setattr(fused, "_GRAPHS", graph.CoreGraphs(fused._core))
    tracing.reset()
    cfgs = {s: config(CARD_ROWS, s) for s in STARTS[:2]}
    got = [prove(cfgs[s], s, device=dev) for s in STARTS[:2] * 3]
    assert {k: n for k, n in tracing.totals()["counters"].items() if k.startswith("graph.")} \
        == {"graph.eager": 2, "graph.capture": 2, "graph.replay": 2}
    for k, s in enumerate(STARTS[:2] * 3):
        assert got[k] == got[k % 2] == prove(cfgs[s], s, device=dev, fused=False)
