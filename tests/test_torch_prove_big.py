"""`tools.prove_big` checks its proof three ways (the port's verifier, the
C++ verifier, the proof layout's length) and says so in its record, and
`prover.composition_constants` is cached by bytes, not by count. All on the
CPU at small sizes.
"""

import shutil

import numpy as np
import pytest
import torch

from zkstark_tpu_torch.protocol import STARK101, prover
from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.proof import expected_proof_len
from zkstark_tpu_torch.tools import prove_big


@pytest.mark.parametrize("trace_bits,queries", [(6, 1), (8, 2)])
def test_prove_big_record_holds_both_verifiers_and_the_layout(trace_bits, queries):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ verifier")
    steps = []
    proof, cfg, rec = prove_big.run(trace_bits, queries=queries, repeats=1, device="cpu",
                                    emit=steps.append)
    assert steps[-1] is rec and [s.get("step") for s in steps[:2]] == ["witness", "cold_prove"]
    assert rec["verified"] is True and rec["verified_native"] is True
    assert rec["layout_ok"] is True
    assert rec["layout_bytes"] == rec["proof_bytes"] == len(proof.data) == expected_proof_len(cfg)
    assert rec["verify_seconds"] >= 0 and rec["verify_native_seconds"] >= 0
    assert rec["metric"] == f"prove_latency_2e{trace_bits + 3}" and rec["device"] == "cpu"


def test_prove_big_raises_when_the_layout_disagrees(monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ verifier")
    from zkstark_tpu_torch.protocol import proof as proof_mod

    monkeypatch.setattr(proof_mod, "expected_proof_len", lambda cfg: 1)
    steps = []
    with pytest.raises(AssertionError, match="layout"):
        prove_big.run(6, repeats=1, device="cpu", emit=steps.append)
    assert steps[-1]["layout_ok"] is False and steps[-1]["layout_bytes"] == 1


@pytest.mark.parametrize("cfg,want", [
    (STARK101, 7836),  # the golden transcript
    (StarkConfig(trace_len=(1 << 21) - 1, boundary_last=1, air=SQUARE_CHAIN), 22496),
    (StarkConfig(trace_len=(1 << 22) - 1, boundary_last=1, air=SQUARE_CHAIN), 24252),
    (StarkConfig(trace_len=(1 << 24) - 1, boundary_last=1, air=SQUARE_CHAIN), 27956),
])
def test_expected_proof_len_gives_the_known_lengths(cfg, want):
    assert expected_proof_len(cfg) == want


def _cfg(trace_bits: int) -> StarkConfig:
    return StarkConfig(trace_len=(1 << trace_bits) - 1, boundary_last=1, air=SQUARE_CHAIN)


def test_composition_constants_cache_is_bounded_by_bytes(monkeypatch):
    cache = prover.composition_constants
    cache.cache_clear()
    small, mid, big = _cfg(5), _cfg(6), _cfg(7)  # 2 KB, 4 KB and 8 KB of constants
    sizes = [c.n_constraints * c.eval_domain * 4 for c in (small, mid, big)]
    assert sizes == [2048, 4096, 8192]
    monkeypatch.setattr(prover, "_CONST_CACHE_BYTES", 7000)
    a = cache(small, "cpu")
    assert cache(small, "cpu") is a and cache.cached_bytes() == 2048  # a hit
    b = cache(mid, "cpu")
    assert cache.cached_bytes() == 2048 + 4096  # both fit the budget
    assert cache(small, "cpu") is a  # a hit makes `small` the newest
    c = cache(big, "cpu")  # 14 KB held: the oldest go until what is left fits
    assert cache.cached_bytes() == 8192  # ... or only the newest is left, over budget
    assert cache(big, "cpu") is c
    assert cache(mid, "cpu") is not b  # evicted, built anew; `big` goes in turn
    assert cache.cached_bytes() == 4096
    np.testing.assert_array_equal(cache(mid, "cpu").numpy(), b.numpy())
    cache.cache_clear()
    assert cache.cached_bytes() == 0


def test_composition_constants_cache_keeps_many_small_entries():
    cache = prover.composition_constants
    cache.cache_clear()
    held = [cache(_cfg(bits), "cpu") for bits in (4, 5, 6, 7, 8, 9)]  # six: lru_cache kept four
    for bits, t in zip((4, 5, 6, 7, 8, 9), held):
        assert cache(_cfg(bits), "cpu") is t
    assert isinstance(held[0], torch.Tensor) and cache.__name__ == "composition_constants"
    cache.cache_clear()
