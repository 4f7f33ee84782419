"""The port's batched one-fetch prover equals the JAX package's, exactly.

`build_levels_batch` against the JAX one; every leaf of `fused_core_batch`'s
dict (roots, challenges, openings) against the JAX dict for B = 3 random
traces at trace_len 63, and `fused_core` against the JAX solo core;
`prove_batch` bytes against solo `prove` and the JAX proof; a bad secret
raises ValueError; a tampered fetched challenge raises
`DeviceChannelMismatch`. Everything on the CPU, where the kernel wrappers run
their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkstark_tpu.protocol as jproto
from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.protocol import batch as jbatch
from zkstark_tpu.protocol import fused as jfused
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.hash import merkle as tmerkle
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import batch as tbatch
from zkstark_tpu_torch.protocol import fused as tfused
from zkstark_tpu_torch.protocol import prove
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol.config import StarkConfig

SECRET = 3141592
TRACE_LEN = 63


def _configs(n_queries=1):
    trace = tair.fibonacci_sq_trace(TRACE_LEN, SECRET)
    kw = dict(trace_len=TRACE_LEN, boundary_last=int(trace[-1]), n_queries=n_queries)
    return JaxConfig(**kw), StarkConfig(**kw)


def _t(a):
    return tfp.from_host(np.asarray(a, dtype=np.uint32), "cpu")


def _eq(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_array_equal(tfp.to_host(got), want, err_msg=what)


def _assert_tree_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], list):
            assert len(got[key]) == len(want[key]), key
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                _eq(g, w, f"{key}[{i}]")
        else:
            _eq(got[key], want[key], key)


@pytest.mark.parametrize("bsz,n", [(1, 1), (1, 64), (3, 8), (5, 32)])
def test_build_levels_batch_matches_jax(bsz, n):
    rng = np.random.default_rng(bsz * 100 + n)
    vals = rng.integers(0, 1 << 32, (bsz, n), dtype=np.uint64).astype(np.uint32)
    want = jmerkle.build_levels_batch(jnp.asarray(vals))
    got = tmerkle.build_levels_batch(_t(vals))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)
    solo = tmerkle.build_levels(_t(vals[0]))
    for g, s in zip(got, solo):
        _eq(s, tfp.to_host(g)[0])


@pytest.mark.parametrize("n_queries", [1, 3])
def test_fused_core_batch_matches_jax(n_queries):
    """Random traces (not witnesses: the core does not check the AIR)."""
    jcfg, cfg = _configs(n_queries)
    rng = np.random.default_rng(42 + n_queries)
    traces = cfg.field.host_to_mont(rng.integers(0, cfg.field.p, (3, TRACE_LEN), dtype=np.uint64))
    want = jbatch.fused_core_batch(jcfg, jnp.asarray(traces))
    got = tfused.fused_core_batch(cfg, _t(traces))
    _assert_tree_equal(got, want)
    assert tbatch.fused_core_batch is tfused.fused_core_batch
    # the shapes the host unpacks by, and the round trip through one vector
    shapes = tfused.out_shapes(cfg, (3,))
    flat = tfp.to_host(tfused.pack_tree(got))
    back = tfused.unpack_tree(flat, shapes)
    _assert_tree_equal({k: [_t(a) for a in v] if isinstance(v, list) else _t(v)
                        for k, v in back.items()}, want)


def test_fused_core_matches_jax():
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    trace = cfg.field.host_to_mont(rng.integers(0, cfg.field.p, TRACE_LEN, dtype=np.uint64))
    want = jfused.fused_core(jcfg, jnp.asarray(trace))
    got = tfused.fused_core(cfg, _t(trace))
    _assert_tree_equal(got, want)
    flat = tfp.to_host(tfused.fused_core_packed(cfg, _t(trace)))
    back = tfused.unpack_out(cfg, flat)
    np.testing.assert_array_equal(back["roots"], np.asarray(want["roots"]))
    assert back["free_term"].shape == ()


def test_prove_batch_bytes_equal_solo_and_jax():
    jcfg, cfg = _configs()
    want = jproto.prove(jcfg, SECRET)
    solo = prove(cfg, SECRET, device="cpu")
    assert (solo.state, solo.data) == (want.state, want.data)
    proofs = tbatch.prove_batch(cfg, [SECRET] * 3, device="cpu")
    assert len(proofs) == 3
    for p in proofs:
        assert (p.state, p.data) == (want.state, want.data)


def test_prove_batch_distinct_secrets():
    """Each proof of a batch follows its own chain: a square-chain batch of
    different witnesses for different public outputs is not provable in one
    config, so two batches of one secret each must differ from each other
    and equal their solo proofs."""
    air = tair.SQUARE_CHAIN
    for secret in (5, 6):
        trace = air.trace(TRACE_LEN, secret)
        cfg = StarkConfig(trace_len=TRACE_LEN, boundary_last=int(trace[-1]), air=air)
        assert tbatch.prove_batch(cfg, [secret, secret], device="cpu") == [
            prove(cfg, secret, device="cpu", fused=False)
        ] * 2


def test_bad_secret_raises_value_error():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="witness 1"):
        tbatch.prove_batch(cfg, [SECRET, SECRET + 1], device="cpu")
    with pytest.raises(ValueError):
        prove(cfg, SECRET + 1, device="cpu")


def test_entry_points_need_a_card_by_default():
    _, cfg = _configs()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tbatch.prove_batch(cfg, [SECRET]),
                 lambda: tbatch.prove_batch_pipelined(cfg, [[SECRET]]),
                 lambda: tpr.prove_pipelined(cfg, [SECRET])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("key,index", [("alphas", 1), ("betas", 0), ("queries", 0)])
def test_tampered_challenge_raises_mismatch(key, index):
    _, cfg = _configs()
    trace = tpr.trace_to_device(cfg, SECRET, "cpu")
    out = tfused.unpack_out(cfg, tfp.to_host(tfused.fused_core_packed(cfg, trace)).copy())
    assert tpr.finish_fused(cfg, out) == prove(cfg, SECRET, device="cpu", fused=False)
    out[key][index] ^= 1
    with pytest.raises(tpr.DeviceChannelMismatch, match=key[:-1].replace("querie", "query")):
        tpr.finish_fused(cfg, out)


def test_tampered_batch_names_the_proof(monkeypatch):
    _, cfg = _configs()
    real = tfused.unpack_tree

    def tampered(flat, shapes):
        out = real(np.array(flat), shapes)
        out["betas"][2, 3] ^= 1
        return out

    monkeypatch.setattr(tfused, "unpack_tree", tampered)
    with pytest.raises(tpr.DeviceChannelMismatch, match=r"proof 2 beta\[3\]"):
        tbatch.prove_batch(cfg, [SECRET] * 3, device="cpu")
