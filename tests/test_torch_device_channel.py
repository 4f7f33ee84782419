"""The port's device Fiat-Shamir chain equals the JAX package's, exactly.

Each function of `zkstark_tpu_torch.transcript.device_channel` (the plain
version of the CUDA kernel ``csrc/fs_chain.cu``) against
`zkstark_tpu.transcript.device_channel` on seeded random states for batch
shapes (), (1,) and (5,), draws ≥ 2^31 among them; `ops.fs_chain.chain_step`
(which runs that plain version on CPU tensors) against the same functions
composed; and a whole stark-101 chain against the host `Channel`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.transcript import device_channel as jdc
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import fs_chain
from zkstark_tpu_torch.protocol.config import STARK101
from zkstark_tpu_torch.transcript import Channel
from zkstark_tpu_torch.transcript import device_channel as tdc

SHAPES = [(), (1,), (5,)]
SHAPE_IDS = ["scalar", "b1", "b5"]


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.asarray(a, dtype=np.uint32)
    return tfp.from_host(np.atleast_1d(a), "cpu").reshape(a.shape)


def _state(shape, seed):
    s = _u32(shape + (8,), seed)
    s[..., 0] |= 0x80000000  # the draw (state word 0) is ≥ 2^31
    return s


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(tfp.to_host(got), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_zero_state_and_bswap(shape):
    _eq(tdc.zero_state(shape, "cpu"), jdc.zero_state(shape))
    x = _u32(shape, 1) | np.uint32(0x80000001)
    _eq(tdc.bswap32(_t(x)), jdc.bswap32(jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_absorb_hash_matches_jax(shape):
    state, digest = _state(shape, 2), _u32(shape + (8,), 3)
    want = jdc.absorb_hash(jnp.asarray(state), jnp.asarray(digest))
    _eq(tdc.absorb_hash(_t(state), _t(digest)), want)
    _eq(fs_chain.absorb_hash(_t(state), _t(digest)), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_absorb_u32_le_matches_jax(shape):
    state, word = _state(shape, 4), _u32(shape, 5) | np.uint32(0x80000000)
    want = jdc.absorb_u32_le(jnp.asarray(state), jnp.asarray(word))
    _eq(tdc.absorb_u32_le(_t(state), _t(word)), want)
    _eq(fs_chain.absorb_u32_le(_t(state), _t(word)), want)
    _eq(tdc.absorb_u32_le(_t(state), 0xFEDCBA98),
        jdc.absorb_u32_le(jnp.asarray(state), jnp.uint32(0xFEDCBA98)))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_draw_matches_jax(shape):
    state = _state(shape, 6)
    want_draw, want_state = jdc.draw_u32(jnp.asarray(state))
    assert int(np.asarray(want_draw).min()) >= 1 << 31
    got_draw, got_state = tdc.draw_u32(_t(state))
    _eq(got_draw, want_draw)
    _eq(got_state, want_state)
    for field, jfield in ((tfp.FIELD101, jfp.FIELD101), (tfp.FIELD_ALT, jfp.field_for(tfp.P_ALT))):
        _eq(tdc.draw_to_mont(got_draw, field), jdc.draw_to_mont(want_draw, jfield))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_chain_step_is_the_functions_composed(shape):
    """One boundary (digest, free term, four query draws) through the
    wrapper equals the JAX functions one after the other."""
    state, digest = _state(shape, 7), _u32(shape + (8,), 8)
    word = _u32(shape, 9) | np.uint32(0x80000000)
    js = jdc.absorb_hash(jnp.asarray(state), jnp.asarray(digest))
    js = jdc.absorb_u32_le(js, jnp.asarray(word))
    draws = []
    for _ in range(4):
        d, js = jdc.draw_u32(js)
        draws.append(np.asarray(d))
    want = np.stack(draws, axis=-1)
    new, got, mont, mod = fs_chain.chain_step(
        _t(state), digest=_t(digest), word=_t(word), draws=4, query_range=8176
    )
    _eq(new, js)
    _eq(got, want)
    _eq(mont, jdc.draw_to_mont(jnp.asarray(want)))
    _eq(mod, want % np.uint32(8176))
    again = fs_chain.draw(_t(state), 2)
    d0, s1 = jdc.draw_u32(jnp.asarray(state))
    d1, s2 = jdc.draw_u32(s1)
    _eq(again[0], s2)
    _eq(again[1], np.stack([np.asarray(d0), np.asarray(d1)], axis=-1))
    assert again[3] is None


def test_whole_stark101_chain_equals_the_host_channel():
    """The commit and draw order of a stark-101 proof (a root, three alphas,
    a root, ten times a beta and a root, the free term, the query) on seeded
    roots: every challenge equals the host channel's."""
    cfg = STARK101
    roots = _u32((2 + cfg.fri_rounds, 8), 10)
    free_term = 0x9ABCDEF0
    host = Channel()
    host.commit_hash(roots[0].astype(">u4").tobytes())
    want = [host.get_u32() for _ in range(cfg.n_constraints)]
    for layer in range(cfg.fri_rounds + 1):
        host.commit_hash(roots[1 + layer].astype(">u4").tobytes())
        if layer < cfg.fri_rounds:
            want.append(host.get_u32())
    host.commit_u32(free_term)
    want.append(host.get_u32())

    state = tdc.zero_state((), "cpu")
    state, alphas, _, _ = fs_chain.chain_step(state, digest=_t(roots[0]), draws=cfg.n_constraints)
    got = [int(v) for v in tfp.to_host(alphas)]
    for layer in range(cfg.fri_rounds):
        state, beta, _, _ = fs_chain.chain_step(state, digest=_t(roots[1 + layer]), draws=1)
        got.append(int(tfp.to_host(beta)[0]))
    state, q, _, mod = fs_chain.chain_step(
        state, digest=_t(roots[-1]), word=_t(np.uint32(free_term)), draws=1,
        query_range=cfg.query_range,
    )
    got.append(int(tfp.to_host(q)[0]))
    assert got == want
    assert int(tfp.to_host(mod)[0]) == want[-1] % cfg.query_range
    assert tfp.to_host(state).astype(">u4").tobytes() == host.state
