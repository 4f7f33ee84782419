"""The port's plain-torch field ops equal zkstark_tpu.field.fp bit for bit.

The JAX package's two protocol primes (3·2^30+1 and 15·2^27+1) and its
small test primes (4391, 101, 7), on random values
from a seeded numpy generator and on the edge values 0, 1, p−2, p−1, 2^31
and 2^32−1. Edge values at or above p are outside REDC's precondition; the
port reproduces the JAX results there too, so they are compared as well.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu_torch.field import fp as tfp

# The two protocol primes, and the small primes of tests/test_field_generic.py
# (keyed by name: "p101" is the prime 101, "stark101" is 3·2^30+1).
FIELDS = {
    "stark101": (jfp.FIELD101, tfp.FIELD101),
    "alt": (jfp.FIELD_ALT, tfp.FIELD_ALT),
    **{f"p{p}": (jfp.field_for(p), tfp.field_for(p)) for p in (4391, 101, 7)},
}


def _edges(p):
    return np.array([0, 1, p - 2, p - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)


def _operands(p, seed):
    """Random u32 pairs (reduced and unreduced) plus every pair of edges."""
    rng = np.random.default_rng(seed)
    e = _edges(p)
    pairs = np.array(list(itertools.product(e, e)), dtype=np.uint32)
    reduced = rng.integers(0, p, (4096, 2), dtype=np.uint64).astype(np.uint32)
    anyu32 = rng.integers(0, 1 << 32, (1024, 2), dtype=np.uint64).astype(np.uint32)
    ops = np.concatenate([pairs, reduced, anyu32])
    return ops[:, 0].copy(), ops[:, 1].copy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(params=sorted(FIELDS), scope="module")
def fields(request):
    return FIELDS[request.param]


@pytest.mark.parametrize("op", ["mont_mul_f", "mont_reduce_f", "add_f", "sub_f"])
def test_binary_ops(fields, op):
    jf, tf = fields
    a, b = _operands(jf.p, seed=1)
    want = getattr(jfp, op)(jf, jnp.asarray(a), jnp.asarray(b))
    _eq(getattr(tfp, op)(tf, _t(a), _t(b)), want)


@pytest.mark.parametrize("op", ["neg_f", "to_mont_f", "from_mont_f", "inv_f"])
def test_unary_ops(fields, op):
    jf, tf = fields
    a, _ = _operands(jf.p, seed=2)
    _eq(getattr(tfp, op)(tf, _t(a)), getattr(jfp, op)(jf, jnp.asarray(a)))


def test_mont_mul_matches_integers(fields):
    """On reduced inputs: a·b·R^{-1} mod p with Python ints."""
    _, tf = fields
    p = tf.p
    a, b = _operands(p, seed=3)
    keep = (a < p) & (b < p)
    a, b = a[keep], b[keep]
    got = tfp.mont_mul_f(tf, _t(a), _t(b)).numpy()
    r_inv = pow(1 << 32, p - 2, p)
    want = [int(x) * int(y) * r_inv % p for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint32))


def test_pow_static_and_powers_iota(fields):
    jf, tf = fields
    a, _ = _operands(jf.p, seed=4)
    for e in (0, 1, 5, 1 << 10, jf.p - 2):
        _eq(tfp.pow_static_f(tf, _t(a), e), jfp.pow_static_f(jf, jnp.asarray(a), e))
    for n, base, scale in ((1, 7, 1), (1024, 5, 3), (1 << 13, tf.generator, 5)):
        _eq(
            tfp.powers_iota_f(tf, base, n, scale, device="cpu"),
            jfp.powers_iota_f(jf, base, n, scale),
        )


def test_host_helpers_and_constants(fields):
    jf, tf = fields
    assert (tf.r_mod_p, tf.r2_mod_p, tf.p_inv_neg) == (
        jf.r_mod_p,
        jf.r2_mod_p,
        jf.p_inv_neg,
    )
    assert tf.generator == jf.generator
    order = 1 << min(10, tf.two_adicity)
    assert tf.subgroup_generator(order) == jf.subgroup_generator(order)
    assert tf.mont_scalar(12345) == int(jf.mont_scalar(12345))
    bases = np.array([2, 3, jf.p - 1], dtype=np.uint32)
    np.testing.assert_array_equal(tf.host_vandermonde(bases, 8), jf.host_vandermonde(bases, 8))
    np.testing.assert_array_equal(tf.host_pow_vec(bases, 77), jf.host_pow_vec(bases, 77))
    np.testing.assert_array_equal(tf.host_inv_vec(bases), jf.host_inv_vec(bases))
    np.testing.assert_array_equal(
        tf.host_powers_pow2(5, 64, 3), jf.host_powers_pow2(5, 64, 3)
    )


def test_composite_modulus_rejected():
    with pytest.raises(ValueError):
        tfp.Field(4391 * 7)
    assert tfp.Field(4391).p == 4391
