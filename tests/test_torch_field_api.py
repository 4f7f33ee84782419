"""The field module's public API of the JAX package, in the port: the
protocol field's constants, its ops as module functions, the device powers
and the host helpers, each equal to ``zkstark_tpu.field.fp``'s on the same
numpy-seeded inputs (words bit for bit, integers exactly).

Operands: random Montgomery words of both protocol primes, the edges 0, 1,
p − 2, p − 1, and unreduced words (2^31, 2^32 − 1, random u32) where the JAX
function accepts them (the module functions are bound to 3·2^30+1; the
`*_f` forms take `FIELD_ALT`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkstark_tpu.field as jfield
from zkstark_tpu.field import fp as jfp
import zkstark_tpu_torch.field as tfield
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.transcript import device_channel as tdc

PRIMES = [tfp.P, tfp.P_ALT]


def _words(p, seed, n=2048):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, p - 2, p - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint64)
    mont = jfp.field_for(p).host_to_mont(rng.integers(0, p, n, dtype=np.uint64))
    anyu32 = rng.integers(0, 1 << 32, n // 4, dtype=np.uint64)
    return np.concatenate([edges, mont, anyu32]).astype(np.uint32)


def _t(a):
    return tfp.from_host(np.asarray(a, dtype=np.uint32), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(tfp.to_host(got), np.asarray(want))


def test_all_is_a_superset():
    assert set(jfield.__all__) <= set(tfield.__all__)
    for name in tfield.__all__:
        assert hasattr(tfield, name), name


@pytest.mark.parametrize("name", ["TWO_ADICITY", "GENERATOR", "R_MOD_P", "R2_MOD_P",
                                  "P_INV_NEG", "P", "P_ALT"])
def test_constants(name):
    assert getattr(tfp, name) == getattr(jfp, name)
    assert getattr(tfield, name) == getattr(jfield, name)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_module_ops(op):
    a, b = _words(tfp.P, 1), _words(tfp.P, 2)[::-1].copy()
    _eq(getattr(tfp, op)(_t(a), _t(b)), getattr(jfp, op)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["to_mont", "from_mont", "neg", "inv"])
def test_unary_module_ops(op):
    a = _words(tfp.P, 3)
    _eq(getattr(tfp, op)(_t(a)), getattr(jfp, op)(jnp.asarray(a)))


@pytest.mark.parametrize("e", [0, 1, 2, 5, 97, (1 << 32) + 3])
def test_pow_static(e):
    a = _words(tfp.P, 4, n=512)
    _eq(tfp.pow_static(_t(a), e), jfp.pow_static(jnp.asarray(a), e))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [1, 2, 64, 1024])
def test_device_powers_f(p, n):
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    base = tf.subgroup_generator(1024) if n > 1 else 7
    _eq(tfp.device_powers_f(tf, base, n, device="cpu"), jfp.device_powers_f(jf, base, n))


@pytest.mark.parametrize("n", [1, 8, 4096])
def test_device_powers_and_powers_iota(n):
    base = tfp.subgroup_generator(4096)
    _eq(tfp.device_powers(base, n, device="cpu"), jfp.device_powers(base, n))
    _eq(tfp.powers_iota(base, n, 11, device="cpu"), jfp.powers_iota(base, n, 11))


def test_new_device_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for fn in (lambda: tfp.device_powers(3, 8), lambda: tfp.powers_iota(3, 8),
               lambda: tfp.device_powers_f(tfp.FIELD_ALT, 3, 8),
               lambda: tfp.powers_iota_f(tfp.FIELD_ALT, 3, 8), lambda: tdc.zero_state((2,))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


@pytest.mark.parametrize("p", PRIMES + [4391, 101, 7])
def test_find_generator_and_order(p):
    """As tests/test_field_generic.py does: the generator has order p − 1."""
    g = tfp.find_generator(p)
    assert g == jfp.find_generator(p)
    assert tfp.multiplicative_order(g, p) == p - 1 == tfp.field_for(p).multiplicative_order(g)
    rng = np.random.default_rng(p)
    for x in [1, p - 1, 2, *rng.integers(1, p, 8).tolist()]:
        assert tfp.multiplicative_order(int(x), p) == jfp.multiplicative_order(int(x), p)
        want = jfp.field_for(p).multiplicative_order(int(x))
        assert tfp.field_for(p).multiplicative_order(int(x)) == want
    with pytest.raises(ValueError):
        tfp.field_for(p).multiplicative_order(0)


@pytest.mark.parametrize("order", [1, 2, 1024, 1 << 30])
def test_subgroup_generator(order):
    assert tfp.subgroup_generator(order) == jfp.subgroup_generator(order)


@pytest.mark.parametrize("e", [0, 1, 7, -1, -5, (1 << 40) + 1])
def test_host_pow(e):
    for base in (2, 5, 3141592):
        assert tfp.host_pow(base, e) == jfp.host_pow(base, e)
        assert tfp.host_pow(base, e, tfp.P_ALT) == jfp.host_pow(base, e, jfp.P_ALT)


def test_host_helpers_module():
    rng = np.random.default_rng(8)
    a = rng.integers(0, tfp.P, 300, dtype=np.uint64).astype(np.uint32)
    a[:2] = [0, tfp.P - 1]
    np.testing.assert_array_equal(tfp.host_to_mont(a), jfp.host_to_mont(a))
    np.testing.assert_array_equal(tfp.host_powers(5, 100, 3), jfp.host_powers(5, 100, 3))
    np.testing.assert_array_equal(tfp.host_powers_pow2(5, 256, 9), jfp.host_powers_pow2(5, 256, 9))
    np.testing.assert_array_equal(tfp.host_vandermonde(a[:16], 40),
                                  jfp.host_vandermonde(a[:16], 40))
    np.testing.assert_array_equal(tfp.host_pow_vec(a, 12345), jfp.host_pow_vec(a, 12345))
    np.testing.assert_array_equal(tfp.host_inv_vec(a), jfp.host_inv_vec(a))


@pytest.mark.parametrize("p", PRIMES)
def test_host_powers_method(p):
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    np.testing.assert_array_equal(tf.host_powers(7, 64, 2), jf.host_powers(7, 64, 2))
