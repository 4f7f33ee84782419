"""The members the parity walk found missing, held against the JAX package
exactly (tolerance 0: no floats):

  * the ten device-op methods of the port's `Field` against the JAX
    `Field`'s, for the stark-101 prime and the alt prime, on seeded numpy
    inputs (`device_powers` and `powers_iota` through the powers kernel's
    plain twin on the CPU);
  * `MerkleTree.num_leaves` and `ResumableProver.PHASES`;
  * `prove(..., channel=)`: a caller's seeded channel on the host-synced path
    gives the JAX package's bytes, and on the fused path, whose device chain
    starts from the zero state, raises `DeviceChannelMismatch` as the JAX
    package's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.protocol import checkpoint as jcheckpoint
from zkstark_tpu.protocol import prove as jprove
from zkstark_tpu.protocol.config import STARK101 as JSTARK101
from zkstark_tpu.transcript import Channel as JChannel
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.hash import merkle as tmerkle
from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, checkpoint, prove
from zkstark_tpu_torch.protocol.prover import DeviceChannelMismatch
from zkstark_tpu_torch.transcript import Channel

PRIMES = [tfp.P, tfp.P_ALT]
SEED = b"a caller's transcript prefix"


def _inputs(p, seed, n=257):
    rng = np.random.default_rng(seed)
    fld = tfp.field_for(p)
    a = fld.host_to_mont(rng.integers(0, p, n, dtype=np.uint64))
    b = fld.host_to_mont(rng.integers(0, p, n, dtype=np.uint64))
    a[:3] = [0, 1, p - 1]  # edge words
    return a, b


def _eq(got, want):
    np.testing.assert_array_equal(tfp.to_host(got), np.asarray(want))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("name", ["mont_mul", "add", "sub"])
def test_binary_methods(p, name):
    a, b = _inputs(p, seed=len(name))
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    _eq(getattr(tf, name)(tfp.from_host(a, "cpu"), tfp.from_host(b, "cpu")),
        getattr(jf, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("name", ["to_mont", "from_mont", "neg", "inv"])
def test_unary_methods(p, name):
    a, _ = _inputs(p, seed=10 + len(name))
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    _eq(getattr(tf, name)(tfp.from_host(a, "cpu")), getattr(jf, name)(jnp.asarray(a)))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("e", [0, 1, 5, 1 << 20])
def test_pow_static(p, e):
    a, _ = _inputs(p, seed=e)
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    _eq(tf.pow_static(tfp.from_host(a, "cpu"), e), jf.pow_static(jnp.asarray(a), e))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [1, 2, 64, 1 << 12])
def test_device_powers_and_powers_iota(p, n):
    tf, jf = tfp.field_for(p), jfp.field_for(p)
    base = tf.subgroup_generator(1 << 12)
    _eq(tf.device_powers(base, n, device="cpu"), jf.device_powers(base, n))
    _eq(tf.powers_iota(base, n, scale=7, device="cpu"), jf.powers_iota(base, n, 7))
    _eq(tf.powers_iota(base, n, device="cpu"), jf.device_powers(base, n))


def test_device_methods_default_to_the_card():
    """Without a card, the methods raise rather than fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for fn in (lambda: tfp.FIELD101.device_powers(3, 8),
               lambda: tfp.FIELD_ALT.powers_iota(3, 8, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


@pytest.mark.parametrize("n", [1, 2, 64])
def test_num_leaves(n):
    vals = np.arange(n, dtype=np.uint32)
    got = tmerkle.MerkleTree.commit(tfp.from_host(vals, "cpu")).num_leaves
    assert got == jmerkle.MerkleTree.commit(jnp.asarray(vals)).num_leaves == n


def test_phases():
    assert checkpoint.ResumableProver.PHASES == jcheckpoint.ResumableProver.PHASES
    assert set(checkpoint.PHASE_KEYS) == set(checkpoint.ResumableProver.PHASES) - {"done"}


def test_resumable_prover_refuses_an_unknown_phase(tmp_path):
    rp = checkpoint.ResumableProver(STARK101, STARK101_SECRET, str(tmp_path / "c.npz"),
                                    device="cpu")
    with pytest.raises(ValueError, match="phase2"):
        rp.run(stop_after="phase_2")


def _seeded(cls):
    ch = cls()
    ch.commit_bytes(SEED)
    return ch


def test_prove_into_a_seeded_channel():
    """The host-synced path commits to the caller's channel: JAX's bytes."""
    want = jprove(JSTARK101, STARK101_SECRET, channel=_seeded(JChannel), fused=False)
    got = prove(STARK101, STARK101_SECRET, device="cpu", fused=False, channel=_seeded(Channel))
    assert (got.state, got.data) == (want.state, want.data)
    assert got != prove(STARK101, STARK101_SECRET, device="cpu", fused=False)


def test_fused_prove_refuses_a_seeded_channel():
    """The device chain starts from the zero state: the replay through a
    seeded channel disagrees at the first challenge, as in the JAX package."""
    with pytest.raises(DeviceChannelMismatch, match="alpha"):
        prove(STARK101, STARK101_SECRET, device="cpu", channel=_seeded(Channel))
    # a new channel is the default
    assert prove(STARK101, STARK101_SECRET, device="cpu", channel=Channel()) == \
        prove(STARK101, STARK101_SECRET, device="cpu")
