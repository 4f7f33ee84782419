"""The SHA-256 kernels on the TPU kernels' own word-plane layout, against the
JAX package's planar functions, on the CPU.

`leaf_planes`, `node_planes`, `node_planes_folded` and `planes_to_rowmajor`
(``zkstark_tpu_torch/ops/sha256_kernel.py``) take flat (8, n) planes; the
JAX functions take (8, n/128, 128), compared here reshaped to (8, n). The JAX
side runs as ``tests/test_pallas_sha256.py`` runs it on the CPU: the Pallas
calls replaced by jnp twins under ``ZKSTARK_PALLAS=interpret``. Then the
chain of `hash.merkle.build_levels(..., planar_stop=...)`, every level equal
to the row-major `build_levels` and to the JAX package's planar chain
(levels turned natural), at 2^11 to 2^14 leaves. Tolerance: none, every word
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.hash import sha256 as jsha
from zkstark_tpu.ops import sha256_kernel as jsk
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import sha256_kernel as sk


@pytest.fixture(autouse=True)
def one_thread():
    """Hashing 2^14 words on every core oversubscribes the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jnp_leaf(flat):
    n = flat.shape[0]
    z = jnp.zeros((n,), dtype=jnp.uint32)
    block = jnp.stack(
        [flat, jnp.full((n,), 0x80000000, dtype=jnp.uint32)] + [z] * 13
        + [jnp.full((n,), 32, dtype=jnp.uint32)],
        axis=-1,
    )
    return jsha.compress(jnp.broadcast_to(jnp.asarray(jsha._H0), (n, 8)), block)


@pytest.fixture
def jax_planar(monkeypatch):
    """The JAX planar functions on the CPU: the Pallas calls as jnp twins."""

    def leaf_call(vals2d, interpret):
        return _jnp_leaf(vals2d.reshape(-1)).T.reshape(8, -1, 128)

    def node_call(blocks, interpret):
        left = blocks[:8].reshape(8, -1).T
        right = blocks[8:].reshape(8, -1).T
        return jsha.node_hash(left, right).T.reshape(8, -1, 128)

    monkeypatch.setenv("ZKSTARK_PALLAS", "interpret")
    monkeypatch.setattr(jsk, "_leaf_call", leaf_call)
    monkeypatch.setattr(jsk, "_node_call", node_call)
    return monkeypatch


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _planes(a):
    """JAX (8, m, 128) planes as flat (8, n) numpy."""
    return np.asarray(a).reshape(8, -1)


@pytest.mark.parametrize("n", [1024, 4096])
def test_leaf_planes(jax_planar, n):
    vals = _words(n, seed=n)
    got = fp.to_host(sk.leaf_planes(fp.from_host(vals, "cpu")))
    np.testing.assert_array_equal(got, _planes(jsk.leaf_planes(jnp.asarray(vals))))
    np.testing.assert_array_equal(got.T, fp.to_host(sk.leaf_hash(fp.from_host(vals, "cpu"))))


@pytest.mark.parametrize("n", [2048, 8192])
@pytest.mark.parametrize("folded", [False, True])
def test_node_planes(jax_planar, n, folded):
    planes = _words((8, n), seed=n + folded)
    port = sk.node_planes_folded if folded else sk.node_planes
    jax_fn = jsk.node_planes_folded if folded else jsk.node_planes
    got = fp.to_host(port(fp.from_host(planes, "cpu")))
    assert got.shape == (8, n // 2)
    np.testing.assert_array_equal(got, _planes(jax_fn(jnp.asarray(planes.reshape(8, -1, 128)))))


def test_node_planes_is_node_hash_pairs():
    """The interleaved form pairs children 2j and 2j+1 as the row-major
    kernel does."""
    planes = _words((8, 256), seed=5)
    rows = fp.from_host(np.ascontiguousarray(planes.T), "cpu")
    np.testing.assert_array_equal(fp.to_host(sk.node_planes(fp.from_host(planes, "cpu"))).T,
                                  fp.to_host(sk.node_hash_pairs(rows)))


@pytest.mark.parametrize("n", [1024, 4096])
def test_planes_to_rowmajor(n):
    planes = _words((8, n), seed=n)
    got = fp.to_host(sk.planes_to_rowmajor(fp.from_host(planes, "cpu")))
    want = np.asarray(jsk.planes_to_rowmajor(jnp.asarray(planes.reshape(8, -1, 128))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1024, 8192])
def test_planar_to_natural(n):
    planes = _words((8, n), seed=n + 1)
    got = fp.to_host(merkle.planar_to_natural(fp.from_host(planes, "cpu")))
    want = np.asarray(jmerkle.planar_to_natural(jnp.asarray(planes.reshape(8, -1, 128))))
    np.testing.assert_array_equal(got, want)


def test_min_batch():
    """The kernels take any batch: one hash is a launch of its own."""
    assert sk.MIN_BATCH == 1
    vals = _words(1, seed=9)
    np.testing.assert_array_equal(fp.to_host(sk.leaf_planes(fp.from_host(vals, "cpu"))).T,
                                  np.asarray(jsha.leaf_hash(jnp.asarray(vals))))


@pytest.mark.parametrize("log_n", [11, 12, 13, 14])
def test_chain_levels(jax_planar, log_n):
    """Every level of the plane-major chain equals the row-major tree's, and
    the JAX package's planar chain with the same stop (levels turned natural)."""
    n = 1 << log_n
    stop = 2048  # the JAX chain's least planar level: two grid steps of parents
    vals = _words(n, seed=log_n)
    t = fp.from_host(vals, "cpu")
    want = merkle.build_levels(t)
    got = merkle.build_levels(t, planar_stop=stop)
    assert len(got) == len(want) == log_n + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_array_equal(fp.to_host(g), fp.to_host(w))
    jax_planar.setattr(jmerkle, "PLANAR_MIN", n)
    jax_planar.setattr(jmerkle, "PLANAR_STOP", stop)
    jlevels = jmerkle.build_levels(jnp.asarray(vals))
    assert jmerkle.is_planar(jlevels[0])
    for g, j in zip(got, jlevels):
        assert merkle.level_size(g) == jmerkle.level_size(j)
        j = jmerkle.planar_to_natural(j) if jmerkle.is_planar(j) else j
        np.testing.assert_array_equal(fp.to_host(g), np.asarray(j))


@pytest.mark.parametrize("stop", [1, 2, 512])
def test_chain_any_stop(stop):
    """The chain at any stop, down to the root in planes."""
    t = fp.from_host(_words(1 << 10, seed=stop), "cpu")
    for g, w in zip(merkle.build_levels(t, planar_stop=stop), merkle.build_levels(t)):
        np.testing.assert_array_equal(fp.to_host(g), fp.to_host(w))
