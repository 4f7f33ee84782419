"""The port's SHA-256 and Merkle trees equal the JAX package's, exactly.

Leaf and node digests on 4,096 seeded random inputs and at odd sizes (the
CUDA kernels take any N; the plain twins run here), tree levels at 2^13
leaves, the reference's four-leaf digests (merkle.rs:117-181), auth paths,
and the constant tables that csrc/sha256.cuh carries.
"""

import hashlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.hash import sha256 as jsha
from zkstark_tpu.ops import sha256_kernel as jkern
from zkstark_tpu_torch.hash import merkle as tmerkle
from zkstark_tpu_torch.hash import sha256 as tsha
from zkstark_tpu_torch.ops import sha256_kernel as tkern

rng = np.random.default_rng(0x5EED)


def _u32(shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32))


_jax_leaf = jax.jit(jsha.leaf_hash)
_jax_node = jax.jit(jsha.node_hash)


@pytest.mark.parametrize("n", [1, 3, 1000, 4096])
def test_leaf_hash_matches_jax(n):
    vals = _u32(n)
    want = np.asarray(_jax_leaf(jnp.asarray(vals)))
    np.testing.assert_array_equal(tsha.leaf_hash(_t(vals)).numpy(), want)
    np.testing.assert_array_equal(tkern.leaf_hash(_t(vals)).numpy(), want)
    assert tsha.digest_to_bytes(want[0]) == hashlib.sha256(
        int(vals[0]).to_bytes(4, "big")
    ).digest()


@pytest.mark.parametrize("k", [1, 3, 1000, 4096])
def test_node_hash_matches_jax(k):
    children = _u32((2 * k, 8))
    want = np.asarray(_jax_node(jnp.asarray(children[0::2]), jnp.asarray(children[1::2])))
    got = tsha.node_hash(_t(children[0::2]), _t(children[1::2]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tkern.node_hash_pairs(_t(children)).numpy(), want)
    assert tsha.digest_to_bytes(want[-1]) == hashlib.sha256(
        tsha.digest_to_bytes(children[-2]) + tsha.digest_to_bytes(children[-1])
    ).digest()


def test_compress_matches_jax():
    state = _u32((64, 8))
    block = _u32((64, 16))
    want = np.asarray(jax.jit(jsha.compress)(jnp.asarray(state), jnp.asarray(block)))
    np.testing.assert_array_equal(tsha.compress(_t(state), _t(block)).numpy(), want)


def test_build_levels_matches_jax():
    vals = _u32(1 << 13)
    want = jax.jit(lambda v: jmerkle.build_levels(v, planar=False))(jnp.asarray(vals))
    got = tmerkle.build_levels(_t(vals))
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_I3 = bytes.fromhex("b40711a88c7039756fb8a73827eabe2c0fe5a0346ca7e0a104adc0fc764f528d")
_I4 = bytes.fromhex("433ebf5bc03dffa38536673207a21281612cef5faa9bc7a4d5b9be2fdb12cf1a")
_I5 = bytes.fromhex("88185d128d9922e0e6bcd32b07b6c7f20f27968eab447a1d8d1cdf250f79f7d3")
_I6 = bytes.fromhex("1bc5d0e3df0ea12c4d0078668d14924f95106bbe173e196de50fe13a900b0937")
_I1 = bytes.fromhex("be8dc357decb6e09c8e5ad874d3c4fa7fc09730bbb5e90f42c97dad20e0012d4")
_I2 = bytes.fromhex("6bed5b6d7ae093d1812ab9be5cbfa1ce787812a003d95c11448720a407b61727")
_I0 = bytes.fromhex("327cf213e1738de4206bfd14297c26c682961750cb56897ed5e8f519b0548ff2")


def test_reference_four_leaf_tree():
    tree = tmerkle.MerkleTree.commit(_t(np.array([1, 2, 3, 4])))
    leaves = tree.levels[0].numpy()
    assert [tsha.digest_to_bytes(leaves[i]) for i in range(4)] == [_I3, _I4, _I5, _I6]
    mid = tree.levels[1].numpy()
    assert [tsha.digest_to_bytes(mid[i]) for i in range(2)] == [_I1, _I2]
    assert tree.root() == _I0
    np.testing.assert_array_equal(tsha.bytes_to_digest(_I0), tree.levels[-1][0].numpy())
    assert tree.auth_path(0) == [_I4, _I2]
    assert tree.auth_path(1) == [_I3, _I2]
    assert tree.auth_path(2) == [_I6, _I1]
    assert tree.auth_path(3) == [_I5, _I1]
    assert tree.auth_paths([0, 1, 2, 3]) == [[_I4, _I2], [_I3, _I2], [_I6, _I1], [_I5, _I1]]
    assert tmerkle.compute_root_from_path(1, 0, tree.auth_path(0)) == _I0
    assert tmerkle.compute_root_from_path(4, 3, tree.auth_path(3)) == _I0


def test_auth_paths_roundtrip_and_match_jax():
    n = 1024
    vals = _u32(n)
    tree = tmerkle.MerkleTree.commit(_t(vals))
    jtree = jmerkle.MerkleTree(
        levels=jax.jit(lambda v: jmerkle.build_levels(v, planar=False))(jnp.asarray(vals))
    )
    assert tree.root() == jtree.root()
    idx = [0, 1, 513, n - 1]
    assert tree.auth_paths(idx) == jtree.auth_paths(idx)
    for i in idx:
        assert tmerkle.compute_root_from_path(int(vals[i]), i, tree.auth_path(i)) == tree.root()
    assert tmerkle.compute_root_from_path(int(vals[0]) ^ 1, 0, tree.auth_path(0)) != tree.root()


def _cu_table(name):
    src = (Path(tmerkle.__file__).parents[1] / "csrc" / "sha256.cuh").read_text()
    body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9A-Fa-f]{8})u", body)]


def test_cuda_constant_tables():
    """The K and padding-schedule tables compiled into the CUDA kernel are
    the JAX package's (its kernel precomputes the same _PAD_WK)."""
    assert _cu_table("K") == [int(k) for k in jsha._K] == list(tsha.K)
    assert _cu_table("PAD_WK") == [int(v) for v in jkern._PAD_WK]
