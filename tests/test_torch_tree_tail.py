"""The Merkle tail (`sha256_kernel.tree_tail`, one launch for every level
from `TAIL_PARENTS` parents a tree down to the root) equals the level-by-level
build, hashlib and the JAX package's trees, word for word (tolerance 0: there
is no rounding), and leaves the levels' shapes, order and alignment as they
were. On the CPU the wrapper runs `tree_tail_plain`; the kernel itself is
held against it on the card (tests/test_torch_cuda.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu_torch.hash import merkle as tmerkle
from zkstark_tpu_torch.hash import sha256 as tsha
from zkstark_tpu_torch.ops import sha256_kernel as tkern

T = tkern.TAIL_PARENTS


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32))


def _level_by_level(values: torch.Tensor) -> list:
    """The build as it was before the tail: one call a level."""
    level = tkern.leaf_hash_plain(values)
    levels = [level]
    while level.shape[0] > 1:
        level = tkern.node_hash_pairs_plain(level)
        levels.append(level)
    return levels


@pytest.mark.parametrize("trees,t", [(1, 1), (1, 2), (3, 16), (2, 256), (1, T)])
@pytest.mark.parametrize("from_values", [False, True])
def test_tree_tail_plain_equals_level_by_level_and_hashlib(trees, t, from_values):
    if from_values:
        vals = _u32(trees * 2 * t, seed=t)
        level = tkern.leaf_hash_plain(_t(vals))
        got = tkern.tree_tail(_t(vals), trees, from_values=True)
        np.testing.assert_array_equal(got[0].numpy().reshape(-1, 8), level.numpy())
        got = got[1:]
    else:
        level = _t(_u32((trees * 2 * t, 8), seed=t + 1))
        got = tkern.tree_tail(level, trees)
    assert [tuple(g.shape) for g in got] == [(trees, t >> i, 8) for i in range(t.bit_length())]
    want = level
    for g in got:
        want = tkern.node_hash_pairs_plain(want)
        np.testing.assert_array_equal(g.numpy().reshape(-1, 8), want.numpy())
    # the last tree's root, from its children, by hashlib
    rows = level.numpy().reshape(trees, 2 * t, 8)[-1]
    digests = [tsha.digest_to_bytes(r) for r in rows]
    while len(digests) > 1:
        digests = [hashlib.sha256(a + b).digest() for a, b in zip(digests[0::2], digests[1::2])]
    assert tsha.digest_to_bytes(got[-1].numpy()[-1, 0]) == digests[0]


@pytest.mark.parametrize("n", [1, 2, T, 2 * T, 4 * T, 8192])
def test_build_levels_matches_jax_and_the_level_by_level_build(n):
    vals = _u32(n, seed=n)
    got = tmerkle.build_levels(_t(vals))
    want = jmerkle.build_levels(jnp.asarray(vals), planar=False)
    plain = _level_by_level(_t(vals))
    assert len(got) == len(want) == len(plain) == n.bit_length()
    for i, (g, w, q) in enumerate(zip(got, want, plain)):
        assert tuple(g.shape) == (n >> i, 8) and g.dtype == torch.uint32
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), q.numpy())


@pytest.mark.parametrize("n", [2, 2 * T, 4 * T])
def test_build_levels_batch_of_three_matches_jax(n):
    vals = _u32((3, n), seed=3 * n)
    got = tmerkle.build_levels_batch(_t(vals))
    want = jmerkle.build_levels_batch(jnp.asarray(vals))
    assert len(got) == len(want) == n.bit_length()
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (3, n >> i, 8)
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(3):
        solo = tmerkle.build_levels(_t(vals[b]))
        for g, s in zip(got, solo):
            np.testing.assert_array_equal(g[b].numpy(), s.numpy())


@pytest.mark.parametrize("threshold", [1, 4, 64])
def test_the_hand_over_from_node_levels_to_the_tail(monkeypatch, threshold):
    """Wherever the threshold lies, the levels are the same, and the wide
    levels go one call each, the narrow ones in one call."""
    vals = _t(_u32((2, 512), seed=threshold))
    want = tmerkle.build_levels_batch(vals)
    monkeypatch.setattr(tkern, "TAIL_PARENTS", threshold)
    calls = {"node": 0, "tail": 0}
    node, tail = tkern.node_hash_pairs, tkern.tree_tail

    def counted_node(children, **kw):  # kw: the out= view into the tree's one allocation
        calls["node"] += 1
        return node(children, **kw)

    def counted_tail(level, trees, from_values=False, **kw):
        calls["tail"] += 1
        return tail(level, trees, from_values, **kw)

    monkeypatch.setattr(tkern, "node_hash_pairs", counted_node)
    monkeypatch.setattr(tkern, "tree_tail", counted_tail)
    got = tmerkle.build_levels_batch(vals)
    assert calls == {"node": 9 - threshold.bit_length(), "tail": 1}
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_tree_tail_checks_input():
    with pytest.raises(TypeError):
        tkern.tree_tail(torch.zeros((4, 8), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        tkern.tree_tail(_t(np.zeros((6, 8))), 1)  # 3 parents: not a power of two
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        tkern.tree_tail(_t(np.zeros((4 * T, 8))), 1)  # above the threshold
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        tkern.tree_tail(_t(np.zeros((8, 8))), 3)  # rows do not divide into the trees
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        tkern.tree_tail(_t(np.zeros((8, 8))), 1, from_values=True)  # residues are 1-D


def test_launch_counter_is_listed():
    from zkstark_tpu_torch import ops

    ops.reset_launch_counts()
    assert ops.launch_counts()["sha256_tree_tail"] == 0
    tmerkle.build_levels(_t(_u32(64, seed=1)))  # on the CPU no kernel is launched
    assert ops.launch_counts()["sha256_tree_tail"] == 0
