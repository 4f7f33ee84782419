"""Sharded Merkle commitment: local subtrees and a replicated top —
counterpart of ``zkstark_tpu/parallel/merkle_sharded.py``.

Each shard builds the subtree over its contiguous block of leaves with
`merkle.build_levels` (the kernels ``sha256_leaf``, ``sha256_node`` and
``sha256_tree_tail``), one `all_gather` collects the S subtree roots, and
the top log2(S) levels are hashed on every process. The leaves are blocked
contiguously and every level size is a power of two, so the concatenation
of the shards' blocks of a level is the single-device level: the root and
every auth path equal the single-device tree's. Levels are row-major (the
JAX package turns its planar layout off here too); each shard's subtree and
the replicated top are one allocation each (`ShardedLevels`).
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import sha256_kernel
from zkstark_tpu_torch.parallel.mesh import Mesh


class ShardedLevels(list):
    """`sharded_build_levels`' levels, with the buffers the openings kernel
    reads: `blocks`, each local shard's subtree in one allocation (its
    levels up to its root, `merkle.Levels.buffer`), and `top`, the levels
    above the subtree roots in one allocation (None on a mesh of one)."""

    __slots__ = ("blocks", "top")

    def __init__(self, levels, blocks: list, top: torch.Tensor | None):
        super().__init__(levels)
        self.blocks, self.top = blocks, top


def sharded_build_levels(blocks: list, mesh: Mesh) -> ShardedLevels:
    """Every level of the tree over the block-sharded (n,) uint32 residues,
    leaf level first: the levels below the subtree roots as lists of this
    process's (n/S >> l, 8) blocks, then the replicated levels from the
    gathered subtree roots (S, 8) up to the root (1, 8)."""
    local = [merkle.build_levels(b) for b in blocks]
    depth = len(local[0]) - 1  # levels below the subtree roots
    levels = [[lv[d] for lv in local] for d in range(depth)]
    top = mesh.all_gather([lv[-1] for lv in local])  # (S, 8): the subtree roots
    levels.append(top)
    buf = None
    if top.shape[0] > 1:
        buf = torch.empty(8 * (top.shape[0] - 1), dtype=torch.uint32, device=top.device)
        levels += [lv[0] for lv in sha256_kernel.tree_tail(top, 1, out=buf)]
    return ShardedLevels(levels, [lv.buffer[lv.head:] for lv in local], buf)


def shard_tree(values: torch.Tensor, levels, shards: int) -> tuple:
    """A whole tree as S shards of a local mesh hold it, for the openings of
    the sharded prover: (values, levels), where an array of at least S words
    or rows is the list of its S blocks (copies) and the levels a
    `ShardedLevels` (each shard's subtree and the top in one allocation
    each); a tree of fewer than S leaves stays whole. `values` is (1, n) or
    (n,), `levels` the tree's `merkle.Levels` of the same lead."""
    vals = values.reshape(-1)
    n = vals.shape[0]
    if n < shards:
        return values, levels
    k = n // shards
    flat = [lv.reshape(-1, 8) for lv in levels]
    sub = [lv for lv in flat if lv.shape[0] >= shards]
    whole = [lv for lv in flat if lv.shape[0] < shards]
    blocks = [torch.cat([lv[s * (lv.shape[0] // shards) : (s + 1) * (lv.shape[0] // shards)]
                         .reshape(-1) for lv in sub]) for s in range(shards)]
    subtrees = [[b[merkle.level_offset(k, d) : merkle.level_offset(k, d + 1)].view(-1, 8)
                 for d in range(len(sub))] for b in blocks]
    top = torch.cat([lv.reshape(-1) for lv in whole]) if whole else None
    out = [[t[d] for t in subtrees] for d in range(len(sub))] + whole
    return [vals[s * k : (s + 1) * k].clone() for s in range(shards)], \
        ShardedLevels(out, blocks, top)


def sharded_commit(blocks: list, mesh: Mesh) -> merkle.MerkleTree:
    """The tree of `sharded_build_levels` with every level gathered whole
    (for inspection and tests; the prover keeps the levels sharded)."""
    levels = sharded_build_levels(blocks, mesh)
    return merkle.MerkleTree(
        levels=[mesh.all_gather(lv) if isinstance(lv, list) else lv for lv in levels]
    )
