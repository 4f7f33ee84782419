"""Batched SHA-256 on Hopper (CUDA kernel A, ``csrc/sha256.cu``).

`leaf_hash` replaces the Pallas kernel ``zkstark_tpu/ops/sha256_kernel.py``
``_leaf_kernel`` and `node_hash_pairs` replaces ``_node_kernel`` (reached
there through ``node_hash_pairs``). On the H100 SHA-256 is bound by 32-bit
integer ALU work: about a thousand adds, rotates, xors and ands per 64-byte
compression, against 4 bytes (leaf) or 64 bytes (node) read per hash. The
kernels run one thread per hash, keep the 16-word rolling message schedule
and the eight state words in registers, rotate with the funnel shifter, and
take the node's second block (the constant padding of a 64-byte message)
as a precomputed schedule-plus-K table, so it costs rounds only. Digests are
row-major (N, 8), the layout the Merkle levels keep; the TPU's lane-planar
(8, m, 128) layout and its 1024-hash minimum batch are not carried over, so
any N ≥ 1 goes through the kernel on the card.

`tree_tail` is the node kernel for the shape the Merkle trees launch most:
once a level has at most `TAIL_PARENTS` parents a tree, one launch
(``sha256_tree_tail``, one block a tree, a thread a parent, the levels handed
on through shared memory) hashes every level from there down to the root,
where a launch a level cost the host's enqueue log2(n) times a tree for a
few microseconds of device work; the JAX package left these levels to XLA,
which fused them. It can start from the residues, so a tree of at most
2·`TAIL_PARENTS` values is one launch, leaf hashes included.
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch.hash import sha256
from zkstark_tpu_torch.ops import _build

leaf_launches = 0  # launches of sha256_leaf, counted by leaf_hash
node_launches = 0  # launches of sha256_node, counted by node_hash_pairs
tail_launches = 0  # launches of sha256_tree_tail, counted by tree_tail

# The most parents a tree that `tree_tail` takes in its first level (a thread
# each, one block a tree): the kernel's limit, and where `hash/merkle.py`
# leaves `node_hash_pairs`. On an NVIDIA H100 a tail of 1024 parents takes
# less device time than the enqueue of the launches it replaces (PERF.md).
TAIL_PARENTS = 1024


def leaf_hash_plain(values: torch.Tensor) -> torch.Tensor:
    return sha256.leaf_hash(values)


def node_hash_pairs_plain(children: torch.Tensor) -> torch.Tensor:
    return sha256.node_hash(children[0::2], children[1::2])


def leaf_hash(values: torch.Tensor) -> torch.Tensor:
    """(n,) uint32 → (n, 8) uint32 leaf digests."""
    global leaf_launches
    _build.require(values, "sha256_leaf", 1)
    if values.device.type == "cpu":
        return leaf_hash_plain(values)
    n = values.shape[0]
    out = torch.empty((n, 8), dtype=torch.uint32, device=values.device)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(values.device):
        rc = lib.zk_sha256_leaf(
            values.data_ptr(), out.data_ptr(), n, _build.stream(values)
        )
    _build.check(rc, "sha256_leaf")
    leaf_launches += 1
    return out


def node_hash_pairs(children: torch.Tensor) -> torch.Tensor:
    """(2k, 8) child digests → (k, 8) parents; parent j =
    SHA256(child 2j ‖ child 2j+1)."""
    global node_launches
    _build.require(children, "sha256_node", 2)
    if children.shape[1] != 8 or children.shape[0] % 2:
        raise ValueError(f"sha256_node: needs (2k, 8) digests, got {tuple(children.shape)}")
    if children.device.type == "cpu":
        return node_hash_pairs_plain(children)
    k = children.shape[0] // 2
    if children.data_ptr() % 16:
        raise ValueError("sha256_node: digests must be 16-byte aligned")
    out = torch.empty((k, 8), dtype=torch.uint32, device=children.device)
    if k == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(children.device):
        rc = lib.zk_sha256_node(
            children.data_ptr(), out.data_ptr(), k, _build.stream(children)
        )
    _build.check(rc, "sha256_node")
    node_launches += 1
    return out


def _tail_check(level: torch.Tensor, trees: int, from_values: bool) -> int:
    """The parents a tree in the tail's first level."""
    _build.require(level, "sha256_tree_tail", 1 if from_values else 2)
    if not from_values and level.shape[1] != 8:
        raise ValueError(f"sha256_tree_tail: needs (n, 8) digests, got {tuple(level.shape)}")
    per_tree, rest = divmod(level.shape[0], trees) if trees > 0 else (0, 1)
    t = per_tree // 2
    if rest or per_tree < 2 or t & (t - 1) or t > TAIL_PARENTS:
        raise ValueError(
            f"sha256_tree_tail: needs {trees} trees of 2t children each, t a power of two "
            f"of at most {TAIL_PARENTS}, got {level.shape[0]} rows"
        )
    return t


def tree_tail_plain(level: torch.Tensor, trees: int, from_values: bool = False) -> list:
    """Plain-torch twin of `tree_tail`: a loop over `node_hash_pairs_plain`."""
    t = _tail_check(level, trees, from_values)
    levels = []
    if from_values:
        level = leaf_hash_plain(level)
        levels.append(level.reshape(trees, 2 * t, 8))
    while t >= 1:
        level = node_hash_pairs_plain(level)
        levels.append(level.reshape(trees, t, 8))
        t //= 2
    return levels


def tree_tail(level: torch.Tensor, trees: int, from_values: bool = False) -> list:
    """Every level of `trees` Merkle trees above `level` in one launch.

    `level` holds 2t children a tree, tree after tree, t ≤ `TAIL_PARENTS` a
    power of two: (trees·2t, 8) uint32 digests, or with `from_values`
    (trees·2t,) uint32 residues, whose leaf digests then come first in the
    result. Returns [(trees, t, 8), (trees, t/2, 8), …, (trees, 1, 8)], views
    of one buffer that holds the levels back to back, each contiguous and
    16-byte aligned."""
    global tail_launches
    t = _tail_check(level, trees, from_values)
    if level.device.type == "cpu":
        return tree_tail_plain(level, trees, from_values)
    if level.data_ptr() % (8 if from_values else 16):
        raise ValueError("sha256_tree_tail: residues must be 8-byte, digests 16-byte aligned")
    sizes = ([2 * t] if from_values else []) + [t >> i for i in range(t.bit_length())]
    out = torch.empty(trees * 8 * sum(sizes), dtype=torch.uint32, device=level.device)
    with torch.cuda.device(level.device):
        rc = _build.kernels().zk_sha256_tree_tail(
            level.data_ptr(), out.data_ptr(), trees, t, int(from_values), _build.stream(level)
        )
    _build.check(rc, "sha256_tree_tail")
    tail_launches += 1
    levels, at = [], 0
    for k in sizes:
        levels.append(out[at : at + trees * k * 8].view(trees, k, 8))
        at += trees * k * 8
    return levels
