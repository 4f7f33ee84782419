"""Merkle commitment over uint32 residues, built level by level on the
device — counterpart of ``zkstark_tpu/hash/merkle.py``.

Every level is row-major (k, 8), or (B, k, 8) for B trees built in lockstep
(`build_levels_batch`), in natural order: adjacent digest rows are
exactly a node's left‖right message, so each wide level is one
`sha256_kernel.node_hash_pairs` call on the level below, and from
`sha256_kernel.TAIL_PARENTS` parents a tree down to the root the levels are
one `sha256_kernel.tree_tail` call (a tree of at most twice that many values
is one call, leaf hashes included). The kernels write every level of a tree
into one allocation (`Levels`), after the tree's values where those were
made at its head (`tree_values`), so that the openings kernel reads a tree
through a single pointer. With `planar_stop`
(default off) `build_levels` hashes the wide levels on the TPU kernels' own
layout instead: bit-reversed leaves as word planes, `node_planes_folded` down
to `planar_stop` parents, then row-major; every level it returns is still
(k, 8) natural row-major (`planar_to_natural`). Leaf encoding
(big-endian u32, merkle.rs:30-34), node order (left‖right, merkle.rs:42-45),
auth-path order (leaf→root siblings, merkle.rs:54-71) and the index-parity
walk of compute_root_from_path (merkle.rs:82-110) are the reference's.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import sha256
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
from zkstark_tpu_torch.ops import ntt_kernel, sha256_kernel
from zkstark_tpu_torch.ops.openings import values_words


# Where the plane-major chain of `build_levels(..., planar_stop=...)` turns
# row-major: at 2^22 parents, the JAX package's point.
PLANAR_STOP = 1 << 22


def level_size(level: torch.Tensor) -> int:
    """The digests of a (k, 8) level."""
    return level.shape[0]


def level_offset(n: int, level: int, bsz: int = 1) -> int:
    """The words before level `level` in the one allocation of B trees of n
    leaves (`Levels.buffer`): 8·B·(2n − 2n/2^level)."""
    return 8 * bsz * (2 * n - ((2 * n) >> level))


class Levels(list):
    """The digest levels of B trees of n leaves, leaf level first (level l
    (B, n/2^l, 8), or (n/2^l, 8) without the batch axis), as views of one
    flat allocation, `buffer`, that holds them back to back after `head`
    words: level l starts at head + `level_offset(n, l, B)`. The head holds
    the trees' values where they were made by `tree_values` (head =
    `values_words(B, n)`), else nothing (head = 0). A list like any other to
    its callers; the openings kernel reads a tree through its buffer."""

    __slots__ = ("buffer", "head")

    def __init__(self, levels, buffer: torch.Tensor, head: int = 0):
        super().__init__(levels)
        self.buffer, self.head = buffer, head


def tree_values(bsz: int, n: int, device, width: int = 1) -> tuple:
    """(values, room): an uninitialised (B, n) uint32 tensor for B trees'
    values at the head of `room`, one flat allocation with room for all their
    digest levels after them; (B, w, n), each tree's w columns one after the
    other, for trees whose leaf is a row of `width` = w > 1 words.
    `build_levels_batch(values, room)` writes the levels there, so that a
    tree is one allocation (the openings kernel then reads it through one
    pointer)."""
    head = values_words(bsz * width, n)
    room = torch.empty(head + level_offset(n, n.bit_length(), bsz), dtype=torch.uint32,
                       device=device)
    shape = (bsz, n) if width == 1 else (bsz, width, n)
    return room[: bsz * width * n].view(shape), room


def _level_views(buf: torch.Tensor, bsz: int, n: int) -> list:
    return [buf[level_offset(n, lv, bsz) : level_offset(n, lv + 1, bsz)].view(bsz, n >> lv, 8)
            for lv in range(n.bit_length())]


def levels_from_host(levels: list, device) -> Levels:
    """Host (numpy uint32) levels of a tree (lead + (n, 8), …, lead + (1, 8)
    for the trees of a batch), leaf level first, as `Levels` on `device`: one
    upload of their concatenation."""
    lead, n = tuple(levels[0].shape[:-2]), levels[0].shape[-2]
    flat = np.concatenate([np.asarray(lv, dtype=np.uint32).reshape(-1) for lv in levels])
    buf = fp.from_host(flat, device)
    views = _level_views(buf, int(np.prod(lead, dtype=np.int64)), n)
    return Levels([v.view(lead + v.shape[1:]) for v in views], buf)


def _levels_above(level: torch.Tensor, bsz: int, n: int) -> list:
    """The levels above (bsz·n, 8) row-major digests, n a tree: a
    `node_hash_pairs` call a wide level, then one `tree_tail` call."""
    levels = []
    while n > 2 * sha256_kernel.TAIL_PARENTS:
        n //= 2
        level = sha256_kernel.node_hash_pairs(level)
        levels.append(level.reshape(bsz, n, 8))
    if n > 1:
        levels += sha256_kernel.tree_tail(level, bsz)
    return levels


def build_levels_batch(values: torch.Tensor, room: torch.Tensor | None = None) -> Levels:
    """B trees in lockstep from (B, n) uint32 residues, n a power of two:
    [leaves (B, n, 8), …, roots (B, 1, 8)], written by the hash kernels
    straight into one allocation (`Levels`): `room` after the values where
    `tree_values` made the two, else a new one. Each wide level is one kernel
    call on the flat (B·k) hash axis: n is even, so children 2j and 2j+1 of
    any parent lie in one tree and pairs never cross trees. The narrow levels
    (the whole tree, if it is small) are one call for all B trees. Values
    (B, w, n) are trees of row leaves: leaf i hashes row i of the w columns
    (`sha256_kernel.leaf_hash_rows`), and the levels above follow as for any
    tree."""
    with tracing.span("merkle"):
        rows = values.dim() == 3
        bsz, n = values.shape[0], values.shape[-1]
        width = values.shape[1] if rows else 1
        assert n >= 1 and n & (n - 1) == 0
        tail = 2 * sha256_kernel.TAIL_PARENTS  # children a tree the tail call takes
        if room is None:
            whole, head = torch.empty(level_offset(n, n.bit_length(), bsz), dtype=torch.uint32,
                                      device=values.device), 0
        else:
            whole, head = room, values_words(bsz * width, n)
            if (values.data_ptr() != room.data_ptr()
                    or room.numel() != head + level_offset(n, n.bit_length(), bsz)):
                raise ValueError("build_levels_batch: `room` is not the allocation that "
                                 "tree_values made for these values")
        buf = whole[head:]
        levels = _level_views(buf, bsz, n)
        if rows:
            level = sha256_kernel.leaf_hash_rows(values, out=levels[0].view(bsz * n, 8))
        else:
            flat = fp.as_u32(fp.as_i32(values).reshape(bsz * n))
            if 2 <= n <= tail:
                if flat.data_ptr() % 8:  # a view at an odd word: the kernel reads pairs
                    flat = flat.clone()
                return Levels(sha256_kernel.tree_tail(flat, bsz, from_values=True, out=buf),
                              whole, head)
            level = sha256_kernel.leaf_hash(flat, out=levels[0].view(bsz * n, 8))
        lv = 0
        while n >> lv > tail:
            lv += 1
            level = sha256_kernel.node_hash_pairs(level, out=levels[lv].view(-1, 8))
        if n >> lv > 1:
            sha256_kernel.tree_tail(level, bsz, out=buf[level_offset(n, lv + 1, bsz):])
        return Levels(levels, whole, head)


@functools.lru_cache(maxsize=8)
def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_indices(n).astype(np.int64)).to(device)


def planar_to_natural(planes: torch.Tensor) -> torch.Tensor:
    """(8, k) word planes in bit-reversed digest order → (k, 8) natural
    row-major: the `transpose` kernel with bit-reversed output rows."""
    return ntt_kernel.transpose(planes.reshape(-1), 8, planes.shape[1], brev=True)


def build_levels(values: torch.Tensor, planar_stop: int | None = None) -> list:
    """All tree levels bottom-up from (n,) uint32 residues, n a power of two:
    [leaves (n, 8), …, root (1, 8)], on the values' device, in one
    allocation (`Levels`). With
    `planar_stop`, the leaves are permuted to bit-reversed order and hashed
    as word planes (`leaf_planes`), every level of at least `planar_stop`
    parents is `node_planes_folded` of the planes below, and the rest are
    row-major as by default; each level is returned natural row-major, in
    allocations of its own (a plain list)."""
    if planar_stop is None:
        levels = build_levels_batch(values[None])
        return Levels([level[0] for level in levels], levels.buffer, levels.head)
    with tracing.span("merkle"):
        n = values.shape[0]
        assert n >= 2 and n & (n - 1) == 0 and planar_stop >= 1
        vals = fp.as_u32(fp.as_i32(values).index_select(0, _bitrev(n, values.device)))
        planes = sha256_kernel.leaf_planes(vals)
        levels = [planar_to_natural(planes)]
        while planes.shape[1] // 2 >= planar_stop:
            planes = sha256_kernel.node_planes_folded(planes)
            levels.append(planar_to_natural(planes))
        k = levels[-1].shape[0]
        return levels + [level[0] for level in _levels_above(levels[-1], 1, k)]


@dataclass
class MerkleTree:
    """Host handle over device-resident levels (reference Merkle)."""

    levels: list  # uint32 tensors, leaf level first

    @classmethod
    def commit(cls, values: torch.Tensor) -> "MerkleTree":
        return cls(levels=build_levels(values))

    @property
    def num_leaves(self) -> int:
        return level_size(self.levels[0])

    def root(self) -> bytes:
        return sha256.digest_to_bytes(fp.to_host(self.levels[-1][0]))

    def auth_path(self, index: int) -> list:
        """Sibling digests leaf→root (reference trace(), merkle.rs:54-71)."""
        return self.auth_paths([index])[0]

    def auth_paths(self, indices) -> list:
        """One gather per level and one fetch for all the paths."""
        host = fp.to_host(fp.as_u32(gather_paths(self.levels, list(indices))))
        return [[sha256.digest_to_bytes(d) for d in path] for path in host]


def gather_paths(levels: list, indices: list) -> torch.Tensor:
    """Sibling digests leaf→root for each host index, gathered on the levels'
    device: (len(indices), depth, 8) int32 bits."""
    sibs = []
    cur = list(indices)
    for level in levels[:-1]:
        idx = torch.tensor([i ^ 1 for i in cur], device=level.device)
        sibs.append(fp.as_i32(level).index_select(0, idx))
        cur = [i >> 1 for i in cur]
    if not sibs:
        return torch.zeros((len(cur), 0, 8), dtype=torch.int32, device=levels[0].device)
    return torch.stack(sibs, dim=1)


def compute_root_from_path(element, index: int, path: list) -> bytes:
    """Recompute the root from one opening — verifier side (merkle.rs:82-110).
    `element` is the leaf's value, or the row of values of a leaf of w > 1
    columns (hashed as its words big-endian)."""
    words = element if isinstance(element, (list, tuple)) else [element]
    current = hashlib.sha256(b"".join(int(v).to_bytes(4, "big") for v in words)).digest()
    i = index
    for sibling in path:
        if i & 1:
            current = hashlib.sha256(sibling + current).digest()
        else:
            current = hashlib.sha256(current + sibling).digest()
        i >>= 1
    return current
