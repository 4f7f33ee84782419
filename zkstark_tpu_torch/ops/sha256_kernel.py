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

`leaf_hash_rows` is the leaf of a trace of w columns (``sha256_leaf_rows``):
leaf i hashes row i's w words big-endian, one block for w ≤ `ROW_MAX`,
read from the columns one after the other, (B, w, n), as the LDE leaves
them.

`leaf_planes`, `node_planes` and `node_planes_folded` are the same two
kernels on the TPU kernels' own layout, the digests of a level as 8 word
planes: flat (8, n) uint32, word w of hash i at [w, i] (the JAX package's
(8, n/128, 128) planes reshaped, without its 128-lane rows). `node_planes`
pairs children 2j and 2j+1; `node_planes_folded` takes a level stored in
bit-reversed order, whose left children are the first half of each plane and
right children the second, and leaves its parents bit-reversed too.
`planes_to_rowmajor` turns planes into (n, 8) rows with the `transpose`
kernel. The Merkle trees take this layout only under an option of
`hash.merkle.build_levels` (default off).

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

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import sha256
from zkstark_tpu_torch.ops import _build, ntt_kernel

leaf_launches = 0  # launches of sha256_leaf, counted by leaf_hash
node_launches = 0  # launches of sha256_node, counted by node_hash_pairs
tail_launches = 0  # launches of sha256_tree_tail, counted by tree_tail
leaf_rows_launches = 0  # launches of sha256_leaf_rows, counted by leaf_hash_rows
leaf_planes_launches = 0  # launches of sha256_leaf<planes>, counted by leaf_planes
node_planes_launches = 0  # launches of sha256_node<planes>, counted by _node_planes

# The smallest batch the hash kernels take: any n >= 1 (the TPU kernels' was
# one grid step of 1024 hashes).
MIN_BATCH = 1

# The most words of a row that `leaf_hash_rows` takes: a row, the pad word
# and the 64-bit length in one 64-byte block.
ROW_MAX = 13

# The most parents a tree that `tree_tail` takes in its first level (a thread
# each, one block a tree): the kernel's limit, and where `hash/merkle.py`
# leaves `node_hash_pairs`. On an NVIDIA H100 a tail of 1024 parents takes
# less device time than the enqueue of the launches it replaces (PERF.md).
TAIL_PARENTS = 1024


def leaf_hash_plain(values: torch.Tensor) -> torch.Tensor:
    return sha256.leaf_hash(values)


def leaf_hash_rows_plain(values: torch.Tensor) -> torch.Tensor:
    """(B, w, n) columns → (B·n, 8): the digest of each tree's rows."""
    rows = fp.as_i32(values).transpose(-1, -2).reshape(-1, values.shape[-2])
    return sha256.row_hash(fp.as_u32(rows.contiguous()))


def node_hash_pairs_plain(children: torch.Tensor) -> torch.Tensor:
    return sha256.node_hash(children[0::2], children[1::2])


def leaf_hash(values: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) uint32 → (n, 8) uint32 leaf digests, written into `out` where
    given (a view into a tree's one allocation)."""
    global leaf_launches
    _build.require(values, "sha256_leaf", 1)
    n = values.shape[0]
    out = _build.out_tensor(out, (n, 8), values, "sha256_leaf", 16)
    if values.device.type == "cpu":
        return out.copy_(leaf_hash_plain(values))
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


def leaf_hash_rows(values: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, w, n) uint32, the w columns of B trees of n leaves one after the
    other (n a power of two, 1 ≤ w ≤ `ROW_MAX`) → (B·n, 8) leaf digests,
    leaf i of tree b the hash of row i's w words big-endian, written into
    `out` where given (a view into the trees' one allocation). Counts the
    leaves in the tracer's ``merkle.row_leaves``."""
    global leaf_rows_launches
    _build.require(values, "sha256_leaf_rows", 3)
    bsz, width, n = values.shape
    if not 1 <= width <= ROW_MAX or n < 1 or n & (n - 1):
        raise ValueError(f"sha256_leaf_rows: needs (B, w, n) columns, 1 <= w <= {ROW_MAX} and "
                         f"n a power of two, got {tuple(values.shape)}")
    out = _build.out_tensor(out, (bsz * n, 8), values, "sha256_leaf_rows", 16)
    tracing.count("merkle.row_leaves", bsz * n)
    if values.device.type == "cpu":
        return out.copy_(leaf_hash_rows_plain(values))
    if not values.is_contiguous():
        raise ValueError("sha256_leaf_rows: the columns must be contiguous")
    if bsz == 0:
        return out
    with torch.cuda.device(values.device):
        rc = _build.kernels().zk_sha256_leaf_rows(
            values.data_ptr(), out.data_ptr(), bsz, n.bit_length() - 1, width,
            _build.stream(values)
        )
    _build.check(rc, "sha256_leaf_rows")
    leaf_rows_launches += 1
    return out


def node_hash_pairs(children: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(2k, 8) child digests → (k, 8) parents; parent j =
    SHA256(child 2j ‖ child 2j+1), written into `out` where given."""
    global node_launches
    _build.require(children, "sha256_node", 2)
    if children.shape[1] != 8 or children.shape[0] % 2:
        raise ValueError(f"sha256_node: needs (2k, 8) digests, got {tuple(children.shape)}")
    k = children.shape[0] // 2
    out = _build.out_tensor(out, (k, 8), children, "sha256_node", 16)
    if children.device.type == "cpu":
        return out.copy_(node_hash_pairs_plain(children))
    if children.data_ptr() % 16:
        raise ValueError("sha256_node: digests must be 16-byte aligned")
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


def leaf_planes_plain(values: torch.Tensor) -> torch.Tensor:
    return fp.as_u32(fp.as_i32(leaf_hash_plain(values)).t().contiguous())


def _node_planes_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Parents of (8, k) left and right child planes, as (8, k) planes."""
    rows = sha256.node_hash(fp.as_u32(fp.as_i32(left).t()), fp.as_u32(fp.as_i32(right).t()))
    return fp.as_u32(fp.as_i32(rows).t().contiguous())


def node_planes_plain(planes: torch.Tensor) -> torch.Tensor:
    p = fp.as_i32(planes)
    return _node_planes_plain(fp.as_u32(p[:, 0::2]), fp.as_u32(p[:, 1::2]))


def node_planes_folded_plain(planes: torch.Tensor) -> torch.Tensor:
    k = planes.shape[1] // 2
    return _node_planes_plain(planes[:, :k], planes[:, k:])


def leaf_planes(values: torch.Tensor) -> torch.Tensor:
    """(n,) uint32 → (8, n) uint32 leaf digests as word planes."""
    global leaf_planes_launches
    _build.require(values, "sha256_leaf_planes", 1)
    if values.device.type == "cpu":
        return leaf_planes_plain(values)
    n = values.shape[0]
    out = torch.empty((8, n), dtype=torch.uint32, device=values.device)
    if n == 0:
        return out
    with torch.cuda.device(values.device):
        rc = _build.kernels().zk_sha256_leaf_planes(
            values.data_ptr(), out.data_ptr(), n, _build.stream(values)
        )
    _build.check(rc, "sha256_leaf_planes")
    leaf_planes_launches += 1
    return out


def _check_planes(planes: torch.Tensor, what: str) -> int:
    _build.require(planes, what, 2)
    if planes.shape[0] != 8 or planes.shape[1] % 2:
        raise ValueError(f"{what}: needs (8, 2k) word planes, got {tuple(planes.shape)}")
    return planes.shape[1] // 2


def _node_planes(left: torch.Tensor, right_ptr: int, stride: int, k: int) -> torch.Tensor:
    """The plane-major node kernel: left child planes at `left`, right at
    `right_ptr`, each plane `stride` words apart → (8, k) parent planes."""
    global node_planes_launches
    out = torch.empty((8, k), dtype=torch.uint32, device=left.device)
    if k == 0:
        return out
    with torch.cuda.device(left.device):
        rc = _build.kernels().zk_sha256_node_planes(
            left.data_ptr(), right_ptr, out.data_ptr(), k, stride, _build.stream(left)
        )
    _build.check(rc, "sha256_node_planes")
    node_planes_launches += 1
    return out


def node_planes(planes: torch.Tensor) -> torch.Tensor:
    """(8, 2k) child planes → (8, k) parent planes; parent j =
    SHA256(child 2j ‖ child 2j+1). The even and odd children are first
    copied apart (a stride-2 split, as in the JAX package)."""
    k = _check_planes(planes, "sha256_node_planes")
    if planes.device.type == "cpu":
        return node_planes_plain(planes)
    p = fp.as_i32(planes)
    left, right = fp.as_u32(p[:, 0::2].contiguous()), fp.as_u32(p[:, 1::2].contiguous())
    return _node_planes(left, right.data_ptr(), k, k)


def node_planes_folded(planes: torch.Tensor) -> torch.Tensor:
    """(8, 2k) child planes in bit-reversed order → (8, k) parent planes,
    bit-reversed too: child 2j at slot brev(j), child 2j+1 at k + brev(j),
    so parent j = SHA256(planes[:, s] ‖ planes[:, k + s]) at slot s, read in
    place."""
    k = _check_planes(planes, "sha256_node_planes")
    if planes.device.type == "cpu":
        return node_planes_folded_plain(planes)
    return _node_planes(planes, planes.data_ptr() + 4 * k, 2 * k, k)


def planes_to_rowmajor(planes: torch.Tensor) -> torch.Tensor:
    """(8, n) word planes → (n, 8) digest rows (the `transpose` kernel)."""
    return ntt_kernel.transpose(planes.reshape(-1), 8, planes.shape[1])


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


def tree_tail(level: torch.Tensor, trees: int, from_values: bool = False,
              out: torch.Tensor | None = None) -> list:
    """Every level of `trees` Merkle trees above `level` in one launch.

    `level` holds 2t children a tree, tree after tree, t ≤ `TAIL_PARENTS` a
    power of two: (trees·2t, 8) uint32 digests, or with `from_values`
    (trees·2t,) uint32 residues, whose leaf digests then come first in the
    result. Returns [(trees, t, 8), (trees, t/2, 8), …, (trees, 1, 8)], views
    of one flat buffer that holds the levels back to back, each contiguous and
    16-byte aligned: `out` where given (the tail of a tree's one allocation),
    else a new one."""
    global tail_launches
    t = _tail_check(level, trees, from_values)
    sizes = ([2 * t] if from_values else []) + [t >> i for i in range(t.bit_length())]
    out = _build.out_tensor(out, (trees * 8 * sum(sizes),), level, "sha256_tree_tail", 16)
    levels, at = [], 0
    for k in sizes:
        levels.append(out[at : at + trees * k * 8].view(trees, k, 8))
        at += trees * k * 8
    if level.device.type == "cpu":
        for view, plain in zip(levels, tree_tail_plain(level, trees, from_values)):
            view.copy_(plain)
        return levels
    if level.data_ptr() % (8 if from_values else 16):
        raise ValueError("sha256_tree_tail: residues must be 8-byte, digests 16-byte aligned")
    with torch.cuda.device(level.device):
        rc = _build.kernels().zk_sha256_tree_tail(
            level.data_ptr(), out.data_ptr(), trees, t, int(from_values), _build.stream(level)
        )
    _build.check(rc, "sha256_tree_tail")
    tail_launches += 1
    return levels
