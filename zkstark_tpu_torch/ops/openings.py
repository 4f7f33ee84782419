"""Every phase-4 opening in one launch on Hopper (``csrc/openings.cu``).

`openings` replaces ``zkstark_tpu/protocol/fused.py:225-316`` (`_take_val`,
`_take_digest`, `_auth_path`, `sparse_openings`), which XLA fused into the
fused core's one program; as plain tensor ops the same gathers are some 330
launches at stark-101 and 900 at 2^24.

The result is one flat uint32 vector of `Segment`s, each a leaf of the packed
result in its order (``protocol/openings.py`` lays them out), of shape
lead + (q, n_idx) for values or lead + (q, n_idx, depth, 8) for auth paths,
where lead is the queries' leading shape (B proofs). Segment `s` reads tree
`s.tree` of `trees` — its values, then its digest levels from the leaves up
(the root level is not read) — and slot i of query x opens

    idx = ((x & mask) + adds[i]) & mask

(the JAX index rules: x + k·blowup per shift with mask = 2^32 − 1; a FRI
layer's x & (size − 1) and its partner + size/2): a value is values[idx],
level l of an auth path the sibling digest levels[l][(idx >> l) ^ 1].

A shard of the sharded prover passes `shard`; its arrays are then either
`Block`s, this shard's block of an array sharded over the mesh (2^k words or
rows: it owns index i where i >> k = shard, at i & (2^k − 1)), or whole
tensors, which shard 0 alone reads. Where the shard does not own the word the
result is 0, so that the bitwise OR of every shard's vector is the whole
result (``parallel/mesh.py`` `Mesh.replicate`).

The kernel takes the segments and the table of pointers and sizes by value,
as kernel parameters: the levels are new tensors in every prove, and nothing
is uploaded or waited for. On a CPU tensor `openings` runs `openings_plain`
(the same descriptors read with ``take_along_dim``), on a CUDA tensor only the
kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ops import _build

U32 = torch.uint32
MAX_SEGMENTS = 64
MAX_ARRAYS = 512
MAX_ADDS = 8
ALL = 0xFFFFFFFF  # the mask of an index that is not reduced

openings_launches = 0  # launches of openings_kernel, counted by openings


@dataclass(frozen=True)
class Segment:
    """One leaf of the result: the values (path False) or auth paths of
    tree `tree` at the indices ((x & mask) + adds[i]) & mask of each query x."""

    tree: int
    path: bool
    mask: int
    adds: tuple


class Block(NamedTuple):
    """A shard's block of an array that is sharded over the mesh: (2^k,)
    values or (2^k, 8) digests."""

    words: torch.Tensor


def _array_info(arr, lead: tuple, sharded_ok: bool) -> tuple:
    """(tensor, log2 size, width, is a block) of one tree array, checked."""
    block = type(arr) is Block
    t = arr[0] if block else arr
    shape = t.shape
    head = 0 if block else len(lead)
    rank = len(shape) - head
    if (t.dtype != torch.uint32 or rank not in (1, 2) or (rank == 2 and shape[-1] != 8)
            or (head and tuple(shape[:head]) != lead)):
        raise ValueError(f"openings: an array of shape {tuple(shape)} is neither "
                         f"{() if block else lead} + (n,) values nor … + (k, 8) digests")
    if block and not sharded_ok:
        raise ValueError("openings: a shard's block without a shard index")
    size = shape[head]
    if size < 1 or size & (size - 1) or size > 1 << 31:
        raise ValueError(f"openings: {size} words or rows is not a power of two")
    return t, size.bit_length() - 1, 8 if rank == 2 else 1, block


def segment_words(seg: Segment, trees: list, lead: tuple, q: int) -> int:
    """The words of one segment in the result."""
    width = 8 * (len(trees[seg.tree]) - 1) if seg.path else 1
    return math.prod(lead) * q * len(seg.adds) * width


def _indices(x: torch.Tensor, seg: Segment) -> torch.Tensor:
    """lead + (q, n_idx) int64 indices of the segment's slots."""
    adds = torch.tensor(seg.adds, dtype=torch.int64, device=x.device)
    return (((x & seg.mask)[..., None] + adds) & seg.mask)


def openings_plain(queries: torch.Tensor, trees: list, segments, shard: int | None = None):
    """Plain-torch twin of the kernel, same arguments: each segment's gathers
    with ``take_along_dim``, owner-masked on a shard, ravelled in order."""
    x = fp.wide(queries)
    lead, q = tuple(x.shape[:-1]), x.shape[-1]
    parts = []

    def read(arr, idx):  # idx lead + (r,) → lead + (r,) or lead + (r, 8) int32
        t, log, width, block = _array_info(arr, lead, shard is not None)
        words = fp.as_i32(t)
        if block:
            words = words.reshape(lead + words.shape)  # B = 1 on a mesh
            own = (idx >> log) == shard
            idx = idx & ((1 << log) - 1)
        else:
            own = torch.full_like(idx, not shard, dtype=torch.bool)
        if width == 1:
            got = torch.take_along_dim(words, idx, dim=-1)
        else:
            got = torch.take_along_dim(words, idx[..., None].expand(idx.shape + (8,)), dim=-2)
            own = own[..., None]
        return torch.where(own, got, 0)

    for seg in segments:
        tree = trees[seg.tree]
        idx = _indices(x, seg).reshape(lead + (-1,))
        if not seg.path:
            parts.append(read(tree[0], idx).reshape(-1))
            continue
        depth = len(tree) - 1
        rows = [read(level, (idx >> d) ^ 1) for d, level in enumerate(tree[1:])]
        shape = lead + (q, len(seg.adds), depth, 8)
        got = torch.stack(rows, dim=-2) if rows else torch.zeros(
            idx.shape + (0, 8), dtype=torch.int32, device=x.device)
        parts.append(got.reshape(shape).reshape(-1))
    if not parts:
        return fp.zeros((0,), queries.device)
    return fp.as_u32(torch.cat(parts))


@functools.lru_cache(maxsize=256)
def _segment_table(segments: tuple, lead: tuple, q: int, lengths: tuple) -> tuple:
    """(records, total words) of `segments` over trees of `lengths` arrays
    each: the kernel's segment parameters, checked, one 14-word record a
    segment that writes a word."""
    firsts = np.cumsum((0,) + lengths[:-1]).tolist()
    segs, total = [], 0
    for seg in segments:
        if not 1 <= len(seg.adds) <= MAX_ADDS:
            raise ValueError(f"openings: {len(seg.adds)} slots a query (at most {MAX_ADDS})")
        depth = lengths[seg.tree] - 1
        words = math.prod(lead) * q * len(seg.adds) * (8 * depth if seg.path else 1)
        if words:
            segs.append([total, firsts[seg.tree], int(seg.path), depth if seg.path else 0,
                         len(seg.adds), seg.mask & ALL, *seg.adds, *[0] * (MAX_ADDS - len(seg.adds))])
        total += words
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"openings: {len(segs)} segments (at most {MAX_SEGMENTS})")
    return np.asarray(segs, dtype=np.uint32).reshape(-1, 14), total


@functools.lru_cache(maxsize=1024)
def _whole_tree(lead: tuple, log: int, levels: int) -> tuple:
    """(shapes, table words) of a whole tree behind `lead`: 2^log values,
    then `levels` digest levels of 2^log, 2^(log − 1), … rows."""
    return ([lead + (1 << log,)] + [lead + (1 << (log - k), 8) for k in range(levels)],
            [log] + [log - k for k in range(levels)])


def _array_table(trees: list, lead: tuple, sharded_ok: bool, card: int) -> np.ndarray:
    """The (n, 2) uint64 table of (pointer, log2 size | sharded << 32) of
    every array, tree by tree, each checked: a tree of whole arrays that halve
    level by level, the common case, by one comparison of its shapes (the
    table is rebuilt in every prove, on the host's hot path); any other array
    by itself."""
    ptrs, words = [], []
    for tree in trees:
        head = tree[0] if tree else None
        size = head.shape[-1] if isinstance(head, torch.Tensor) and head.dim() else 0
        if 1 <= size and len(tree) <= size.bit_length() + 1:
            shapes, logs = _whole_tree(lead, size.bit_length() - 1, len(tree) - 1)
            if ([a.shape if type(a) is not Block else None for a in tree] == shapes
                    and all(a.dtype is U32 and a.get_device() == card and a.is_contiguous()
                            for a in tree)):
                ptrs += [a.data_ptr() for a in tree]
                words += logs
                continue
        for arr in tree:
            t, log, _, block = _array_info(arr, lead, sharded_ok)
            if t.get_device() != card or not t.is_contiguous():
                raise ValueError("openings: every array must be contiguous on the queries' device")
            ptrs.append(t.data_ptr())
            words.append(log | (block << 32))
    if len(ptrs) > MAX_ARRAYS:
        raise ValueError(f"openings: {len(ptrs)} arrays (at most {MAX_ARRAYS})")
    table = np.empty((len(ptrs), 2), dtype=np.uint64)
    table[:, 0], table[:, 1] = ptrs, words
    return table


def describe(queries: torch.Tensor, trees: list, segments: tuple, shard: int | None = None):
    """The kernel's parameters for `openings`, built on the host: (segment
    records, array table as (n, 2) uint64, total words of the result)."""
    lead, q = tuple(queries.shape[:-1]), queries.shape[-1]
    segs, total = _segment_table(segments, lead, q, tuple(len(t) for t in trees))
    return segs, _array_table(trees, lead, shard is not None, queries.get_device()), total


def openings(queries: torch.Tensor, trees: list, segments, shard: int | None = None):
    """The openings of `segments` at the query indices: queries lead + (q,)
    uint32, trees a list of [values, level 0, level 1, …] (lead + (n,) and
    lead + (k, 8) uint32 tensors, or `Block`s on a shard), shard this shard's
    index or None. Returns the flat (total,) uint32 result."""
    global openings_launches
    if queries.dtype != torch.uint32 or queries.dim() < 1:
        raise ValueError("openings: the queries must be a (…, q) uint32 tensor")
    segments = tuple(segments)
    if queries.device.type == "cpu":
        return openings_plain(queries, trees, segments, shard)
    _build.require(queries, "openings", queries.dim())
    batch = math.prod(queries.shape[:-1])
    if shard is not None and batch != 1:
        raise ValueError(f"openings: a shard opens one proof, not {batch}")
    segs, table, total = describe(queries, trees, segments, shard)
    out = torch.empty(total, dtype=torch.uint32, device=queries.device)
    if len(segs) and len(table):
        with torch.cuda.device(queries.device):
            rc = _build.kernels().zk_openings(
                queries.data_ptr(), out.data_ptr(), total, batch, queries.shape[-1],
                -1 if shard is None else shard,
                segs.ctypes.data, len(segs), table.ctypes.data, len(table),
                _build.stream(queries),
            )
        _build.check(rc, "openings")
        openings_launches += 1
    return out
