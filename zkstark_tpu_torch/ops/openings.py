"""The fused core's packed result in one launch on Hopper
(``csrc/openings.cu``): every phase-4 opening, the roots, the free term and
the chain's draws, written straight into one flat vector.

`openings` replaces ``zkstark_tpu/protocol/fused.py:225-316`` (`_take_val`,
`_take_digest`, `_auth_path`, `sparse_openings`) and the packing of the
result (``:151-168``, the stacks of roots and draws and `pack_tree`), which
XLA fused into the fused core's one program; as plain tensor ops the gathers
alone are some 330 launches at stark-101 and 900 at 2^24.

The result is a list of `Segment`s, each a leaf of the packed vector in its
order (``protocol/openings.py`` lays them out), B-major: proof b's words of
a leaf follow proof b − 1's. The kinds:

  * VALUES: tree `tree`'s values at the indices idx = ((x & mask) +
    adds[i]) & mask of each query x (the JAX index rules: x + k·blowup per
    shift with mask = 2^32 − 1; a FRI layer's x & (size − 1) and its partner
    + size/2), (q, n_idx) words a proof; (q, n_idx, w) for a tree whose leaf
    is a row of w words (`Tree.width`), the row's words;
  * PATHS: the auth paths at those indices, level l the sibling digest
    levels[l][(idx >> l) ^ 1] for l below the root, (q, n_idx, depth, 8);
  * ROOTS: the roots of `count` trees from `tree` on, (count, 8);
  * FIRST: value 0 of tree `tree`, one word a proof: the free term, the
    last FRI layer's constant;
  * COPY: `count` words a proof of source `tree` of `copies` (a (B, ·)
    tensor whose rows are `stride` words apart), from word `offset` of each
    row: the chain's draws.

A tree reaches the kernel as a `Tree`: a few pointers and sizes, the digest
levels being one allocation (``hash/merkle.py`` `Levels`), which on the
fused core holds the tree's values too, whose level offsets the kernel
computes from the tree's size. A shard of the sharded
prover passes `shard`; a `Block` is then this shard's block of an array
sharded over the mesh (2^k words or rows: it owns index i where
i >> k = shard, at i & (2^k − 1)), and a whole array (every COPY source, the
levels above a sharded tree's subtree roots) is read by shard 0 alone. Where
the shard does not own a word the result is 0, so that the bitwise OR of
every shard's vector is the whole result (``parallel/mesh.py``
`Mesh.replicate`).

The parameters go by value in one block sized to what it holds (`describe`):
a header, the trees' records and the segments' records, each of these
followed by its tree's record (or its COPY source's pointer), so that the
kernel reaches every address through one record. They are built once per
shape and cached; a call fills in only the pointers. On a CPU tensor `openings`
runs `openings_plain`, which makes the same checks and computes every
address with the kernel's formulas; on a CUDA tensor only the kernel.
"""

from __future__ import annotations

import functools
import operator
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ops import _build

U32 = torch.uint32
VALUES, PATHS, ROOTS, COPY, FIRST = range(5)
MAX_ADDS = 8
MAX_TREES = 255
ALL = 0xFFFFFFFF  # the mask of an index that is not reduced
# the parameter block (csrc/openings.cu): a header, the trees, the segments;
# a segment's record holds its tree's record (or its COPY source's pointer)
# after `SEG_OWN_WORDS` words of its own
HEADER_WORDS, TREE_WORDS, SEG_OWN_WORDS = 10, 8, 12
SEG_WORDS = SEG_OWN_WORDS + TREE_WORDS
# how a tree reaches the kernel (`_collect`'s key: log_n + 64·how + 256·(width
# − 1)): one allocation of values and levels; values and levels apart; a
# shard's blocks; and the top above them
ONE, APART, BLOCK, BLOCK_TOP = range(4)
# the block sizes the kernel is built for, in words (the largest just under
# the 32,764 bytes of parameters Hopper takes)
CAPACITIES = (256, 512, 768, 1024, 2048, 4096, 8188)
THREADS = 512  # a block of the kernel; a segment's paths put 8·2^lg threads on a slot

openings_launches = 0  # launches of openings_kernel, counted by openings


@dataclass(frozen=True)
class Segment:
    """One leaf of the result (see the module docstring for the kinds)."""

    kind: int
    tree: int  # VALUES, PATHS: the tree read; ROOTS: the first tree; COPY: the source
    mask: int = ALL  # VALUES, PATHS
    adds: tuple = (0,)  # VALUES, PATHS: the slots a query
    count: int = 1  # ROOTS: the trees; COPY: the words a proof
    stride: int = 0  # COPY: the words between two proofs' rows in the source
    offset: int = 0  # COPY: the first word read of each row


class Block(NamedTuple):
    """A shard's block of an array that is sharded over the mesh."""

    words: torch.Tensor


class Tree(NamedTuple):
    """One Merkle tree of 2^log_n leaves as the kernel reads it.

    Whole (every proof of the batch): `values` lead + (n,) residues and
    `levels` the flat buffer of its digest levels (`hash.merkle.Levels.buffer`:
    level l, lead + (n >> l, 8), at word `merkle.level_offset(n, l, B)`), `top`
    None; or `values` None and `levels` one allocation of the B·n values
    followed, from word `merkle.values_words(B, n)` on, by the levels (a
    `Levels.buffer` whose head holds them: `merkle.tree_values`). On a shard: `values` a `Block` of this shard's (n/S,) residues,
    `levels` a `Block` of its subtree's buffer (levels 0 … log2(n/S), the
    subtree's root last), and `top` the flat buffer of the whole levels above
    (S/2 rows up to the root), None at S = 1. A whole tree whose leaf is a
    row of `width` = w > 1 words (a trace of w columns) has values lead + (w,
    n), each proof's columns one after the other, and VALUES opens the row."""

    values: torch.Tensor | Block
    levels: torch.Tensor | Block
    log_n: int
    top: torch.Tensor | None = None
    width: int = 1


def _tensor(a) -> torch.Tensor:
    return a.words if type(a) is Block else a


class Plan(NamedTuple):
    words: np.ndarray  # the parameter block with its pointers 0
    slots: np.ndarray  # the uint64 positions of the pointers
    # for each slot, its pointer's place in [queries, result] + `_collect`'s
    # pointers (a tree's pointers stand in its record and in its segments')
    sources: np.ndarray
    total: int  # words of the result
    n_segs: int  # segments that write a word: the grid's x
    bsz: int  # the proofs: the grid's y

    @property
    def block_bytes(self) -> int:
        """The bytes of the parameter block the kernel is launched with: the
        smallest of `CAPACITIES` that holds the words."""
        return 4 * next(c for c in CAPACITIES if c >= len(self.words))


def _slots_code(kind: int, tree: int, n_idx: int, ln: int, lg: int) -> int:
    return kind | ln << 4 | lg << 8 | tree << 16 | n_idx << 24


@functools.lru_cache(maxsize=256)
def describe(segments: tuple, lead: tuple, q: int, sharded: bool, shapes: tuple) -> Plan:
    """The kernel's parameter block for `segments` over trees and copy
    sources of `shapes` (`_collect`'s key: how each tree comes, the arrays'
    shapes, the number of sources), checked: header, tree records and
    segment records (each with its tree's record or its source's pointer)
    with every pointer 0, the pointers' uint64 slots and what fills each,
    the result's words and the segments that write one."""
    flags, arrays, n_copies = shapes
    tree_shapes, at = [], 0
    for f in flags:
        log_n, how, width = f & 63, (f >> 6) & 3, (f >> 8) + 1
        take = (1, 2, 2, 3)[how]
        got = arrays[at : at + take]
        at += take
        tree_shapes.append((log_n, None, got[0], None, False, width) if how == ONE else
                           (log_n, got[0], got[1], got[2] if how == BLOCK_TOP else None,
                            how != APART, width))
    copy_shapes = arrays[at:]
    assert len(copy_shapes) == n_copies
    bsz = int(np.prod(lead, dtype=np.int64))
    n_trees = len(tree_shapes)
    if n_trees > MAX_TREES:
        raise ValueError(f"openings: {n_trees} trees (at most {MAX_TREES})")
    # (log_n | log_blk << 8 | sharded << 16 | (width − 1) << 20, head, its
    # pointers' (slot, source))
    trees, widths = [], []
    at = 2  # the pointers' places after the queries' and the result's
    for log_n, vshape, lshape, tshape, block, width in tree_shapes:
        if not 0 <= log_n <= 30:
            raise ValueError(f"openings: a tree of 2^{log_n} leaves")
        if block != sharded and block:
            raise ValueError("openings: a shard's block without a shard index")
        if width > 1 and block:
            raise ValueError(f"openings: a shard's block of rows of {width} words")
        row = () if width == 1 else (width,)
        head = 0
        if vshape is None:  # the values at the head of the levels' allocation
            if block:
                raise ValueError("openings: a shard's block needs its values")
            vshape, head = lead + row + (1 << log_n,), values_words(bsz * width, 1 << log_n)
        size = vshape[0] if block else (vshape[-1] if vshape else 0)
        if (size < 1 or size & (size - 1) or size > 1 << log_n
                or (not block and (tuple(vshape[:-1]) != lead + row or size != 1 << log_n))
                or (block and len(vshape) != 1)):
            raise ValueError(f"openings: values of shape {tuple(vshape)} for a tree of "
                             f"2^{log_n} leaves of {width} words behind {lead}")
        log_blk = size.bit_length() - 1
        rows = 1 if block else bsz
        if lshape != (head + 8 * rows * (2 * size - 1),):
            raise ValueError(f"openings: levels of shape {tuple(lshape)}: not the one flat "
                             f"allocation of a tree of {size} leaves (hash.merkle.Levels)")
        want_top = None if log_blk == log_n else (8 * ((1 << (log_n - log_blk)) - 1),)
        if (tshape if tshape is None else tuple(tshape)) != want_top or (want_top and not block):
            raise ValueError(f"openings: a top of shape {tshape} for a tree of 2^{log_n} "
                             f"leaves whose block has {size}")
        ptrs = [(0, at)] + ([] if head else [(1, at + 1)])  # values, levels
        if want_top:
            ptrs.append((2, at + len(ptrs)))  # the top
        at += len(ptrs)
        trees.append((log_n | log_blk << 8 | int(block) << 16 | (width - 1) << 20, head, ptrs))
        widths.append(width)
    segs, total = [], 0  # (own words, the tree's record or the source's pointer)
    for seg in segments:
        n_idx = len(seg.adds)
        if seg.kind in (VALUES, PATHS):
            if not seg.tree < n_trees or not 1 <= n_idx <= MAX_ADDS:
                raise ValueError(f"openings: {seg} reads no tree or has {n_idx} slots "
                                 f"(at most {MAX_ADDS})")
            depth = trees[seg.tree][0] & 255 if seg.kind == PATHS else 0
            per_proof = q * n_idx * (8 * depth if seg.kind == PATHS else widths[seg.tree])
            ln = (n_idx - 1).bit_length()
            lg = (depth - 1).bit_length() if depth else 0
            if 8 << lg > THREADS:
                raise ValueError(f"openings: paths of depth {depth}")
            code = _slots_code(seg.kind, seg.tree, n_idx, ln, lg)
            rec = ([total, code, per_proof, seg.mask & ALL, *seg.adds, *[0] * (MAX_ADDS - n_idx)],
                   trees[seg.tree])
        elif seg.kind == ROOTS:
            if not 0 <= seg.tree and seg.tree + seg.count <= n_trees:
                raise ValueError(f"openings: {seg} reads no tree")
            per_proof = 8 * seg.count
            rec = ([total, _slots_code(ROOTS, seg.tree, 0, 0, 0), per_proof, 0, seg.count,
                    *[0] * 7], (0, 0, []))
        elif seg.kind == FIRST:
            if not seg.tree < n_trees:
                raise ValueError(f"openings: {seg} reads no tree")
            per_proof = 1
            rec = ([total, _slots_code(FIRST, seg.tree, 0, 0, 0), per_proof, 0, *[0] * 8],
                   trees[seg.tree])
        elif seg.kind == COPY:
            if not seg.tree < len(copy_shapes):
                raise ValueError(f"openings: {seg} copies no source")
            shape = copy_shapes[seg.tree]
            need = (bsz - 1) * seg.stride + seg.offset + seg.count
            if (len(shape) < 1 or int(np.prod(shape, dtype=np.int64)) < need or seg.count < 0
                    or seg.offset < 0):
                raise ValueError(f"openings: a source of shape {tuple(shape)} for {seg}")
            per_proof = seg.count
            rec = ([total, _slots_code(COPY, seg.tree, 0, 0, 0), per_proof, seg.stride,
                    seg.offset, *[0] * 7], (0, 0, [(0, at + seg.tree)]))
        else:
            raise ValueError(f"openings: no segment kind {seg.kind}")
        if per_proof and bsz:
            segs.append(rec)
        total += bsz * per_proof
    if total > 0x7FFFFFFF:
        raise ValueError(f"openings: {total} words")
    base = HEADER_WORDS + TREE_WORDS * n_trees
    n_words = base + SEG_WORDS * len(segs)
    if n_words > CAPACITIES[-1]:
        raise ValueError(f"openings: a parameter block of {n_words} words "
                         f"(at most {CAPACITIES[-1]})")
    words = np.zeros(n_words, dtype=np.uint32)
    # the shard and the queries' row stride are filled in by the call
    words[4:10] = [q, ALL if not sharded else 0, bsz, n_trees, q, len(segs)]
    slots, sources = [0, 1], [0, 1]  # the queries, the result

    def record(at: int, tree: tuple) -> None:  # a tree's record from word `at` (even)
        words[at + 6 : at + 8] = tree[:2]
        for k, src in tree[2]:
            slots.append(at // 2 + k)
            sources.append(src)

    for i, tree in enumerate(trees):
        record(HEADER_WORDS + TREE_WORDS * i, tree)
    for s_, (own, tree) in enumerate(segs):
        at = base + SEG_WORDS * s_
        words[at : at + SEG_OWN_WORDS] = own
        record(at + SEG_OWN_WORDS, tree)
    words.setflags(write=False)
    return Plan(words, np.asarray(slots, dtype=np.int64), np.asarray(sources, dtype=np.int64),
                total, len(segs), bsz)


_DTYPE, _SHAPE = operator.attrgetter("dtype"), operator.attrgetter("shape")
_U32 = {U32}


def values_words(bsz: int, n: int) -> int:
    """The words of B trees' values at the head of their one allocation
    (`hash.merkle.tree_values`), padded so that the digests after them are
    32-byte aligned."""
    return -(-bsz * n // 8) * 8


def _collect(queries, trees, copies) -> tuple:
    """One pass over a call's arrays, each checked to be a contiguous uint32
    tensor on the queries' device: (the key `describe` reads — how each tree
    comes (log_n + 64·`ONE`/`APART`/`BLOCK`/`BLOCK_TOP`), the arrays' shapes,
    the number of sources —, the arrays' pointers in `Plan.slots`' order after
    the queries' and the result's). The wrapper's per-call host work: the
    attributes are read with `map` over one flat list."""
    arrays, flags = [], []
    for t in trees:
        v, lv, top = t.values, t.levels, t.top
        row = 256 * (t.width - 1)
        if v is None:
            arrays.append(lv)
            flags.append(t.log_n + row)
        elif type(v) is Block:
            lv = lv.words if type(lv) is Block else lv
            arrays += (v.words, lv) if top is None else (v.words, lv, top)
            flags.append(t.log_n + 64 * (BLOCK if top is None else BLOCK_TOP) + row)
        else:
            arrays += (v, lv)
            flags.append(t.log_n + 64 * APART + row)
    arrays += copies
    if arrays and (set(map(_DTYPE, arrays)) != _U32
                   or set(map(torch.Tensor.get_device, arrays)) != {queries.get_device()}
                   or not all(map(torch.Tensor.is_contiguous, arrays))):
        raise ValueError("openings: every array and source must be a contiguous uint32 tensor "
                         "on the queries' device")
    return ((tuple(flags), tuple(map(_SHAPE, arrays)), len(copies)),
            list(map(torch.Tensor.data_ptr, arrays)))


# (id(segments), lead, q, sharded, shapes) → (segments, plan, its writable
# parameter block, that block's address): the call's lookup, which hashes no
# Segment; `describe` builds and checks what is missing
_PLANS: dict = {}


def _plan_block(segments: tuple, lead: tuple, q: int, sharded: bool, shapes: tuple) -> tuple:
    key = (id(segments), lead, q, sharded, shapes)
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not segments:
        plan = describe(segments, lead, q, sharded, shapes)
        words = plan.words.copy()
        if len(_PLANS) > 256:
            _PLANS.clear()
        hit = _PLANS[key] = (segments, plan, words, words.ctypes.data)
    return hit[1:]


# ---------------------------------------------------------------------------
# the plain twin: the kernel's addresses, as whole-tensor gathers
# ---------------------------------------------------------------------------


def _level_rows(tree: Tree, level, idx: torch.Tensor, bsz: int, shard):
    """Rows of digest level(s) `level` (an int64 tensor broadcast with idx,
    (B, r) row indices of that level) → ((B, r, 8) int32 words, owned), as the
    kernel addresses them: the block's levels at 8·rows·(2N − 2N/2^l), N its
    leaves, then the top's at 8·(2R − 2R/2^l'), R the rows of its first."""
    log_blk = (_tensor(tree.values).shape[-1]).bit_length() - 1
    block = type(tree.values) is Block
    whole_own = shard is None or shard == 0
    b = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)[:, None]
    in_block = level <= log_blk
    # the block's levels
    rows_log = (log_blk - level).clamp(min=0)
    n2 = 2 << log_blk
    first = (1 if block else bsz) * (n2 - (n2 >> level.clamp(max=log_blk)))
    if block:
        own_a = (idx >> rows_log) == shard
        row_a = first + (idx & ((1 << rows_log) - 1))
    else:
        own_a = (idx < (1 << rows_log)) & whole_own
        row_a = first + (b << rows_log) + idx
    words_a = fp.as_i32(_tensor(tree.levels)).view(-1, 8)
    got = words_a[torch.where(in_block & own_a, row_a, 0)]
    own = in_block & own_a
    if tree.top is not None:  # the whole levels above the subtree roots
        l2 = (level - log_blk - 1).clamp(min=0)
        r2 = 2 << (tree.log_n - log_blk - 1)
        own_b = ~in_block & (idx < (r2 >> (l2 + 1))) & whole_own
        row_b = r2 - (r2 >> l2) + idx
        words_b = fp.as_i32(tree.top).view(-1, 8)
        got = torch.where(own_b[..., None], words_b[torch.where(own_b, row_b, 0)], got)
        own = own | own_b
    return torch.where(own[..., None], got, 0)


def _values(tree: Tree, idx: torch.Tensor, shard) -> torch.Tensor:
    """(B, r) int32 values at the (B, r) indices, owner-masked; (B, r, w)
    rows of a tree of rows."""
    vals = fp.as_i32(_tensor(tree.values))
    if tree.width > 1:  # a whole tree, and shard 0 or none
        vals = vals.reshape(idx.shape[0], tree.width, -1)
        own = (idx < vals.shape[-1]) & (shard is None or shard == 0)
        at = torch.where(own, idx, 0)[:, None, :].expand(-1, tree.width, -1)
        got = torch.take_along_dim(vals, at, dim=-1).transpose(1, 2)
        return torch.where(own[..., None], got, 0)
    if type(tree.values) is Block:
        log_blk = vals.shape[0].bit_length() - 1
        own = (idx >> log_blk) == shard
        idx = idx & ((1 << log_blk) - 1)
        vals = vals[None]
    else:
        own = (idx < vals.shape[-1]) & (shard is None or shard == 0)
        vals = vals.reshape(idx.shape[0], -1)
    got = torch.take_along_dim(vals, torch.where(own, idx, 0), dim=-1)
    return torch.where(own, got, 0)


def openings_plain(queries: torch.Tensor, trees: list, segments, shard: int | None = None,
                   copies: tuple = ()) -> torch.Tensor:
    """Plain-torch twin of the kernel, same arguments: each segment's words
    from the same addresses, owner-masked on a shard, in order."""
    lead, q = tuple(queries.shape[:-1]), queries.shape[-1]
    plan = describe(tuple(segments), lead, q, shard is not None, _collect(queries, trees, copies)[0])
    bsz = int(np.prod(lead, dtype=np.int64))
    trees = [t if t.values is not None else t._replace(  # one allocation: split it
        values=t.levels[: bsz * t.width << t.log_n].view(
            lead + ((t.width,) if t.width > 1 else ()) + (1 << t.log_n,)),
        levels=t.levels[values_words(bsz * t.width, 1 << t.log_n):]) for t in trees]
    x = fp.wide(queries.reshape(bsz, q))
    dev = queries.device
    whole_own = shard is None or shard == 0
    parts = []
    for seg in segments:
        if seg.kind in (VALUES, PATHS):
            tree = trees[seg.tree]
            adds = torch.tensor(seg.adds, dtype=torch.int64, device=dev)
            idx = (((x & seg.mask)[..., None] + adds) & seg.mask).reshape(bsz, -1)
            if seg.kind == VALUES:
                parts.append(_values(tree, idx, shard).reshape(-1))
                continue
            depth = tree.log_n
            lv = torch.arange(depth, dtype=torch.int64, device=dev)
            sib = ((idx[..., None] >> lv) ^ 1).reshape(bsz, -1)
            got = _level_rows(tree, lv.repeat(idx.shape[1])[None], sib, bsz, shard)
        elif seg.kind == ROOTS:
            rows = [_level_rows(trees[t], torch.tensor([trees[t].log_n], device=dev),
                                torch.zeros((bsz, 1), dtype=torch.int64, device=dev), bsz, shard)
                    for t in range(seg.tree, seg.tree + seg.count)]
            got = torch.cat(rows, dim=1) if rows else torch.zeros((bsz, 0, 8), dtype=torch.int32)
        elif seg.kind == FIRST:
            got = _values(trees[seg.tree], torch.zeros((bsz, 1), dtype=torch.int64, device=dev),
                          shard)
        else:  # COPY
            src = fp.as_i32(copies[seg.tree]).reshape(-1)
            at = (torch.arange(bsz, device=dev)[:, None] * seg.stride + seg.offset
                  + torch.arange(seg.count, device=dev))
            got = src[at] if whole_own else torch.zeros_like(at, dtype=torch.int32)
        parts.append(got.reshape(-1))
    out = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int32, device=dev)
    assert out.numel() == plan.total
    return fp.as_u32(out)


def openings(queries: torch.Tensor, trees: list, segments, shard: int | None = None,
             copies: tuple = ()) -> torch.Tensor:
    """The words of `segments` at the query indices: queries lead + (q,)
    uint32 (rows evenly strided, such as columns of the fused core's draws),
    trees a list of `Tree`s, shard this shard's index or None, copies the
    COPY sources. Returns the flat (total,) uint32 result."""
    global openings_launches
    if queries.dtype != torch.uint32 or queries.dim() < 1:
        raise ValueError("openings: the queries must be a (…, q) uint32 tensor")
    segments = tuple(segments)
    copies = tuple(copies)
    card = queries.get_device()
    if card < 0:
        return openings_plain(queries, trees, segments, shard, copies)
    lead, q = tuple(queries.shape[:-1]), queries.shape[-1]
    if shard is not None and lead not in ((1,), ()):
        raise ValueError(f"openings: a shard opens one proof, not {lead}")
    strides = queries.stride()
    if queries.dim() > 2 and not queries.is_contiguous():
        raise ValueError("openings: queries of more than two axes must be contiguous")
    row = strides[-2] if queries.dim() == 2 and lead[0] > 1 else q
    if q and (strides[-1] != 1 or row < q):
        raise ValueError("openings: the queries' rows must be evenly strided")
    key, ptrs = _collect(queries, trees, copies)
    plan, words, addr = _plan_block(segments, lead, q, shard is not None, key)
    out = torch.empty(plan.total, dtype=torch.uint32, device=queries.device)
    if plan.n_segs:
        words.view(np.uint64)[plan.slots] = np.array(
            [queries.data_ptr(), out.data_ptr(), *ptrs], dtype=np.uint64)[plan.sources]
        words[5] = ALL if shard is None else shard
        words[8] = row
        lib = _build.kernels()
        if card == torch.cuda.current_device():
            rc = lib.zk_openings(addr, len(words), plan.n_segs, plan.bsz, _build.stream(queries))
        else:
            with torch.cuda.device(card):
                rc = lib.zk_openings(addr, len(words), plan.n_segs, plan.bsz,
                                     _build.stream(queries))
        _build.check(rc, "openings")
        openings_launches += 1
    return out
