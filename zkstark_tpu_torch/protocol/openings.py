"""Phase-4 openings as sparse device gathers — counterpart of
``zkstark_tpu/protocol/fused.py`` ``_take_val`` / ``_take_digest`` /
``_auth_path`` / ``sparse_openings``.

The opened values and the auth-path sibling digests are gathered on the
device and fetched in one transfer of a few KB; the Merkle levels (about
3 GB at a 2^24 domain) never leave the device. On a card the gathers are one
launch of the kernel behind ``ops/openings.py``, which writes them straight
into one flat vector in `pack_tree`'s layout (`sparse_openings_packed`; the
sharded prover calls it once a local shard, ``parallel/pipeline.py``). The
fused core's launch (`packed_result`) writes its whole packed result: the
openings, the roots, the free term and the chain's draws.

`sparse_openings_device` takes the query indices as a device tensor of any
leading batch shape and returns views of that vector, so the fused core
(``protocol/fused.py``) never waits for the host; `pack_tree` / `unpack_tree`
carry such a dict to the host as one vector. `sparse_openings` is the same
for host query indices, fetched at once (the host-synced prover).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import openings as open_op


def map_leaves(tree: dict, fn) -> dict:
    """fn on every leaf of a dict whose values are leaves or lists of leaves."""
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v) for k, v in tree.items()}


def tree_leaves(tree: dict, keys=None) -> list:
    """The leaves of a dict whose values are leaves or lists of leaves, in
    `pack_tree`'s order: keys sorted (those of `keys` alone, where given),
    lists in order."""
    leaves = []
    for key in sorted(tree if keys is None else keys):
        leaves += tree[key] if isinstance(tree[key], list) else [tree[key]]
    return leaves


def pack_tree(out: dict) -> torch.Tensor:
    """Every uint32 leaf of a dict of device tensors ravelled into one flat
    device vector (keys sorted, lists in order): one transfer instead of some
    thirty, re-sliced on the host by `unpack_tree`."""
    return fp.as_u32(torch.cat([fp.as_i32(leaf).reshape(-1) for leaf in tree_leaves(out)]))


def unpack_tree(flat: np.ndarray, shapes: dict) -> dict:
    """Inverse of `pack_tree`: `shapes` is the dict of the leaves' shapes;
    returns numpy arrays (or, for a tensor, views of it) in that
    structure."""
    flat = flat if isinstance(flat, torch.Tensor) else np.asarray(flat)
    pos = 0

    def take(shape):
        nonlocal pos
        size = int(np.prod(shape, dtype=np.int64))
        part = flat[pos : pos + size].reshape(shape)
        pos += size
        return part

    out = {}
    for key in sorted(shapes):
        v = shapes[key]
        out[key] = [take(s) for s in v] if isinstance(v, list) else take(v)
    assert pos == flat.shape[0], (pos, flat.shape)
    return out


def opening_shapes(cfg, lead: tuple = ()) -> dict:
    """The shape of every opening leaf behind the leading axes `lead`; a
    trace opening of w > 1 columns is the row of w values."""
    q, shifts, rounds = cfg.n_queries, len(cfg.air.shifts), cfg.fri_rounds
    depth = cfg.eval_domain.bit_length() - 1
    row = (cfg.air.width,) if cfg.air.width > 1 else ()
    return {
        "open_f_vals": lead + (q, shifts) + row,
        "open_f_paths": lead + (q, shifts, depth, 8),
        "open_cp_vals": lead + (q,),
        "open_cp_paths": lead + (q, depth, 8),
        "open_fri_vals": [lead + (q, 2) for _ in range(rounds)],
        "open_fri_paths": [lead + (q, 2, depth - layer, 8) for layer in range(rounds)],
    }


@functools.lru_cache(maxsize=64)
def segments(cfg) -> tuple:
    """The opening leaves as `ops.openings.Segment`s in `pack_tree`'s order
    (keys sorted, lists in order), over the trees of `trees`: 0 the trace,
    1 + k FRI layer k (layer 0 the composition). The index rules are the JAX
    package's: x + shift·blowup for the trace, x itself for the composition,
    x & (size − 1) and its partner + size/2 for a FRI layer of `size` points."""
    seg, vals, paths = open_op.Segment, open_op.VALUES, open_op.PATHS
    f_adds = tuple(k * cfg.blowup for k in cfg.air.shifts)
    layers = [(1 + k, cfg.eval_domain >> k) for k in range(cfg.fri_rounds)]
    return (
        seg(paths, 1),  # open_cp_paths
        seg(vals, 1),  # open_cp_vals
        seg(paths, 0, adds=f_adds),  # open_f_paths
        seg(vals, 0, adds=f_adds),  # open_f_vals
        *(seg(paths, t, size - 1, (0, size // 2)) for t, size in layers),  # open_fri_paths
        *(seg(vals, t, size - 1, (0, size // 2)) for t, size in layers),  # open_fri_vals
    )


def draw_columns(cfg) -> tuple:
    """The columns of the fused core's (B, ·) draws tensor: (alphas, betas,
    queries) as (first, count), n_constraints + fri_rounds + n_queries words
    a row."""
    nc, rounds = cfg.n_constraints, cfg.fri_rounds
    return (0, nc), (nc, rounds), (nc + rounds, cfg.n_queries)


@functools.lru_cache(maxsize=64)
def packed_segments(cfg) -> tuple:
    """Every leaf of the fused core's packed result (``protocol/fused.py``
    `out_shapes`, keys sorted) as `Segment`s over the 2 + fri_rounds trees of
    `trees` (the last FRI layer's last) and one source, the (B, ·) draws of
    `draw_columns`: the alphas, betas and queries copied from their columns,
    the free term (the last layer's value 0), the openings, the roots."""
    seg, copy = open_op.Segment, open_op.COPY
    alphas, betas, queries = draw_columns(cfg)
    width = sum(count for _, count in draw_columns(cfg))
    return (
        seg(copy, 0, count=alphas[1], stride=width, offset=alphas[0]),  # alphas
        seg(copy, 0, count=betas[1], stride=width, offset=betas[0]),  # betas
        seg(open_op.FIRST, 1 + cfg.fri_rounds),  # free_term
        *segments(cfg),  # open_*
        seg(copy, 0, count=queries[1], stride=width, offset=queries[0]),  # queries
        seg(open_op.ROOTS, 0, count=2 + cfg.fri_rounds),  # roots
    )


def _tree(res, levels, block: int | None, width: int = 1) -> open_op.Tree:
    """One tree as the openings kernel reads it: whole, or on a shard its
    block `block` of a sharded tree (``parallel/merkle_sharded.py``); a tree
    of rows of `width` words where its leaves are rows."""
    if isinstance(res, list):
        return open_op.Tree(open_op.Block(res[block]), open_op.Block(levels.blocks[block]),
                            len(levels) - 1, levels.top)
    if not isinstance(levels, merkle.Levels):
        raise ValueError("openings: a tree's levels must be one allocation (hash.merkle.Levels)")
    # values made at the head of the allocation (merkle.tree_values): one pointer
    return open_op.Tree(None if levels.head else res, levels.buffer, len(levels) - 1,
                        width=width)


def trees(f_res, f_levels, layer_res, layer_levels, block: int | None = None,
          width: int = 1) -> list:
    """The `ops.openings.Tree`s of the trace (of rows of `width` words) and
    of each FRI layer (layer 0 the composition), whole or, on a shard, block
    `block` of each sharded one."""
    return [_tree(f_res, f_levels, block, width)] + [
        _tree(res, levels, block) for res, levels in zip(layer_res, layer_levels)
    ]


def sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, queries,
                           shard: int | None = None, block: int = 0) -> torch.Tensor:
    """Every phase-4 opening at the (…, q) uint32 device query indices as one
    flat uint32 device vector in `pack_tree`'s layout of
    `sparse_openings_device`'s dict: one kernel launch on a card. Layer 0 of
    layer_res / layer_levels is the composition tree; the levels are
    `hash.merkle.Levels`. On shard `shard` of a mesh (B = 1), the values that
    are lists are sharded, and item `block` of each is this shard's block
    (`ops.openings.Block`; see there for the owner rule)."""
    t = trees(f_res, f_levels, layer_res, layer_levels, None if shard is None else block,
              cfg.air.width)
    return open_op.openings(queries, t, segments(cfg), shard)


def packed_result(cfg, f_res, f_levels, layer_res, layer_levels, draws,
                  shard: int | None = None, block: int = 0) -> torch.Tensor:
    """The fused core's whole packed result, `out_shapes`' leaves B-major in
    sorted order, in one kernel launch on a card: `sparse_openings_packed`'s
    openings at the queries of `draws` (the (B, ·) draws of `draw_columns`),
    the 2 + fri_rounds roots of the trace and every layer, the free term
    (value 0 of the last layer) and the alphas, betas and queries. On a shard
    as `sparse_openings_packed`; shard 0 alone writes the roots above the
    subtrees, the draws and the free term."""
    t = trees(f_res, f_levels, layer_res, layer_levels, None if shard is None else block,
              cfg.air.width)
    first, count = draw_columns(cfg)[2]
    queries = draws[:, first : first + count]
    return open_op.openings(queries, t, packed_segments(cfg), shard, (draws,))


def sparse_openings_device(cfg, f_res, f_levels, layer_res, layer_levels, queries) -> dict:
    """`sparse_openings` with the query indices on the device: `queries` is a
    (…, q) uint32 tensor whose leading axes match those of the values (…, n)
    and levels (…, k, 8). Returns views of `sparse_openings_packed`'s vector
    with the JAX package's shapes behind the leading axes: open_f_vals (…, q,
    n_shifts) ((…, q, n_shifts, w) for a trace of w > 1 columns),
    open_f_paths (…, q, n_shifts, depth, 8), open_cp_vals (…, q),
    open_cp_paths (…, q, depth, 8) and per FRI layer open_fri_vals (…, q, 2),
    open_fri_paths (…, q, 2, depth, 8). Makes no call that waits for the
    device."""
    flat = sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, queries)
    return unpack_tree(flat, opening_shapes(cfg, tuple(queries.shape[:-1])))


def sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries) -> dict:
    """Every phase-4 opening (values and auth-path siblings) for the host
    query indices `queries`, as host numpy, in one transfer:
    `sparse_openings_packed` on the uploaded indices, then one fetch. Layer 0
    of layer_res / layer_levels is the composition tree."""
    idx = fp.from_host(np.asarray(queries, dtype=np.uint32), f_res.device)
    flat = sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, idx)
    return unpack_tree(fp.to_host(flat), opening_shapes(cfg))
