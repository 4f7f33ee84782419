"""The phase-4 openings of the port (`ops.openings`, whose plain twin reads
the same parameter block, with the kernel's address formulas, that the CUDA
kernel ``csrc/openings.cu`` reads) equal
``zkstark_tpu.protocol.fused.sparse_openings`` word for word (tolerance 0:
no floats), on random values and digest levels made from a seed with numpy
and uploaded as the trees' one allocation (`hash.merkle.Levels`):

  * at q ∈ {1, 3} queries and B ∈ {1, 3} proofs (B = 1 also without a batch
    axis, as the host-synced prover calls it), for the three AIRs (one, two
    and three shifts) and the alt prime's blowup 16;
  * the flat vector is `pack_tree` of the dict: the fused core's layout;
  * on a mesh of S ∈ {2, 4} shards, each shard's owner-masked vector (the
    trees of at least S leaves as each shard's subtree and the whole levels
    above, `parallel.merkle_sharded.shard_tree`) OR-ed together equals the
    solo vector, and `parallel.pipeline.packed` on a local mesh gives the
    solo packed result;
  * the kernel's parameters (`describe`: the header, the tree records and
    the segment records, each with its tree's record or its source's
    pointer) hold every tree's sizes and, once the wrapper fills them in,
    every pointer;
  * the wrapper refuses what the kernel does not take, a tree whose levels
    are not one allocation among it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.protocol import air as jair
from zkstark_tpu.protocol import fused as jfused
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import openings as open_op
from zkstark_tpu_torch.parallel import make_mesh
from zkstark_tpu_torch.parallel import pipeline as pl
from zkstark_tpu_torch.parallel.merkle_sharded import shard_tree
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import openings as topen
from zkstark_tpu_torch.protocol.config import StarkConfig

TRACE_LEN = 63


def _configs(air="fibonacci-sq", p=tfp.P, blowup=8, q=1):
    kw = dict(trace_len=TRACE_LEN, blowup=blowup, boundary_first=1, boundary_last=1,
              n_queries=q, coset_offset=5 if p == tfp.P else 31)
    return (JaxConfig(field=jfp.field_for(p), air=jair.AIRS[air], **kw),
            StarkConfig(field=tfp.field_for(p), air=tair.AIRS[air], **kw))


def _tree(rng, lead, n):
    """Random values lead + (n,) and digest levels lead + (k, 8), k = n … 1."""
    vals = rng.integers(0, 1 << 32, lead + (n,), dtype=np.uint64).astype(np.uint32)
    levels, k = [], n
    while k >= 1:
        levels.append(rng.integers(0, 1 << 32, lead + (k, 8), dtype=np.uint64).astype(np.uint32))
        k //= 2
    return vals, levels


def _inputs(cfg, lead, seed):
    rng = np.random.default_rng(seed)
    d = cfg.eval_domain
    f_res, f_levels = _tree(rng, lead, d)
    layers = [_tree(rng, lead, d >> k) for k in range(cfg.fri_rounds + 1)]
    queries = rng.integers(0, cfg.query_range, lead + (cfg.n_queries,), dtype=np.uint64)
    queries[(0,) * len(lead) + (0,)] = cfg.query_range - 1  # the last opened trace point
    return f_res, f_levels, [v for v, _ in layers], [lv for _, lv in layers], \
        queries.astype(np.uint32)


def _jax(jcfg, f_res, f_levels, layer_res, layer_levels, queries):
    j = jnp.asarray
    qs = [j(queries[..., i]) for i in range(queries.shape[-1])]
    out = jfused.sparse_openings(jcfg, j(f_res), [j(v) for v in f_levels],
                                 [j(v) for v in layer_res], [[j(v) for v in lv] for lv in layer_levels],
                                 qs)
    return {k: [np.asarray(t) for t in v] if isinstance(v, list) else np.asarray(v)
            for k, v in out.items()}


def _torch(f_res, f_levels, layer_res, layer_levels):
    """The trees on the CPU, each tree's levels one allocation."""
    t = lambda a: tfp.from_host(a, "cpu")  # noqa: E731
    lv = lambda levels: merkle.levels_from_host(levels, "cpu")  # noqa: E731
    return t(f_res), lv(f_levels), [t(v) for v in layer_res], [lv(v) for v in layer_levels]


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k] if isinstance(got[k], list) else [got[k]]
        w = want[k] if isinstance(want[k], list) else [want[k]]
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            a = tfp.to_host(a) if isinstance(a, torch.Tensor) else a
            assert a.shape == b.shape, (k, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=k)


CASES = [("fibonacci-sq", tfp.P, 8), ("fibonacci", tfp.P, 4), ("square-chain", tfp.P_ALT, 16)]


@pytest.mark.parametrize("air,p,blowup", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("lead", [(), (1,), (3,)], ids=["solo", "B1", "B3"])
def test_openings_match_jax(air, p, blowup, q, lead):
    jcfg, cfg = _configs(air, p, blowup, q)
    args = _inputs(cfg, lead, seed=q + 10 * len(lead) + blowup)
    want = _jax(jcfg, *args)
    tens = _torch(*args[:4])
    idx = tfp.from_host(args[4], "cpu")
    got = topen.sparse_openings_device(cfg, *tens, idx)
    _assert_dicts_equal(got, want)
    flat = topen.sparse_openings_packed(cfg, *tens, idx)
    np.testing.assert_array_equal(tfp.to_host(flat), tfp.to_host(topen.pack_tree(got)))
    if not lead:  # the host-synced form: host indices, host numpy out
        _assert_dicts_equal(topen.sparse_openings(cfg, *tens, [int(x) for x in args[4]]), want)


def _shard(values, levels, shards):
    """One tree of (1, n) values as S shards of a local mesh hold it."""
    return shard_tree(values, levels, shards)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("q", [1, 3])
def test_owner_masked_shards_or_to_the_solo_result(shards, q):
    _, cfg = _configs("fibonacci-sq", tfp.P, 8, q)
    args = _inputs(cfg, (1,), seed=100 + shards + q)
    f_res, f_levels, layer_res, layer_levels = _torch(*args[:4])
    idx = tfp.from_host(args[4], "cpu")
    solo = topen.sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, idx)
    f_sh = _shard(f_res, f_levels, shards)
    layers = [_shard(v, lv, shards) for v, lv in zip(layer_res, layer_levels)]
    sharded = (*f_sh, [v for v, _ in layers], [lv for _, lv in layers])
    parts = [topen.sparse_openings_packed(cfg, *sharded, idx, shard=s, block=s)
             for s in range(shards)]
    assert all(p.shape == solo.shape for p in parts)
    merged = parts[0].view(torch.int32).clone()
    for part in parts[1:]:
        merged |= part.view(torch.int32)
    np.testing.assert_array_equal(tfp.to_host(tfp.as_u32(merged)), tfp.to_host(solo))
    assert any(tfp.to_host(p).sum() != tfp.to_host(solo).sum() for p in parts)  # masks work
    # the fused core's whole packed result through the pipeline's mesh step
    head = np.arange(cfg.n_constraints + cfg.fri_rounds, dtype=np.uint32)  # alphas, betas
    draws = tfp.from_host(np.concatenate([head, args[4].reshape(-1)])[None], "cpu")
    want = pl.packed(cfg, f_res, f_levels, layer_res, layer_levels, draws, None)
    got = pl.packed(cfg, *sharded, draws, make_mesh(shards, device="cpu"))
    np.testing.assert_array_equal(tfp.to_host(got), tfp.to_host(want))
    np.testing.assert_array_equal(tfp.to_host(want)[-8 * (2 + cfg.fri_rounds) - q:][:q],
                                  args[4].reshape(-1))  # the queries copied


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, cfg = _configs()
    f_res, f_levels, layer_res, layer_levels = _torch(*_inputs(cfg, (), seed=7)[:4])
    idx = tfp.from_host(np.zeros(1, dtype=np.uint32), "cpu")
    tree = open_op.Tree(f_res, f_levels.buffer, f_res.shape[0].bit_length() - 1)
    vals = open_op.Segment(open_op.VALUES, 0, 7)
    with pytest.raises(ValueError):  # the queries are not uint32
        open_op.openings(idx.view(torch.int32), [tree], topen.segments(cfg)[3:4])
    with pytest.raises(ValueError):  # a block outside a shard
        open_op.openings(idx, [tree._replace(values=open_op.Block(f_res))], [vals])
    with pytest.raises(ValueError):  # values that are not a power of two long
        open_op.openings(idx, [tree._replace(values=f_res[:5])], [vals])
    with pytest.raises(ValueError):  # levels that are not the tree's one allocation
        open_op.openings(idx, [tree._replace(levels=f_levels.buffer[8:])], [vals])
    with pytest.raises(ValueError):  # a list of levels, not `hash.merkle.Levels`
        topen.sparse_openings_packed(cfg, f_res, list(f_levels), layer_res, layer_levels, idx)
    with pytest.raises(ValueError):  # a copy source shorter than its segment
        open_op.openings(idx, [tree], [open_op.Segment(open_op.COPY, 0, count=4)], copies=(idx,))
    assert open_op.openings(idx, [tree], []).numel() == 0


@pytest.mark.parametrize("shards,lead", [(None, ()), (None, (1,)), (None, (3,)), (4, (1,))],
                         ids=["solo", "B1", "B3", "shard"])
def test_describe_names_every_array(shards, lead):
    """The parameter block holds the header, each tree's sizes and each
    segment's record, followed by its tree's record or its COPY source's
    pointer; with the pointers filled in as the wrapper fills them, every
    slot holds its tensor's address."""
    _, cfg = _configs("fibonacci-sq", tfp.P, 8, 3)
    args = _inputs(cfg, lead, seed=200 + len(lead))
    tens = list(_torch(*args[:4]))
    idx = tfp.from_host(args[4], "cpu")
    if shards:
        f_sh = _shard(tens[0], tens[1], shards)
        layers = [_shard(v, lv, shards) for v, lv in zip(tens[2], tens[3])]
        tens = [*f_sh, [v for v, _ in layers], [lv for _, lv in layers]]
    trees = topen.trees(*tens, block=1 if shards else None)
    q = cfg.n_queries
    segs = topen.segments(cfg) + (open_op.Segment(open_op.COPY, 0, count=q, stride=q),)
    key, ptrs = open_op._collect(idx, trees, (idx,))
    plan = open_op.describe(segs, lead, q, bool(shards), key)
    bsz = int(np.prod(lead, dtype=np.int64))
    words = plan.words
    assert tuple(words[4:10]) == (q, 0 if shards else open_op.ALL, bsz, len(trees), q, len(segs))
    tree_words, seg_words = open_op.TREE_WORDS, open_op.SEG_WORDS
    for i, t in enumerate(trees):
        rec = words[open_op.HEADER_WORDS + tree_words * i:][:tree_words]
        block = isinstance(t.values, open_op.Block)
        size = (t.values.words if block else t.values).shape[-1]
        assert rec[6] == t.log_n | (size.bit_length() - 1) << 8 | int(block) << 16
        assert t.log_n == cfg.eval_domain.bit_length() - 1 - max(i - 1, 0)
    assert plan.n_segs == len(segs)
    base = open_op.HEADER_WORDS + tree_words * len(trees)
    recs = words[base:].reshape(-1, seg_words)
    assert recs[0, 0] == 0 and all(recs[1:, 0] > recs[:-1, 0])
    out = torch.empty(plan.total, dtype=torch.uint32)
    filled = words.copy()
    filled.view(np.uint64)[plan.slots] = np.array(
        [idx.data_ptr(), out.data_ptr(), *ptrs], dtype=np.uint64)[plan.sources]
    got = filled.view(np.uint64)
    assert got[0] == idx.data_ptr() and got[1] == out.data_ptr()

    def holds(at: int, t) -> None:  # tree t's record from word `at`
        at //= 2
        assert got[at] == open_op._tensor(t.values).data_ptr()
        assert got[at + 1] == open_op._tensor(t.levels).data_ptr()
        assert got[at + 2] == (0 if t.top is None else t.top.data_ptr())

    for i, t in enumerate(trees):
        holds(open_op.HEADER_WORDS + tree_words * i, t)
    for k, seg in enumerate(segs):
        tail = base + seg_words * k + open_op.SEG_OWN_WORDS
        if seg.kind == open_op.COPY:
            assert got[tail // 2] == idx.data_ptr()
        else:
            holds(tail, trees[seg.tree])
            at = open_op.HEADER_WORDS + tree_words * seg.tree
            assert tuple(words[tail + 6 : tail + 8]) == tuple(words[at + 6 : at + 8])
    assert plan.total == open_op.openings(idx, trees, segs, 1 if shards else None,
                                          (idx,)).numel()
    assert plan.block_bytes <= 4096
