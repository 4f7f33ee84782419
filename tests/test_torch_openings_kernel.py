"""The phase-4 openings of the port (`ops.openings`, whose plain twin reads
the same segments and pointer table that the CUDA kernel ``csrc/openings.cu``
reads) equal ``zkstark_tpu.protocol.fused.sparse_openings`` word for word
(tolerance 0: no floats), on random values and digest levels made from a
seed with numpy:

  * at q ∈ {1, 3} queries and B ∈ {1, 3} proofs (B = 1 also without a batch
    axis, as the host-synced prover calls it), for the three AIRs (one, two
    and three shifts) and the alt prime's blowup 16;
  * the flat vector is `pack_tree` of the dict: the fused core's layout;
  * on a mesh of S ∈ {2, 4} shards, each shard's owner-masked vector (the
    arrays of at least S words or rows split into blocks, the others whole)
    OR-ed together equals the solo vector, and `parallel.pipeline.openings`
    on a local mesh gives the solo dict;
  * the kernel's parameters (`describe`: the segment records and the
    pointer table) name every array with its pointer and log2 size, whether
    a tree is checked whole or array by array (shards, odd trees);
  * the wrapper refuses what the kernel does not take.
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
from zkstark_tpu_torch.ops import openings as open_op
from zkstark_tpu_torch.parallel import make_mesh
from zkstark_tpu_torch.parallel import pipeline as pl
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
    t = lambda a: tfp.from_host(a, "cpu")  # noqa: E731
    return t(f_res), [t(v) for v in f_levels], [t(v) for v in layer_res], \
        [[t(v) for v in lv] for lv in layer_levels]


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


def _shard(arr, shards):
    """A (1, n[, 8]) array as S blocks where it has at least S words or rows."""
    n = arr.shape[1]
    if n < shards:
        return arr
    k = n // shards
    return [arr[0, s * k : (s + 1) * k].clone() for s in range(shards)]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("q", [1, 3])
def test_owner_masked_shards_or_to_the_solo_result(shards, q):
    _, cfg = _configs("fibonacci-sq", tfp.P, 8, q)
    args = _inputs(cfg, (1,), seed=100 + shards + q)
    f_res, f_levels, layer_res, layer_levels = _torch(*args[:4])
    idx = tfp.from_host(args[4], "cpu")
    solo = topen.sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, idx)
    sh = lambda a: _shard(a, shards)  # noqa: E731
    sharded = (sh(f_res), [sh(v) for v in f_levels], [sh(v) for v in layer_res],
               [[sh(v) for v in lv] for lv in layer_levels])
    parts = [topen.sparse_openings_packed(cfg, *sharded, idx, shard=s, block=s)
             for s in range(shards)]
    assert all(p.shape == solo.shape for p in parts)
    merged = parts[0].view(torch.int32).clone()
    for part in parts[1:]:
        merged |= part.view(torch.int32)
    np.testing.assert_array_equal(tfp.to_host(tfp.as_u32(merged)), tfp.to_host(solo))
    assert any(tfp.to_host(p).sum() != tfp.to_host(solo).sum() for p in parts)  # masks work
    mesh = make_mesh(shards, device="cpu")
    got = pl.openings(cfg, *sharded, idx, mesh)
    _assert_dicts_equal(got, topen.unpack_tree(tfp.to_host(solo),
                                               topen.opening_shapes(cfg, (1,))))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, cfg = _configs()
    f_res, f_levels, layer_res, layer_levels = _torch(*_inputs(cfg, (), seed=7)[:4])
    idx = tfp.from_host(np.zeros(1, dtype=np.uint32), "cpu")
    with pytest.raises(ValueError):  # the queries are not uint32
        open_op.openings(idx.view(torch.int32), [[f_res]], topen.segments(cfg)[3:4])
    with pytest.raises(ValueError):  # a block outside a shard
        open_op.openings(idx, [[open_op.Block(f_res)]], [open_op.Segment(0, False, 7, (0,))])
    with pytest.raises(ValueError):  # values that are not a power of two long
        open_op.openings(idx, [[f_res[:5]]], [open_op.Segment(0, False, 3, (0,))])
    assert open_op.openings(idx, [[f_res]], []).numel() == 0


@pytest.mark.parametrize("shards,lead", [(None, ()), (None, (1,)), (None, (3,)), (4, (1,))],
                         ids=["solo", "B1", "B3", "shard"])
def test_describe_names_every_array(shards, lead):
    _, cfg = _configs("fibonacci-sq", tfp.P, 8, 3)
    args = _inputs(cfg, lead, seed=200 + len(lead))
    tens = list(_torch(*args[:4]))
    idx = tfp.from_host(args[4], "cpu")
    if shards:
        sh = lambda a: _shard(a, shards)  # noqa: E731
        tens = [sh(tens[0]), [sh(v) for v in tens[1]], [sh(v) for v in tens[2]],
                [[sh(v) for v in lv] for lv in tens[3]]]
    trees = topen._trees(cfg, *tens)
    if shards:
        trees = [[open_op.Block(a[1]) if isinstance(a, list) else a for a in t] for t in trees]
    else:  # a tree that does not halve is read array by array
        trees[-1] = [trees[-1][0], trees[-1][1][..., ::2, :].contiguous()]
    segs = topen.segments(cfg)
    records, table, total = open_op.describe(idx, trees, segs, 1 if shards else None)
    arrays = [a for t in trees for a in t]
    assert table.shape == (len(arrays), 2) and table.dtype == np.uint64
    for (ptr, word), arr in zip(table.tolist(), arrays):
        t = arr.words if isinstance(arr, open_op.Block) else arr
        rows = t.shape[0 if isinstance(arr, open_op.Block) else len(lead)]
        assert ptr == t.data_ptr() and word == (rows.bit_length() - 1) | (
            isinstance(arr, open_op.Block) << 32)
    assert records.shape == (len(segs), 14) and records[0, 0] == 0
    assert total == sum(open_op.segment_words(g, trees, lead, cfg.n_queries) for g in segs)
    assert total == open_op.openings(idx, trees, segs, 1 if shards else None).numel()
