"""The fused core's packed result, written whole by the openings kernel's
segments (its plain twin on the CPU), against the JAX package word for word
(tolerance 0), and the Merkle levels it reads, one allocation a tree:

  * `fused_core_packed` and `fused_core_batch_packed` (B = 1 and 3) equal
    the JAX `fused_core_packed` and `pack_tree(fused_core_batch(...))` at
    trace_len 15 (128 points, 4 FRI rounds), and `prove_batch` of B = 1 and
    3 secrets gives each secret's solo proof;
  * the dict views of `fused_core_batch` and `fused_core` are views of that
    one vector;
  * on local meshes of S ∈ {2, 4} shards, each shard's owner-masked vector
    (the parts `Mesh.replicate` ORs) holds only words of the solo vector,
    shard 0 alone the roots, draws and free term, and their OR is the solo
    vector;
  * `build_levels_batch` writes every level of B trees into one allocation
    (`merkle.Levels`) at `level_offset`, after the trees' values where
    `merkle.tree_values` made them there, level for level equal to the levels
    hashed one call at a time and to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.protocol import batch as jbatch
from zkstark_tpu.protocol import fused as jfused
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import sha256_kernel
from zkstark_tpu_torch.parallel import make_mesh
from zkstark_tpu_torch.parallel.mesh import Mesh
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import fused, prove
from zkstark_tpu_torch.protocol.batch import prove_batch
from zkstark_tpu_torch.protocol.config import StarkConfig

TRACE_LEN = 15
SECRET = 3141592


def _configs():
    trace = tair.fibonacci_sq_trace(TRACE_LEN, SECRET)
    kw = dict(trace_len=TRACE_LEN, boundary_last=int(trace[-1]))
    return JaxConfig(**kw), StarkConfig(**kw)


def _traces(cfg, bsz):
    """B Montgomery traces (random words: the core does not check the AIR),
    the first the witness."""
    rng = np.random.default_rng(bsz)
    tr = rng.integers(0, cfg.field.p, (bsz, cfg.trace_len), dtype=np.uint64)
    tr[0] = tair.fibonacci_sq_trace(TRACE_LEN, SECRET)
    return cfg.field.host_to_mont(tr)


@pytest.fixture(scope="module")
def configs():
    return _configs()


@pytest.mark.parametrize("bsz", [1, 3])
def test_packed_result_matches_jax(configs, bsz):
    jcfg, cfg = configs
    traces = _traces(cfg, bsz)
    got = fused.fused_core_batch_packed(cfg, tfp.from_host(traces, "cpu"))
    if bsz == 1:
        want = np.asarray(jfused.fused_core_packed(jcfg, jnp.asarray(traces[0])))
        solo = fused.fused_core_packed(cfg, tfp.from_host(traces[0], "cpu"))
        np.testing.assert_array_equal(tfp.to_host(solo), want)
    else:
        want = np.asarray(jfused.pack_tree(jbatch.fused_core_batch(jcfg, jnp.asarray(traces))))
    np.testing.assert_array_equal(tfp.to_host(got), want)


def test_dicts_are_views_of_the_one_vector(configs):
    _, cfg = configs
    traces = tfp.from_host(_traces(cfg, 3), "cpu")
    flat = fused.fused_core_batch_packed(cfg, traces)
    out = fused.fused_core_batch(cfg, traces)
    leaves = [t for v in out.values() for t in (v if isinstance(v, list) else [v])]
    base = leaves[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in leaves)
    np.testing.assert_array_equal(tfp.to_host(fused.pack_tree(out)), tfp.to_host(flat))
    solo = fused.fused_core(cfg, traces[0])
    assert solo["roots"].shape == (2 + cfg.fri_rounds, 8) and solo["free_term"].shape == ()


@pytest.mark.parametrize("bsz", [1, 3])
def test_prove_batch_gives_solo_proofs(configs, bsz):
    _, cfg = configs
    secrets = [SECRET] * bsz
    want = prove(cfg, SECRET, device="cpu")
    assert prove_batch(cfg, secrets, device="cpu") == [want] * bsz


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_or_to_the_solo_vector(configs, shards, monkeypatch):
    _, cfg = configs
    trace = tfp.from_host(_traces(cfg, 1)[0], "cpu")
    solo = tfp.to_host(fused.fused_core_packed(cfg, trace)).astype(np.int64)
    seen = []
    replicate = Mesh.replicate

    def record(self, parts):
        seen.append([tfp.to_host(tfp.as_u32(p.view(torch.int32))).astype(np.int64)
                     for p in parts])
        return replicate(self, parts)

    monkeypatch.setattr(Mesh, "replicate", record)
    got = fused.fused_core_packed(cfg, trace, make_mesh(shards, device="cpu"))
    np.testing.assert_array_equal(tfp.to_host(got), solo.astype(np.uint32))
    parts = seen[-1]  # the packed result's, the last replicate of the prove
    assert len(parts) == shards
    merged = np.zeros_like(solo)
    for part in parts:
        own = part != 0
        np.testing.assert_array_equal(part[own], solo[own])  # only words of the solo vector
        merged |= part
    np.testing.assert_array_equal(merged, solo)
    # the replicated leaves (roots, draws, free term) come from shard 0 alone
    shapes = fused.out_shapes(cfg)
    at, whole = 0, np.zeros(solo.shape, dtype=bool)
    for key in sorted(shapes):
        for shape in shapes[key] if isinstance(shapes[key], list) else [shapes[key]]:
            size = int(np.prod(shape, dtype=np.int64))
            whole[at : at + size] = not key.startswith("open_")
            at += size
    assert all(not part[whole].any() for part in parts[1:])
    np.testing.assert_array_equal(parts[0][whole], solo[whole])


@pytest.mark.parametrize("head", [False, True], ids=["levels", "values+levels"])
@pytest.mark.parametrize("bsz,n,tail", [(1, 1, None), (1, 2, None), (3, 64, None), (2, 64, 4)])
def test_levels_in_one_allocation(bsz, n, tail, head, monkeypatch):
    """`tail`: the tail's parents, set low so that the leaf and node calls
    write their levels into the allocation too (as from 4096 leaves up);
    `head`: the values made by `merkle.tree_values`, the levels written after
    them in their allocation."""
    if tail:
        monkeypatch.setattr(sha256_kernel, "TAIL_PARENTS", tail)
    rng = np.random.default_rng(n + bsz)
    vals = rng.integers(0, 1 << 32, (bsz, n), dtype=np.uint64).astype(np.uint32)
    values, room = tfp.from_host(vals, "cpu"), None
    if head:
        values, room = merkle.tree_values(bsz, n, "cpu")
        values.copy_(tfp.from_host(vals, "cpu"))
    levels = merkle.build_levels_batch(values, room)
    assert isinstance(levels, merkle.Levels) and len(levels) == n.bit_length()
    buf, skip = levels.buffer, merkle.values_words(bsz, n) if head else 0
    assert levels.head == skip
    assert buf.shape == (skip + merkle.level_offset(n, n.bit_length(), bsz),)
    if head:
        assert values.data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(tfp.to_host(buf[: bsz * n]).reshape(bsz, n), vals)
    want = jmerkle.build_levels_batch(jnp.asarray(vals))
    level = sha256_kernel.leaf_hash_plain(tfp.from_host(vals.reshape(-1), "cpu"))
    for lv, (got, w) in enumerate(zip(levels, want)):
        assert got.data_ptr() == buf.data_ptr() + 4 * (skip + merkle.level_offset(n, lv, bsz))
        assert got.shape == (bsz, n >> lv, 8)
        np.testing.assert_array_equal(tfp.to_host(got), np.asarray(w))
        np.testing.assert_array_equal(tfp.to_host(got).reshape(-1, 8), tfp.to_host(level))
        if lv < n.bit_length() - 1:
            level = sha256_kernel.node_hash_pairs_plain(level)
    back = merkle.levels_from_host([tfp.to_host(lv) for lv in levels], "cpu")
    np.testing.assert_array_equal(tfp.to_host(back.buffer), tfp.to_host(buf[skip:]))
    solo = merkle.build_levels(tfp.from_host(vals[0], "cpu"))
    assert isinstance(solo, merkle.Levels)
    for s, g in zip(solo, levels):
        np.testing.assert_array_equal(tfp.to_host(s), tfp.to_host(g)[0])


def test_levels_room_must_be_the_values_allocation():
    """`build_levels_batch(values, room)` writes after the values only into
    the allocation `tree_values` made for them, and refuses any other."""
    values, room = merkle.tree_values(2, 16, "cpu")
    _, other = merkle.tree_values(2, 16, "cpu")
    with pytest.raises(ValueError, match="room"):
        merkle.build_levels_batch(values, other)
    with pytest.raises(ValueError, match="room"):
        merkle.build_levels_batch(values[:1], room)

