"""The port's sharded transforms, trees, folds and composition against the
JAX package's single-device functions: twins of ``tests/test_sharded.py``.

Every sharded result is gathered from its blocks in shard order and must
equal the JAX result word for word, at S ∈ {1, 2, 4, 8}. The JAX side runs
unsharded (mesh None) and jitted, so no sharded XLA program is compiled;
`proof_core` is held to the JAX package's in ``test_torch_proof_core.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import zkstark_tpu.parallel as jpar
from zkstark_tpu import ntt as jntt
from zkstark_tpu.field import fp as jfp
from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.protocol import prover as jpr
from zkstark_tpu.protocol.air import FIBONACCI_SQ as JFIB
from zkstark_tpu.protocol.config import STARK101 as JSTARK101
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.parallel import (
    coset_ntt_sixstep,
    fold_sharded,
    make_mesh,
    ntt_sixstep,
    sharded_build_levels,
    sharded_commit,
)
from zkstark_tpu_torch.parallel import pipeline
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol.config import STARK101, StarkConfig

SIZES = [1, 2, 4, 8]
rng = np.random.default_rng(0xD15C)


@functools.lru_cache(maxsize=None)
def _rand_mont(n: int, seed: int = 0) -> np.ndarray:
    r = np.random.default_rng(seed + n)
    return jfp.host_to_mont(r.integers(0, jfp.P, size=n, dtype=np.uint64).astype(np.uint32))


def _gather(blocks) -> np.ndarray:
    return np.concatenate([fp.to_host(b) for b in blocks])


def _t(a: np.ndarray):
    return fp.from_host(np.asarray(a, dtype=np.uint32), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_ntt(n: int) -> tuple:
    x = jnp.asarray(_rand_mont(n))
    root = jfp.subgroup_generator(n)
    return (np.asarray(jax.jit(lambda v: jpar.ntt_sixstep(v, n, root))(x)),
            np.asarray(jax.jit(lambda v: jntt.ntt(v, jntt.forward_plan(n)))(x)))


@pytest.mark.parametrize("n", [256, 4096, 65536])
@pytest.mark.parametrize("s", SIZES)
def test_sixstep_matches_jax(n, s):
    six, flat = _jax_ntt(n)
    np.testing.assert_array_equal(six, flat)
    mesh = make_mesh(s, device="cpu")
    x = _t(_rand_mont(n))
    got = ntt_sixstep(mesh.shard(x), n, jfp.subgroup_generator(n), mesh=mesh)
    np.testing.assert_array_equal(_gather(got), flat)
    assert mesh.bytes_moved["all_to_all"] == 3 * 4 * n * (s - 1) // s


def test_sixstep_without_a_mesh_matches_jax():
    n = 4096
    got = ntt_sixstep(_t(_rand_mont(n)), n, jfp.subgroup_generator(n))
    np.testing.assert_array_equal(fp.to_host(got), _jax_ntt(n)[1])


@pytest.mark.parametrize("s", [2, 8])
def test_sixstep_inverse_roundtrip(s):
    n = 4096
    mesh = make_mesh(s, device="cpu")
    x = _t(_rand_mont(n))
    root = jfp.subgroup_generator(n)
    back = ntt_sixstep(ntt_sixstep(mesh.shard(x), n, root, mesh=mesh), n, root, mesh=mesh,
                       inverse=True)
    np.testing.assert_array_equal(_gather(back), fp.to_host(x))


@pytest.mark.parametrize("s", [1, 8])
def test_coset_sixstep_matches_jax_coset_ntt(s):
    n, k = 8192, 1024
    coeffs = _rand_mont(k)
    want = np.asarray(jax.jit(lambda c: jntt.coset_ntt(c, n, 5))(jnp.asarray(coeffs)))
    got = coset_ntt_sixstep(_t(coeffs), n, 5, mesh=make_mesh(s, device="cpu"))
    np.testing.assert_array_equal(_gather(got), want)


def test_sixstep_limb_route(monkeypatch):
    """ZKSTARK_MXU=on sends both passes of rows through `limb_dft_rows`."""
    from zkstark_tpu_torch.ops import limb_dft

    n = 1 << 16
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    calls = []
    real = limb_dft.limb_dft_rows
    monkeypatch.setattr(limb_dft, "limb_dft_rows", lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = make_mesh(8, device="cpu")
    got = ntt_sixstep(mesh.shard(_t(_rand_mont(n))), n, jfp.subgroup_generator(n), mesh=mesh)
    np.testing.assert_array_equal(_gather(got), _jax_ntt(n)[1])
    assert len(calls) == 2 * 8


@functools.lru_cache(maxsize=None)
def _jax_levels(n: int) -> list:
    vals = np.random.default_rng(n).integers(0, 1 << 32, size=n, dtype=np.uint64)
    vals = vals.astype(np.uint32)
    build = jax.jit(lambda v: jmerkle.build_levels(v, planar=False))
    return vals, [np.asarray(lv) for lv in build(jnp.asarray(vals))]


@pytest.mark.parametrize("s", SIZES)
def test_sharded_levels_match_jax(s):
    vals, want = _jax_levels(4096)
    mesh = make_mesh(s, device="cpu")
    levels = sharded_build_levels(mesh.shard(_t(vals)), mesh)
    assert len(levels) == len(want)
    for got, ref in zip(levels, want):
        whole = _gather(got) if isinstance(got, list) else fp.to_host(got)
        np.testing.assert_array_equal(whole.reshape(ref.shape), ref)
    tree = sharded_commit(mesh.shard(_t(vals)), mesh)
    jtree = jmerkle.MerkleTree(levels=[jnp.asarray(lv) for lv in want])
    assert tree.root() == jtree.root()
    for i in (0, 1, 2047, 4095):
        assert tree.auth_path(i) == jtree.auth_path(i)


@pytest.mark.parametrize("m,s,layer", [(8192, 1, 0), (8192, 2, 0), (8192, 4, 0), (8192, 8, 0),
                                       (16, 8, 9), (8, 8, 10)])
def test_fold_matches_jax(m, s, layer):
    """Sharded while m/2 ≥ S; at m/2 < S (the last case) the layer is gathered
    and folded whole, the JAX package's rule."""
    evals = _rand_mont(m, seed=layer)
    beta = 123456789
    beta_m = jpr._mont_scalar(beta)
    inv_x = jpr.fri_layer_constants(JSTARK101, layer)[: m // 2]
    inv2 = jpr._mont_scalar(jpr._INV2)
    want = np.asarray(jax.jit(lambda e: jpar.fold_sharded(e, beta_m, inv_x, inv2))(
        jnp.asarray(evals)))
    mesh = make_mesh(s, device="cpu")
    beta_t = _t(np.array([beta_m]))
    folded, res, _ = pipeline.fold(STARK101, layer, mesh.shard(_t(evals)), beta_t, mesh)
    sharded = m // 2 >= s
    assert isinstance(folded, list) == sharded
    got = _gather(folded) if sharded else fp.to_host(folded)[0]
    np.testing.assert_array_equal(got, want)
    if sharded:
        inv_base, inv_off = tpr._fri_layer_params(STARK101, layer)
        direct, _ = fold_sharded(mesh.shard(_t(evals)), beta_t, inv_base, inv_off, mesh)
        np.testing.assert_array_equal(_gather(direct), want)
        assert mesh.bytes_moved["exchange"] == 2 * 4 * m * (s - 1) // s


def _small_cfgs():
    trace = JFIB.trace(63, 31415)
    kw = dict(trace_len=63, boundary_first=int(trace[0]), boundary_last=int(trace[-1]))
    return JaxConfig(**kw), StarkConfig(**kw)


@pytest.mark.parametrize("which,s", [("stark101", 1), ("stark101", 2), ("stark101", 8),
                                     ("small", 4), ("small", 64)])
def test_sharded_composition_matches_jax(which, s):
    """One composition launch a shard on its block and the next shard's
    halo; at S = 64 the 8-point shards are smaller than the 16-word halo and
    the domain is gathered."""
    jcfg, cfg = (JSTARK101, STARK101) if which == "stark101" else _small_cfgs()
    d = cfg.eval_domain
    f_eval = _rand_mont(d, seed=7)
    alphas = np.array([jpr._mont_scalar(a) for a in (11, 22, 33)], np.uint32)
    want = np.asarray(jax.jit(lambda f, a: jpr.composition_eval(jcfg, f, a))(
        jnp.asarray(f_eval), jnp.asarray(alphas)))
    mesh = make_mesh(s, device="cpu")
    cp, res, levels = pipeline.composition(cfg, mesh.shard(_t(f_eval)), _t(alphas), mesh)
    np.testing.assert_array_equal(_gather(cp), want)
    want_res = fp.to_host(fp.from_mont_f(cfg.field, _t(want)))
    np.testing.assert_array_equal(_gather(res), want_res)
    # the residues' tree, built with them: the JAX root of the whole residues
    np.testing.assert_array_equal(fp.to_host(levels[-1]).reshape(8),
                                  np.asarray(jmerkle.build_levels(jnp.asarray(want_res))[-1])
                                  .reshape(8))
    halo = pipeline.halo_words(cfg)
    # the halo crosses to another shard where there is one (S = 1 sends to itself)
    assert mesh.bytes_moved.get("exchange", 0) == (4 * halo * s if halo and 1 < s <= d // halo else 0)
