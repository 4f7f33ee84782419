"""The port's limb-matrix DFT equals the JAX package's and the radix-2
transform, exactly (tolerance 0: the field has no rounding).

  * `limb_dft_rows` (its plain version, on CPU tensors) equals
    ``zkstark_tpu.ops.mxu_ntt.col_transform_mxu`` on the transposed block
    (eager jnp on the CPU, as tests/test_mxu_ntt.py runs it) and
    `ntt_rows_plain`, for m ∈ {128, 1024, 4096, 16384} and both primes;
  * one radix-64 stage equals exact Python integers;
  * the whole `ntt_rows` contract (a short valid prefix, `pre`, `uv`, `post`,
    `scale`) holds on the limb route;
  * `fourstep_supported` and `mxu_supported` give the JAX package's answers
    on 2^7..2^29, and 2^29 raises from `ntt_fourstep` with its size;
  * `ntt_fourstep` under ZKSTARK_MXU=on at 2^14 and 2^16 equals the default
    route and the JAX `ntt_fourstep` under the same switch;
  * small primes: the recombined sum V is at most 4k·255·(p − 1) < p·2^32
    for every odd prime, so REDC's precondition never fails and no field is
    refused; p = 257, 12289, 65537 and 786433 are exact against Python
    integers (the JAX package's ``_recombine`` was suspected of failing
    below 2^25).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.ops import mxu_ntt as jmxu
from zkstark_tpu.ops import ntt_kernel as jkernel
from zkstark_tpu_torch import ntt as tntt
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import limb_dft, ntt_kernel

FIELDS = [tfp.FIELD101, tfp.FIELD_ALT]
GEO = ntt_kernel.GeoScale


def _t(a):
    return tfp.from_host(np.asarray(a), "cpu")


def _rand_mont(fld, shape, seed):
    rng = np.random.default_rng(seed)
    return fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64))


@pytest.fixture
def mxu_on(monkeypatch):
    monkeypatch.setenv("ZKSTARK_MXU", "on")


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
@pytest.mark.parametrize("m", [128, 1024, 4096, 16384])
def test_limb_rows_match_jax_and_radix2(fld, m):
    jf = jfp.field_for(fld.p)
    w = fld.subgroup_generator(m)
    x = _rand_mont(fld, (3, m), seed=m)
    x[0, :3] = fld.host_to_mont(np.array([0, 1, fld.p - 1], dtype=np.uint64))
    before = limb_dft.limb_launches
    got = tfp.to_host(limb_dft.limb_dft_rows(_t(x), w, fld))
    assert limb_dft.limb_launches == before  # CPU tensors launch nothing
    want = np.asarray(jmxu.col_transform_mxu(jnp.asarray(np.ascontiguousarray(x.T)), w, jf))
    np.testing.assert_array_equal(got, want.T)
    np.testing.assert_array_equal(got, tfp.to_host(ntt_kernel.ntt_rows_plain(_t(x), w, fld)))


def test_radix64_stage_vs_bigint():
    """One stage, y[i] = Σ_j w^{ij}·x[j] mod p, against exact Python ints
    (tests/test_mxu_ntt.py::test_dft_matmul_vs_bigint)."""
    fld, k = tfp.FIELD101, 64
    rng = np.random.default_rng(2)
    x = rng.integers(0, fld.p, (k, 3), dtype=np.uint64)
    w = fld.subgroup_generator(k)
    v = tfp.wide(_t(fld.host_to_mont(x)))[None]  # (1, k, 3)
    got = tfp.to_host(tfp.from_mont_f(fld, tfp.narrow(limb_dft._dft_plain(v, k, w, fld)[0])))
    for i in range(k):
        for c in range(3):
            want = sum(pow(w, i * j, fld.p) * int(x[j, c]) for j in range(k)) % fld.p
            assert int(got[i, c]) == want


@pytest.mark.parametrize("p", [257, 12289, 65537, 786433])
def test_small_primes_are_exact(p):
    """No prime fails REDC's precondition (see the module docstring): the
    transform over a small 2-adic prime equals exact integer arithmetic, on
    inputs that include p − 1 everywhere (the largest limb sums)."""
    fld = tfp.field_for(p)
    m = 128
    w = fld.subgroup_generator(m)
    rng = np.random.default_rng(p)
    x = rng.integers(0, p, (2, m), dtype=np.uint64)
    x[1] = p - 1
    got = tfp.to_host(tfp.from_mont_f(fld, limb_dft.limb_dft_rows(_t(fld.host_to_mont(x)), w, fld)))
    powers = [pow(w, e, p) for e in range(m)]
    for r in range(2):
        for i in range(m):
            want = sum(powers[i * j % m] * int(x[r, j]) for j in range(m)) % p
            assert int(got[r, i]) == want
    # and on words that are not reduced below p: the limbs of any u32 are exact
    raw = rng.integers(0, 1 << 32, (1, m), dtype=np.uint64)
    got = tfp.to_host(tfp.from_mont_f(fld, limb_dft.limb_dft_rows(_t(raw.astype(np.uint32)), w, fld)))
    r_inv = pow(1 << 32, p - 2, p)
    for i in range(m):
        want = sum(powers[i * j % m] * int(raw[0, j]) for j in range(m)) * r_inv % p
        assert int(got[0, i]) == want


def test_recombined_sum_meets_redc_precondition():
    """V ≤ 4k·255·(p − 1) < p·2^32 at the largest radix, for the smallest odd
    prime and the largest one below 2^32; the s32 limb sums do not overflow."""
    k = limb_dft.MAX_RADIX
    for p in (3, 4294967291):
        assert 4 * k * 255 * (p - 1) < p << 32
    assert 255 * 255 * 4 * k < 1 << 31
    a = limb_dft._limb_matrix(16, tfp.FIELD101.subgroup_generator(16), tfp.FIELD101)
    a4 = a.astype(np.uint64).reshape(4, 16, 4, 16)
    entry = sum(a4[c] << np.uint64(8 * c) for c in range(4))  # the residue behind the bytes
    assert int(entry.max()) < tfp.FIELD101.p


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
@pytest.mark.parametrize("m,batch", [(128, 8), (2048, 4)])
def test_limb_rows_contract(fld, m, batch):
    """A short valid prefix, the pre-scale, the U·V twiddle, the post-scale
    and a scalar, each and together, as `ntt_rows` takes them."""
    w = fld.subgroup_generator(m)
    x = _t(_rand_mont(fld, (batch, m // 8 + 1), seed=m))
    ut = _t(_rand_mont(fld, (batch // 4, m), seed=1))
    vt = _t(_rand_mont(fld, (4, m), seed=2))
    full = dict(m=m, pre=GEO(5, 1 << 20, col_stride=batch, row_stride=1), uv=(ut, vt),
                post=GEO(7, 1 << 20, col_stride=3, row_stride=m), scale=fld.mont_scalar(12345))
    cases = [dict(m=m)] + [dict(m=m, **{k: v}) for k, v in full.items() if k != "m"] + [full]
    for kw in cases:
        got = limb_dft.limb_dft_rows(x, w, fld, **kw)
        want = ntt_kernel.ntt_rows_plain(x, w, fld, **kw)
        np.testing.assert_array_equal(tfp.to_host(got), tfp.to_host(want))


@pytest.mark.parametrize("bits", range(7, 30))
def test_supported_sizes_match_jax(bits):
    n = 1 << bits
    assert limb_dft.mxu_supported(n) == jmxu.mxu_supported(n)
    assert ntt_kernel.fourstep_supported(n) == jkernel.fourstep_supported(n)
    if bits in (27, 28):
        assert ntt_kernel.fourstep_supported(n)
    if bits == 29:
        assert not ntt_kernel.fourstep_supported(n)


def test_past_2e28_raises_from_fourstep():
    """2^29 has no route: `ntt_fourstep` says so itself, with the size and
    the largest supported one, before it builds any table."""
    x = tfp.zeros(1, "cpu")
    with pytest.raises(ValueError, match=r"ntt_fourstep.*2\^29.*2\^28"):
        ntt_kernel.ntt_fourstep(x, 1 << 29, tfp.FIELD101.subgroup_generator(1 << 29))
    with pytest.raises(ValueError, match=r"ntt_fourstep.*2\^29"):
        tntt.coset_ntt(x, 1 << 29, 5)


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_fourstep_limb_route_matches_default_and_jax(monkeypatch, n, inverse):
    fld = tfp.FIELD101
    x = _rand_mont(fld, n, seed=n + inverse)
    plan = (tntt.inverse_plan if inverse else tntt.forward_plan)(n)
    w = tntt.core._effective_root(plan)
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    default = tfp.to_host(ntt_kernel.ntt_fourstep(_t(x), n, w, plan.scale_mont, fld))
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    assert limb_dft.mxu_enabled() and jmxu.mxu_enabled()
    got = tfp.to_host(ntt_kernel.ntt_fourstep(_t(x), n, w, plan.scale_mont, fld))
    want = np.asarray(jkernel.ntt_fourstep(jnp.asarray(x), n, w, plan.scale_mont))
    np.testing.assert_array_equal(got, default)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_lde_entry_points_on_the_limb_route(monkeypatch, n):
    """`coset_ntt` of a short coefficient vector (the valid prefix and the
    pre-scale) and `coset_intt` (the post-scale and 1/n) under ZKSTARK_MXU=on
    equal the default route."""
    fld = tfp.FIELD_ALT
    coeffs = _t(_rand_mont(fld, n // 8 - 3, seed=n))
    evals = _t(_rand_mont(fld, n, seed=n + 1))
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    want = tntt.coset_ntt(coeffs, n, 5, fld), tntt.coset_intt(evals, 5, fld)
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    got = tntt.coset_ntt(coeffs, n, 5, fld), tntt.coset_intt(evals, 5, fld)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(tfp.to_host(g), tfp.to_host(w_))


def test_mxu_switch_is_read_at_every_call(monkeypatch):
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    assert not limb_dft.mxu_enabled() and not jmxu.mxu_enabled()
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    assert limb_dft.mxu_enabled() and jmxu.mxu_enabled()


def test_pease_switch_is_ignored_on_the_limb_route(monkeypatch):
    """Above MAX_ROW (here: with ZKSTARK_MXU=on) ZKSTARK_PEASE=on raises
    nothing and changes nothing."""
    fld, n = tfp.FIELD101, 1 << 14
    x = _t(_rand_mont(fld, n, seed=3))
    w = tntt.forward_plan(n).root
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    a = ntt_kernel.ntt_fourstep(x, n, w, None, fld)
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    b = ntt_kernel.ntt_fourstep(x, n, w, None, fld)
    np.testing.assert_array_equal(tfp.to_host(a), tfp.to_host(b))


@pytest.mark.parametrize("k", [8, 16, 32, 64, 128])
def test_fragment_order_of_the_kernel_matrix(k):
    """`_tile_words`, read as bytes the way the kernel's ``wgmma`` matrix
    descriptors address them (k-steps 4096 bytes apart, the two tiles of a
    pair 2048, groups of 8 rows 256, the two 16-byte K chunks 128, a row 16),
    holds `_limb_matrix` entry by entry: row 16·wq + 8·h + g of tile T of pair
    p is (c, i) = (2·T + h, 32·p + 8·wq + g), contraction byte 32·ks + kb is
    4·j + a, and rows past the radix are zero."""
    fld = tfp.FIELD101
    w = fld.subgroup_generator(k)
    a = limb_dft._limb_matrix(k, w, fld)
    words = limb_dft._tile_words(k, w, fld)
    raw = words.view(np.uint8)  # little-endian: byte a of a word is limb a
    pairs, ksteps = -(-k // 32), k // 8
    assert raw.size == pairs * ksteps * 4096
    p, ks, t, r, kb = np.meshgrid(np.arange(pairs), np.arange(ksteps), np.arange(2),
                                  np.arange(64), np.arange(32), indexing="ij")
    addr = (p * ksteps + ks) * 4096 + t * 2048 + (r // 8) * 256 + (kb // 16) * 128 + (r % 8) * 16 + kb % 16
    c, i = 2 * t + (r % 16) // 8, 32 * p + 8 * (r // 16) + r % 8
    j, limb = (32 * ks + kb) // 4, kb % 4
    want = np.where(i < k, a[k * c + np.minimum(i, k - 1), k * limb + j], 0)
    np.testing.assert_array_equal(raw[addr], want)
    assert np.unique(addr).size == raw.size  # every byte is addressed once


def test_limb_wrapper_checks_input():
    with pytest.raises(TypeError):
        limb_dft.limb_dft_rows(torch.zeros((1, 128), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="limb_dft_rows"):
        limb_dft.limb_dft_rows(tfp.zeros((1, 64), "cpu"), 1)
    with pytest.raises(ValueError, match="limb_dft_rows"):
        limb_dft.limb_dft_rows(tfp.zeros((1, 32768), "cpu"), 1)
    with pytest.raises(ValueError):
        limb_dft.limb_dft_rows(tfp.zeros((1, 200), "cpu"), 1, m=192)
