"""The port's LDE entry points on the fused `ntt_rows` contract equal the JAX
package's, exactly (tolerance 0: the field has no rounding).

On the CPU every wrapper runs its plain-torch twin, which takes the kernel's
own arguments (the valid prefix, the pre- and post-scale tables, the U·V
twiddle, the scalar), so these tests hold the twins of the fused contract and
the glue the card runs against ``zkstark_tpu.ntt.core`` ``coset_ntt``,
``intt``, ``coset_intt`` and ``zkstark_tpu.ops.ntt_kernel.ntt_fourstep``, for
both primes, at sizes on both sides of the four-step threshold (2^14) and at
blowup 4, 8 and 16. The JAX side runs jitted on the CPU, as
tests/test_torch_ntt.py and tests/test_torch_pease.py run it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkstark_tpu.ntt.core as jntt
from zkstark_tpu.field import fp as jfp
from zkstark_tpu.ops import ntt_kernel as jkernel
from zkstark_tpu_torch import STARK101, STARK101_SECRET, prove
from zkstark_tpu_torch import ntt as tntt
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import ntt_kernel
from zkstark_tpu_torch.protocol.checkpoint import ResumableProver

FIELDS = pytest.mark.parametrize("fld", [tfp.FIELD101, tfp.FIELD_ALT], ids=["p101", "alt"])
SIZES = pytest.mark.parametrize("log_n", [10, 13, 14, 16])
OFFSET = 5


def _t(a):
    return tfp.from_host(np.asarray(a), "cpu")


def _rand_mont(fld, shape, seed):
    rng = np.random.default_rng(seed)
    return fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64))


def _padded(coeffs, n):
    return np.concatenate([coeffs, np.zeros(n - coeffs.shape[0], np.uint32)])


@functools.lru_cache(maxsize=None)
def _jax_coset_ntt(n, p):
    jf = jfp.field_for(p)
    return jax.jit(lambda c: jntt.coset_ntt(c, n, OFFSET, jf))


@FIELDS
@SIZES
@pytest.mark.parametrize("blowup", [4, 8, 16])
def test_coset_ntt_matches_jax(fld, log_n, blowup):
    """A coefficient vector of length n/blowup, never padded in the port,
    against the JAX package on the zero-padded vector."""
    n = 1 << log_n
    coeffs = _rand_mont(fld, n // blowup, seed=log_n * blowup)
    want = np.asarray(_jax_coset_ntt(n, fld.p)(jnp.asarray(_padded(coeffs, n))))
    got = tntt.coset_ntt(_t(coeffs), n, OFFSET, fld)
    np.testing.assert_array_equal(tfp.to_host(got), want)


@FIELDS
@SIZES
def test_short_vector_equals_zero_padded(fld, log_n):
    n = 1 << log_n
    for k in (n // 8, n // 8 + 3, 1, n - 1):
        coeffs = _rand_mont(fld, k, seed=k)
        short = tntt.coset_ntt(_t(coeffs), n, OFFSET, fld)
        padded = tntt.coset_ntt(_t(_padded(coeffs, n)), n, OFFSET, fld)
        np.testing.assert_array_equal(tfp.to_host(short), tfp.to_host(padded))


@FIELDS
@SIZES
def test_intt_matches_jax(fld, log_n):
    n = 1 << log_n
    jf = jfp.field_for(fld.p)
    x = _rand_mont(fld, n, seed=log_n + 1)
    jplan = jntt.inverse_plan(n, jf)
    want = np.asarray(jax.jit(lambda v: jntt.intt(v, jplan))(jnp.asarray(x)))
    got = tntt.intt(_t(x), tntt.inverse_plan(n, fld))
    np.testing.assert_array_equal(tfp.to_host(got), want)


@FIELDS
@SIZES
def test_coset_intt_matches_jax_and_inverts(fld, log_n):
    n = 1 << log_n
    jf = jfp.field_for(fld.p)
    coeffs = _rand_mont(fld, n // 8, seed=log_n + 2)
    evals = tntt.coset_ntt(_t(coeffs), n, OFFSET, fld)
    want = np.asarray(
        jax.jit(lambda v: jntt.coset_intt(v, OFFSET, jf))(jnp.asarray(tfp.to_host(evals)))
    )
    got = tfp.to_host(tntt.coset_intt(evals, OFFSET, fld))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _padded(coeffs, n))


@FIELDS
@pytest.mark.parametrize("inverse", [False, True], ids=["plain", "inverse_scale"])
@pytest.mark.parametrize("log_n", [14, 16])
def test_fourstep_matches_jax_fourstep(monkeypatch, fld, log_n, inverse):
    """The JAX four-step runs its Pallas column kernel in interpret mode, with
    `pltpu.roll` as `jnp.roll`, as tests/test_pallas_ntt.py runs it."""
    monkeypatch.setenv("ZKSTARK_PALLAS", "interpret")
    monkeypatch.setattr(jkernel, "_roll", jnp.roll)
    n = 1 << log_n
    jf = jfp.field_for(fld.p)
    plan = (tntt.inverse_plan if inverse else tntt.forward_plan)(n, fld)
    w = pow(plan.root, fld.p - 2, fld.p) if inverse else plan.root
    x = _rand_mont(fld, n, seed=log_n + inverse)
    want = np.asarray(
        jax.jit(lambda v: jkernel.ntt_fourstep(v, n, w, plan.scale_mont, jf))(jnp.asarray(x))
    )
    got = ntt_kernel.ntt_fourstep(_t(x), n, w, plan.scale_mont, fld)
    np.testing.assert_array_equal(tfp.to_host(got), want)


@FIELDS
@pytest.mark.parametrize("log_n", [10, 13])
def test_fourstep_below_its_threshold_equals_the_row_route(fld, log_n):
    """The glue, all fused options on, against one `ntt_rows` call."""
    n = 1 << log_n
    plan = tntt.inverse_plan(n, fld)
    w = pow(plan.root, fld.p - 2, fld.p)
    x = _t(_rand_mont(fld, n // 4, seed=log_n))
    geo = ntt_kernel.GeoScale
    want = ntt_kernel.ntt_rows(
        x.reshape(1, -1), w, fld, m=n, pre=geo(OFFSET, n), post=geo(7, n), scale=plan.scale_mont
    )
    got = ntt_kernel.ntt_fourstep(x, n, w, plan.scale_mont, fld, pre_offset=OFFSET, post_offset=7)
    np.testing.assert_array_equal(tfp.to_host(got), tfp.to_host(want)[0])


@FIELDS
@pytest.mark.parametrize("invert", [False, True], ids=["offset", "inverse"])
@pytest.mark.parametrize("log_n", [1, 10, 13, 16])
def test_geo_tables_factor_the_offset_powers(fld, log_n, invert):
    """A[j_hi]·B[j_lo] is offset^j in Montgomery form, for every j < n."""
    n = 1 << log_n
    jf = jfp.field_for(fld.p)
    base = pow(OFFSET, fld.p - 2, fld.p) if invert else OFFSET
    a, b, s = ntt_kernel._geo_tables_host(base, n, fld)
    assert a.shape[0] << s == n and b.shape[0] == 1 << s
    j = np.arange(n)
    got = tfp.mont_mul_f(fld, _t(a[j >> s]), _t(b[j & ((1 << s) - 1)]))
    want = jntt._offset_powers_mont(n, OFFSET, invert, jf)
    np.testing.assert_array_equal(tfp.to_host(got), want)
    # and as the plain twin gathers it, along rows and columns of a block
    geo = ntt_kernel.GeoScale(base, n, col_stride=n // 2, row_stride=1)
    block = ntt_kernel._geo_factor_plain(geo, n // 2, 2, fld, "cpu")
    np.testing.assert_array_equal(tfp.to_host(tfp.narrow(block)).T.reshape(n), want)


def test_device_tables_are_built_once():
    """U.T/V.T and the offset tables are cached per (n, w, field, device):
    a second transform of the same size uploads nothing."""
    n, fld = 1 << 14, tfp.FIELD101
    coeffs = _t(_rand_mont(fld, n // 8, seed=1))
    tntt.coset_ntt(coeffs, n, OFFSET, fld)
    uv, geo = ntt_kernel._device_uv.cache_info(), ntt_kernel._geo_tables.cache_info()
    for _ in range(3):
        tntt.coset_ntt(coeffs, n, OFFSET, fld)
    assert ntt_kernel._device_uv.cache_info().misses == uv.misses
    assert ntt_kernel._device_uv.cache_info().hits == uv.hits + 3
    assert ntt_kernel._geo_tables.cache_info().misses == geo.misses
    assert ntt_kernel._geo_tables.cache_info().hits >= geo.hits + 3
    n1, n2, ut, vt = ntt_kernel._device_uv(n, tntt.forward_plan(n, fld).root, None, fld,
                                           torch.device("cpu"))
    assert (n1, n2) == (128, 128) and ut.shape == (1, 128) and vt.shape == (128, 128)


@pytest.mark.parametrize("radices,m", [([2], 2), ([8, 2], 16), ([8, 8, 4], 256), ([8] * 4, 4096),
                                       ([8] * 4 + [2], 8192)])
def test_pass_table_layout(radices, m):
    """The kernel's pass table: m − 1 words, the pass at Ns at offset Ns − 1
    holding W^{r·q} at (r − 1)·Ns + q."""
    fld = tfp.FIELD101
    w = fld.subgroup_generator(m)
    assert ntt_kernel.pass_radices(m) == radices
    tw = ntt_kernel.pass_twiddles(m, w, fld)
    assert tw.shape == (m - 1,)
    ns = 1
    for radix in radices:
        root = pow(w, m // (radix * ns), fld.p)
        for r, q in ((1, 0), (radix - 1, ns - 1), (1, ns // 2)):
            assert int(tw[ns - 1 + (r - 1) * ns + q]) == fld.mont_scalar(pow(root, r * q, fld.p))
        ns *= radix
    assert ns == m


def test_transpose_twin_takes_a_missing_tail():
    x = _t(np.arange(1, 11, dtype=np.uint32))
    got = tfp.to_host(ntt_kernel.transpose(x, 3, 4))
    want = np.array([[1, 5, 9], [2, 6, 10], [3, 7, 0], [4, 8, 0]], np.uint32)
    np.testing.assert_array_equal(got, want)
    assert ntt_kernel.transpose_launches == 0  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        ntt_kernel.transpose(x, 3, 3)


def test_rows_wrapper_checks_the_fused_arguments():
    x = tfp.zeros((4, 8), "cpu")
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(x, 1, m=4)  # rows longer than the transform
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(x, 1, m=12)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(x, 1, pre=ntt_kernel.GeoScale(5, 16, col_stride=4))  # 28 ≥ 16
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(x, 1, uv=(tfp.zeros((3, 8), "cpu"), tfp.zeros((2, 8), "cpu")))


def test_prove_defaults_to_the_card():
    """Without a `device` the entry points take the card and raise here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove(STARK101, STARK101_SECRET)


def test_resumable_prover_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResumableProver(STARK101, STARK101_SECRET, str(tmp_path / "ckpt.npz")).run()
