"""The port's Pease route equals the JAX package's, exactly (tolerance 0).

  * `ntt_rows_pease_plain` on the transposed block equals the JAX Pallas
    kernel `_pease_cols_call` run in interpret mode (as
    tests/test_pallas_grid.py runs it), for m ∈ {2, 16, 256, 1024} and both
    primes: natural order in, bit-reversed order out;
  * `ntt_fourstep` with ZKSTARK_PEASE=on equals the JAX `ntt.ntt` / `ntt.intt`
    at 2^14 and 2^16, and the DIT route at small n;
  * `ntt_rows_pease` takes its plain twin on a CPU tensor and counts no
    launch.

A whole proof on the Pease route is in tests/test_torch_prove_vs_jax.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkstark_tpu.ntt.core as jntt
from zkstark_tpu.field import fp as jfp
from zkstark_tpu.ops import ntt_kernel as jkernel
from zkstark_tpu_torch import ntt as tntt
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import ntt_kernel

FIELDS = [tfp.FIELD101, tfp.FIELD_ALT]


def _t(a):
    return tfp.from_host(np.asarray(a), "cpu")


def _rand_mont(fld, shape, seed):
    rng = np.random.default_rng(seed)
    return fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64))


@pytest.fixture
def pease_on(monkeypatch):
    monkeypatch.setenv("ZKSTARK_PEASE", "on")


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
@pytest.mark.parametrize("m", [2, 16, 256, 1024])
def test_pease_rows_match_jax_kernel(fld, m):
    jf = jfp.field_for(fld.p)
    w = fld.subgroup_generator(m)
    x = _rand_mont(fld, (m, 128), seed=m)  # the TPU kernel's column block
    want = jkernel._pease_cols_call(
        jnp.asarray(x), jnp.asarray(jkernel._pease_twiddle_table(m, w, jf)), True, jf
    )
    got = ntt_kernel.ntt_rows_pease_plain(
        _t(np.ascontiguousarray(x.T)), ntt_kernel.pease_twiddles(m, w, fld), fld
    )
    np.testing.assert_array_equal(tfp.to_host(got).T, np.asarray(want))


def test_pease_table_is_one_row_of_powers():
    """W_t[i] = tw[(i >> t) << t] reproduces every column of the TPU table."""
    m, fld = 64, tfp.FIELD101
    w = fld.subgroup_generator(m)
    tw = ntt_kernel.pease_twiddles(m, w, fld)
    table = jkernel._pease_twiddle_table(m, w)
    i = np.arange(m // 2)
    for t in range(m.bit_length() - 1):
        np.testing.assert_array_equal(tw[(i >> t) << t], table[:, t])


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_fourstep_pease_matches_jax(pease_on, n, inverse):
    fld = tfp.FIELD101
    x = _rand_mont(fld, n, seed=n + inverse)
    jplan = (jntt.inverse_plan if inverse else jntt.forward_plan)(n)
    want = np.asarray(
        jax.jit(lambda v: (jntt.intt if inverse else jntt.ntt)(v, jplan))(jnp.asarray(x))
    )
    before = ntt_kernel.pease_launches
    tplan = (tntt.inverse_plan if inverse else tntt.forward_plan)(n)
    got = (tntt.intt if inverse else tntt.ntt)(_t(x), tplan)
    np.testing.assert_array_equal(tfp.to_host(got), want)
    assert ntt_kernel.pease_launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
def test_fourstep_routes_agree_at_small_n(monkeypatch, fld):
    """Both routes of the glue give the same transform from n = 4 up; the
    route is read at each call, not cached with the constants."""
    for n in (4, 32, 1 << 9):
        x = _t(_rand_mont(fld, n, seed=n))
        w = tntt.forward_plan(n, fld).root
        scale = fld.mont_scalar(pow(n, fld.p - 2, fld.p))
        for s in (None, scale):
            monkeypatch.delenv("ZKSTARK_PEASE", raising=False)
            dit = ntt_kernel.ntt_fourstep(x, n, w, s, fld)
            monkeypatch.setenv("ZKSTARK_PEASE", "on")
            pease = ntt_kernel.ntt_fourstep(x, n, w, s, fld)
            np.testing.assert_array_equal(tfp.to_host(pease), tfp.to_host(dit))


def test_pease_enabled_reads_the_jax_switch(monkeypatch):
    monkeypatch.delenv("ZKSTARK_PEASE", raising=False)
    assert not ntt_kernel.pease_enabled() and not jkernel.pease_enabled()
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    assert ntt_kernel.pease_enabled() and jkernel.pease_enabled()


def test_pease_wrapper_checks_input():
    with pytest.raises(TypeError):
        ntt_kernel.ntt_rows_pease(torch.zeros((1, 8), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows_pease(tfp.zeros((1, 12), "cpu"), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows_pease(tfp.zeros((1, 16384), "cpu"), 1)
