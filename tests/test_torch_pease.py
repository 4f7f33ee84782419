"""The port's Pease route equals the JAX package's, exactly (tolerance 0).

  * `ntt_rows_pease_plain` in its bit-reversed mode on the transposed block
    equals the JAX Pallas kernel `_pease_cols_call` run in interpret mode (as
    tests/test_pallas_grid.py runs it), for m ∈ {2, 16, 256, 1024} and both
    primes: natural order in, bit-reversed order out;
  * `ntt_rows_pease_plain` takes the contract of `ntt_rows_plain` (``m=``,
    ``pre``, ``uv``, ``post``, ``scale``): equal to it word for word in
    natural order, and permuted in bit-reversed order;
  * `ntt_fourstep` with ZKSTARK_PEASE=on equals the JAX `ntt.ntt` / `ntt.intt`
    at 2^14 and 2^16, the JAX `ntt_fourstep` on its Pease route (interpret
    mode) with and without the coset offsets and the inverse scale, and the
    DIT route; it is the same five kernel calls as the DIT route, and the
    former plain-torch glue is gone;
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
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
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
    got = ntt_kernel.ntt_rows_pease_plain(_t(np.ascontiguousarray(x.T)), w, fld, bitrev=True)
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


def _options(fld, batch, m, seed):
    """Every fused option of the row contract for a (batch, m) block."""
    geo = ntt_kernel.GeoScale
    size = 1 << (2 * batch * m).bit_length()
    return {
        "pre": dict(pre=geo(5, m)),
        "pre_rows": dict(pre=geo(7, size, col_stride=batch, row_stride=1)),
        "uv": dict(uv=(_t(_rand_mont(fld, (batch // 2, m), seed)),
                       _t(_rand_mont(fld, (2, m), seed + 1)))),
        "post": dict(post=geo(11, size, col_stride=batch, row_stride=1)),
        "scale": dict(scale=fld.mont_scalar(pow(m, fld.p - 2, fld.p))),
    }


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
@pytest.mark.parametrize("option", ["short", "pre", "pre_rows", "uv", "post", "scale", "all"])
@pytest.mark.parametrize("m", [2, 8, 64, 512])
def test_pease_plain_contract_equals_dit(fld, m, option):
    """`ntt_rows_pease_plain` takes the contract of `ntt_rows_plain`: in
    natural order the same words with each option alone and all together;
    in bit-reversed order those words with their columns permuted, the U·V
    tables handed over permuted the same way."""
    batch = 6
    opts = _options(fld, batch, m, m)
    if option == "all":
        kw = {k: v for name in ("pre_rows", "uv", "post", "scale") for k, v in opts[name].items()}
    else:
        kw = opts.get(option, {})
    valid = max(1, m // 8 + 1) if option in ("short", "pre", "pre_rows", "all") else m
    x = _t(_rand_mont(fld, (batch, valid), m + 1))
    w = tntt.forward_plan(m, fld).root
    dit = tfp.to_host(ntt_kernel.ntt_rows_plain(x, w, fld, m=m, **kw))
    np.testing.assert_array_equal(tfp.to_host(ntt_kernel.ntt_rows_pease_plain(x, w, fld, m=m, **kw)),
                                  dit)
    br = bit_reverse_indices(m).astype(np.int64)
    if "uv" in kw:
        kw["uv"] = tuple(t[:, torch.from_numpy(br)].contiguous() for t in kw["uv"])
    got = ntt_kernel.ntt_rows_pease_plain(x, w, fld, m=m, bitrev=True, **kw)
    np.testing.assert_array_equal(tfp.to_host(got), dit[:, br])


@pytest.mark.parametrize("pre,post,inverse", [(None, None, False), (5, None, False),
                                              (None, 7, True), (3, 7, True)],
                         ids=["bare", "pre", "post_inverse", "all"])
@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_fourstep_pease_offsets_match_jax(monkeypatch, n, pre, post, inverse):
    """`ntt_fourstep` on the Pease route, with the coset offsets on load and
    on store and the inverse scale, against the JAX `ntt_fourstep` on its
    Pease route (the Pallas kernel in interpret mode) with the offsets as
    host powers around it, and against the port's DIT route; a short input
    where a pre-scale is on."""
    fld = tfp.FIELD101
    jf = jfp.field_for(fld.p)
    k = n // 8 if pre else n
    x = _rand_mont(fld, k, seed=n + 3 * bool(pre) + bool(post))
    w = tntt.forward_plan(n).root
    scale = fld.mont_scalar(pow(n, fld.p - 2, fld.p)) if inverse else None

    def powers(base):
        return jnp.asarray(fld.host_to_mont(fld.host_powers_pow2(base, n)))

    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    monkeypatch.setenv("ZKSTARK_PALLAS", "interpret")
    xj = jnp.asarray(np.concatenate([x, np.zeros(n - k, dtype=np.uint32)]))
    if pre:
        xj = jfp.mont_mul_f(jf, xj, powers(pre))
    want = jkernel.ntt_fourstep(xj, n, w, scale, jf)
    if post:
        want = jfp.mont_mul_f(jf, want, powers(post))
    got = ntt_kernel.ntt_fourstep(_t(x), n, w, scale, fld, pre_offset=pre, post_offset=post)
    np.testing.assert_array_equal(tfp.to_host(got), np.asarray(want))
    monkeypatch.setenv("ZKSTARK_PEASE", "off")
    dit = ntt_kernel.ntt_fourstep(_t(x), n, w, scale, fld, pre_offset=pre, post_offset=post)
    np.testing.assert_array_equal(tfp.to_host(got), tfp.to_host(dit))


def test_pease_route_is_the_five_kernel_calls(pease_on, monkeypatch):
    """The Pease four-step is the same five calls as the DIT route (three
    transposes, two Pease row calls, nothing between them) and its former
    plain-torch glue is gone from the module."""
    for gone in ("_fourstep_pease", "_transpose", "_transpose_gather", "_apply_twiddle_t",
                 "_pease_fourstep_constants"):
        assert not hasattr(ntt_kernel, gone), gone
    calls = []
    for name in ("transpose", "ntt_rows", "ntt_rows_pease"):
        real = getattr(ntt_kernel, name)
        monkeypatch.setattr(ntt_kernel, name,
                            lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw))
    n = 1 << 14
    x = _t(_rand_mont(tfp.FIELD101, (3, n // 8), seed=9))
    tntt.coset_ntt(x, n, 5)
    assert calls == ["transpose", "ntt_rows_pease", "transpose", "ntt_rows_pease", "transpose"]
