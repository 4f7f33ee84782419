"""A batch of four-step transforms in the same five launches equals the JAX
package's batched transform, exactly (tolerance 0: no floats anywhere).

  * `transpose_plain` on B stacked matrices, each with a missing tail, with
    block elements and with bit-reversed output rows, against one matrix at
    a time and against numpy;
  * `ntt_rows_plain`, `ntt_rows_pease_plain` and `limb_dft_rows_plain` with
    ``period=`` against B separate calls, every fused option on;
  * batched `coset_ntt`, `intt` and `coset_intt` at 2^14 and 2^16 with
    B ∈ {1, 3, 4} distinct random rows, on both row routes, against the JAX
    package's batched `ntt` / `intt` / `coset_ntt` / `coset_intt` (its
    radix-2 stages over the leading axis), and one `ntt_fourstep` call a
    batch;
  * `prove_batch` of the 2^16 square-chain statement with the secrets s and
    p − s alternating (their witnesses differ in row 0 and share the public
    output) equals each secret's solo `prove`.

Everything on the CPU, where the kernel wrappers run their plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkstark_tpu.ntt.core as jntt
from zkstark_tpu_torch import ntt as tntt
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
from zkstark_tpu_torch.ops import limb_dft, ntt_kernel

FIELDS = [tfp.FIELD101, tfp.FIELD_ALT]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run starts six test workers, and torch
    ops on 2^16-word tensors, each spread over every core, then oversubscribe
    the machine (the 2^16 batch proof took 30 times its serial time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return tfp.from_host(np.asarray(a), "cpu")


def _rand_mont(fld, shape, seed):
    rng = np.random.default_rng(seed)
    return fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64))


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize(
    "batch,rows,cols,elem,missing,brev",
    [(3, 7, 16, 1, 13, True), (4, 33, 8, 1, 0, False), (2, 8, 4, 4, 9, False),
     (5, 16, 2, 2, 0, False), (1, 5, 32, 1, 40, True)],
)
def test_transpose_plain_batched(batch, rows, cols, elem, missing, brev):
    valid = rows * cols * elem - missing
    x = _u32((batch, valid), batch + rows)
    got = tfp.to_host(ntt_kernel.transpose_plain(_t(x), rows, cols, elem, brev=brev))
    assert got.shape == (batch * cols, rows * elem)
    br = bit_reverse_indices(cols) if brev else np.arange(cols)
    for b in range(batch):
        full = np.concatenate([x[b], np.zeros(missing, dtype=np.uint32)])
        want = full.reshape(rows, cols, elem).transpose(1, 0, 2)[br].reshape(cols, rows * elem)
        np.testing.assert_array_equal(got[b * cols : (b + 1) * cols], want)
        one = ntt_kernel.transpose(_t(x[b]), rows, cols, elem, brev=brev)
        np.testing.assert_array_equal(tfp.to_host(one), want)


def test_transpose_rejects_bad_batches():
    with pytest.raises(ValueError):
        ntt_kernel.transpose(tfp.zeros((2, 2, 4), "cpu"), 2, 4)
    with pytest.raises(ValueError):
        ntt_kernel.transpose(tfp.zeros((2, 9), "cpu"), 2, 4)
    with pytest.raises(ValueError):
        ntt_kernel.transpose(tfp.zeros((2, 12), "cpu"), 2, 6, brev=True)
    with pytest.raises(ValueError):
        ntt_kernel.transpose(tfp.zeros((2, 16), "cpu"), 2, 4, elem=2, brev=True)


def _row_kernels():
    return {
        "ntt_rows": (ntt_kernel.ntt_rows_plain, {}),
        "pease": (ntt_kernel.ntt_rows_pease_plain, {}),
        "pease_bitrev": (ntt_kernel.ntt_rows_pease_plain, {"bitrev": True}),
        "limb": (limb_dft.limb_dft_rows_plain, {}),
    }


@pytest.mark.parametrize("fld", FIELDS, ids=["p101", "alt"])
@pytest.mark.parametrize("kernel,m", [("ntt_rows", 2), ("ntt_rows", 64), ("pease", 4),
                                      ("pease", 256), ("pease_bitrev", 128), ("limb", 128),
                                      ("limb", 512)])
def test_period_equals_separate_calls(fld, kernel, m):
    """B transforms of `period` rows in one call take the factors of one
    transform: the same words as B calls of `period` rows each."""
    plain, extra = _row_kernels()[kernel]
    period, copies = 4, 3
    geo = ntt_kernel.GeoScale
    size = 1 << (2 * period * m).bit_length()
    kw = dict(pre=geo(7, size, col_stride=period, row_stride=1),
              uv=(_t(_rand_mont(fld, (period // 2, m), 1)), _t(_rand_mont(fld, (2, m), 2))),
              post=geo(11, size, col_stride=period, row_stride=1), scale=fld.mont_scalar(3),
              **extra)
    x = _rand_mont(fld, (copies * period, max(1, m // 4)), m)
    w = tntt.forward_plan(m, fld).root
    got = tfp.to_host(plain(_t(x), w, fld, m=m, period=period, **kw))
    for c in range(copies):
        one = plain(_t(x[c * period : (c + 1) * period]), w, fld, m=m, **kw)
        np.testing.assert_array_equal(got[c * period : (c + 1) * period], tfp.to_host(one))


def test_period_is_checked():
    x = tfp.zeros((6, 8), "cpu")
    for period in (4, 3, 0):
        with pytest.raises(ValueError, match="period"):
            ntt_kernel.ntt_rows(x, 1, period=period)
    with pytest.raises(ValueError, match="cover"):  # U.T, V.T must cover one period
        ntt_kernel.ntt_rows(x, 1, period=2, uv=(tfp.zeros((2, 8), "cpu"), tfp.zeros((2, 8), "cpu")))


@pytest.fixture(params=["off", "on"], ids=["dit", "pease"])
def route(request, monkeypatch):
    monkeypatch.setenv("ZKSTARK_PEASE", request.param)
    return request.param


@functools.lru_cache(maxsize=None)
def _jax_batch(log_n: int):
    """Four distinct random rows of coefficients and of evaluations at 2^log_n,
    and the JAX package's batched transforms of them (jitted once a size;
    a test of B rows reads the first B)."""
    fld, n = tfp.FIELD101, 1 << log_n
    coeffs = _rand_mont(fld, (4, n // 8), log_n)
    evals = _rand_mont(fld, (4, n), 7 * log_n)
    fns = {
        "coset_ntt": (lambda v: jntt.coset_ntt(v, n, 5), coeffs),
        "ntt": (lambda v: jntt.ntt(v, jntt.forward_plan(n)), evals),
        "intt": (lambda v: jntt.intt(v, jntt.inverse_plan(n)), evals),
        "coset_intt": (lambda v: jntt.coset_intt(v, 5), evals),
    }
    want = {k: np.asarray(jax.jit(fn)(jnp.asarray(x))) for k, (fn, x) in fns.items()}
    return coeffs, evals, want


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("log_n", [14, 16])
def test_batched_lde_matches_jax(route, monkeypatch, log_n, batch):
    """Distinct rows through `coset_ntt`, `intt` and `coset_intt`, each one
    `ntt_fourstep` call for the whole batch, against the JAX package's
    batched transforms (its radix-2 stages over the leading axis)."""
    n = 1 << log_n
    coeffs, evals, want = _jax_batch(log_n)
    coeffs, evals = coeffs[:batch], evals[:batch]
    calls = []
    real = ntt_kernel.ntt_fourstep

    def counted(x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(ntt_kernel, "ntt_fourstep", counted)
    got = {
        "coset_ntt": tntt.coset_ntt(_t(coeffs), n, 5),
        "ntt": tntt.ntt(_t(evals), tntt.forward_plan(n)),
        "intt": tntt.intt(_t(evals), tntt.inverse_plan(n)),
        "coset_intt": tntt.coset_intt(_t(evals), 5),
    }
    assert calls == [(batch, n // 8)] + [(batch, n)] * 3  # one call a batch
    for name in got:
        assert got[name].shape == (batch, n)
        np.testing.assert_array_equal(tfp.to_host(got[name]), want[name][:batch], err_msg=name)


def test_batched_fourstep_rows_differ():
    """A batch stride fault would copy one row's transform to another: the
    rows of the batch differ and each equals its own solo transform."""
    fld, n = tfp.FIELD_ALT, 1 << 14
    x = _rand_mont(fld, (3, n), 11)
    w = tntt.forward_plan(n, fld).root
    got = tfp.to_host(ntt_kernel.ntt_fourstep(_t(x), n, w, field=fld, pre_offset=3, post_offset=7))
    assert len({row.tobytes() for row in got}) == 3
    for b in range(3):
        one = ntt_kernel.ntt_fourstep(_t(x[b]), n, w, field=fld, pre_offset=3, post_offset=7)
        np.testing.assert_array_equal(got[b], tfp.to_host(one))


def test_prove_batch_distinct_witnesses():
    """prove_batch at 2^16 points (a four-step LDE) with s and p − s
    alternating: each proof equals its secret's solo proof, and the two
    secrets' proofs differ."""
    from zkstark_tpu_torch.protocol import prove
    from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN
    from zkstark_tpu_torch.protocol.batch import prove_batch
    from zkstark_tpu_torch.protocol.config import StarkConfig

    s = 271828
    trace_len = (1 << 13) - 1
    cfg = StarkConfig(trace_len=trace_len, boundary_last=int(SQUARE_CHAIN.trace(trace_len, s)[-1]),
                      air=SQUARE_CHAIN)
    secrets = [s, tfp.P - s, s, tfp.P - s]
    solo = {k: prove(cfg, k, device="cpu") for k in (s, tfp.P - s)}
    assert solo[s] != solo[tfp.P - s]
    assert prove_batch(cfg, secrets, device="cpu") == [solo[k] for k in secrets]
