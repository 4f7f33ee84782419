"""The interpolation's endpoint fix and `from_mont` of the port
(``ops/elementwise.py``, whose plain twins run on CPU tensors beside the CUDA
kernels ``csrc/endpoint_fix.cu`` and ``csrc/from_mont.cu``) equal the JAX
package word for word (tolerance 0: no floats), on inputs made from a seed
with numpy:

  * `air.interpolate_trace` — now the INTT of the n − 1 trace points as a
    short valid prefix (no padded copy) followed by `endpoint_fix` — against
    ``zkstark_tpu.protocol.air.interpolate_trace`` at n ∈ {16, 1024, 2^14}
    (2^14 takes the four-step route), both primes, one trace and a batch of
    three; coefficient n − 1 is 0;
  * `endpoint_fix` equals the fix written out with exact integers, whose
    factor is the closed form the kernel uses, −c0[n−1]·g^(j+1);
  * `from_mont` against ``zkstark_tpu.field.fp.from_mont_f`` on edge residues
    (0, 1, p − 1, R mod p, words above p) and random words, both primes;
  * the wrappers refuse what the kernels do not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.protocol import air as jair
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import elementwise
from zkstark_tpu_torch.protocol import air as tair

FIELDS = pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])


@FIELDS
@pytest.mark.parametrize("log_n", [4, 10, 14])
@pytest.mark.parametrize("batch", [0, 3], ids=["one", "B3"])
def test_interpolate_trace_matches_jax(p, log_n, batch):
    n = 1 << log_n
    jf, tf = jfp.field_for(p), tfp.field_for(p)
    rng = np.random.default_rng(log_n + batch)
    shape = (batch, n - 1) if batch else (n - 1,)
    trace = rng.integers(0, p, shape, dtype=np.uint64).astype(np.uint32)
    trace.reshape(-1)[:3] = (0, 1, p - 1)
    tm = tf.host_to_mont(trace)
    want = np.asarray(jax.jit(lambda t: jair.interpolate_trace(t, n, jf))(jnp.asarray(tm)))
    got = tfp.to_host(tair.interpolate_trace(tfp.from_host(tm, "cpu"), n, tf))
    np.testing.assert_array_equal(got, want)
    assert not got[..., n - 1].any()  # the free endpoint makes the degree ≤ n − 2


@FIELDS
@pytest.mark.parametrize("n", [2, 16, 256])
def test_endpoint_fix_is_the_closed_form(p, n):
    fld = tfp.field_for(p)
    rng = np.random.default_rng(n)
    c0 = rng.integers(0, p, (2, n), dtype=np.uint64)
    got = tfp.to_host(elementwise.endpoint_fix(tfp.from_host(fld.host_to_mont(c0), "cpu"), fld))
    g = fld.subgroup_generator(n)
    want = [[(int(c0[b, j]) - int(c0[b, n - 1]) * pow(g, j + 1, p)) % p for j in range(n)]
            for b in range(2)]
    back = tfp.to_host(tfp.from_mont_f(fld, tfp.from_host(got, "cpu")))
    np.testing.assert_array_equal(back, np.asarray(want, dtype=np.uint32))


@FIELDS
def test_from_mont_matches_jax(p):
    jf, tf = jfp.field_for(p), tfp.field_for(p)
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, p - 1, tf.r_mod_p, p, p + 1, (1 << 32) - 1], dtype=np.uint64)
    words = np.concatenate([edge, rng.integers(0, 1 << 32, 4093, dtype=np.uint64)])
    words = words.astype(np.uint32)
    want = np.asarray(jfp.from_mont_f(jf, jnp.asarray(words)))
    for shape in ((words.size,), (4, words.size // 4)):
        x = tfp.from_host(words.reshape(shape), "cpu")
        got = elementwise.from_mont(x, tf)
        assert got.shape == x.shape and got.dtype == torch.uint32
        np.testing.assert_array_equal(tfp.to_host(got).reshape(-1), want)
    # R mod p is the Montgomery form of 1
    assert int(tfp.to_host(elementwise.from_mont(tfp.from_host(edge[3:4].astype(np.uint32),
                                                                 "cpu"), tf))[0]) == 1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = tfp.from_host(np.arange(12, dtype=np.uint32), "cpu")
    with pytest.raises(ValueError):
        elementwise.endpoint_fix(x)  # 12 is not a power of two
    with pytest.raises(ValueError):
        elementwise.endpoint_fix(x[:1])
    with pytest.raises(ValueError):
        elementwise.endpoint_fix(x.view(torch.int32)[:8])
    with pytest.raises(TypeError):
        elementwise.from_mont(x.view(torch.int32))
