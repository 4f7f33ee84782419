"""The port's FRI fold equals the JAX package's, exactly.

`folded` and `res` of `zkstark_tpu_torch.protocol.prover.fri_fold_eval`
(through `ops.fri_fold`, whose plain version runs on CPU tensors and repeats
the arithmetic of the CUDA kernel ``csrc/fri_fold.cu``) against
`zkstark_tpu.protocol.prover.fri_fold_eval`, at several layers, for B in
{1, 3}, on seeded inputs with 0, 1 and p − 1 among them, over both primes,
with beta as a host scalar and as a device tensor. The Merkle levels must be
the levels of `res`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.hash import merkle as jmerkle
from zkstark_tpu.protocol import air as jair
from zkstark_tpu.protocol import prover as jpr
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.hash import merkle as tmerkle
from zkstark_tpu_torch.ops import fri_fold
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol.config import StarkConfig

TRACE_LEN = 63  # a 512-point domain, 6 FRI rounds


def _configs(p):
    if p == tfp.P:
        return JaxConfig(trace_len=TRACE_LEN), StarkConfig(trace_len=TRACE_LEN)
    kw = dict(trace_len=TRACE_LEN, boundary_first=1, boundary_last=1, coset_offset=31)
    return (JaxConfig(field=jfp.field_for(p), air=jair.SQUARE_CHAIN, **kw),
            StarkConfig(field=tfp.field_for(p), air=tair.SQUARE_CHAIN, **kw))


def _inputs(cfg, layer, bsz, seed):
    p = cfg.field.p
    m = cfg.eval_domain >> layer
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, p, (bsz, m), dtype=np.uint64).astype(np.uint32)
    vals[0, :3] = (0, 1, p - 1)
    vals[-1, m // 2 :] = p - 1
    vals[-1, 0] = p - 1
    beta = rng.integers(0, p, bsz, dtype=np.uint64).astype(np.uint32)
    beta[0] = p - 1
    return vals, beta


def _t(a):
    return tfp.from_host(np.asarray(a, dtype=np.uint32), "cpu")


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(tfp.to_host(got), want)


@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("layer", [0, 1, 3, 5])
def test_fold_matches_jax_b1(p, layer):
    jcfg, cfg = _configs(p)
    vals, beta = _inputs(cfg, layer, 1, 10 * layer + 1)
    want = jpr.fri_fold_eval(jcfg, layer, jnp.asarray(vals[0]), jnp.uint32(beta[0]))
    got = tpr.fri_fold_eval(cfg, layer, _t(vals[0]), int(beta[0]))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        _eq(g, w)
    # beta read from a device tensor, as the fused core passes it
    again = tpr.fri_fold_eval(cfg, layer, _t(vals[0]), _t(beta[:1]))
    _eq(again[0], want[0])
    _eq(again[1], want[1])


@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("layer", [0, 2, 5])
def test_fold_matches_jax_b3(p, layer):
    jcfg, cfg = _configs(p)
    vals, beta = _inputs(cfg, layer, 3, 10 * layer + 3)
    want = jpr.fri_fold_eval(jcfg, layer, jnp.asarray(vals), jnp.asarray(beta)[:, None],
                             build=jmerkle.build_levels_batch)
    got = tpr.fri_fold_eval(cfg, layer, _t(vals), _t(beta), build=tmerkle.build_levels_batch)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _eq(g, w)


def test_last_fold_to_two_words():
    """m = 2: the smallest layer the wrapper takes, against exact integers."""
    fld = tfp.FIELD101
    p = fld.p
    a, b, beta, x = p - 1, 12345, p - 2, 5
    evals = _t(fld.host_to_mont(np.array([a, b], dtype=np.uint64)))
    folded, res = fri_fold.fri_fold(evals, fld.mont_scalar(beta), 1, pow(x, p - 2, p), fld)
    inv2 = (p + 1) // 2
    want = ((a + b) * inv2 + beta * (a - b) * inv2 * pow(x, p - 2, p)) % p
    assert int(tfp.to_host(res)[0]) == want
    assert int(tfp.to_host(folded)[0]) == fld.mont_scalar(want)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        fri_fold.fri_fold(_t(np.zeros(12)), 1, 1, 1)
    with pytest.raises(ValueError):
        fri_fold.fri_fold(_t(np.zeros((2, 8))), _t(np.zeros(3)), 1, 1)
    with pytest.raises(TypeError):
        fri_fold.fri_fold(torch.zeros(8, dtype=torch.int32), 1, 1, 1)
