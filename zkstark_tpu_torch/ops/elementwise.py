"""Two elementwise passes of the prove path on Hopper: `from_mont`
(``csrc/from_mont.cu``) and the interpolation's `endpoint_fix`
(``csrc/endpoint_fix.cu``).

On the TPU, XLA fused both into the program around them; as plain tensor ops
each is a chain of launches over int64 temporaries of the whole vector.

  * `from_mont` — ``zkstark_tpu/field/fp.py`` ``from_mont_f`` as the JAX
    package applies it to the LDE's output before the trace commit
    (``zkstark_tpu/parallel/pipeline.py:64``,
    ``zkstark_tpu/protocol/fused.py:107``): one REDC a uint32 word, bound by
    bytes (4 read, 4 written).
  * `endpoint_fix` — the rank-1 correction of
    ``zkstark_tpu/protocol/air.py:423-440`` ``interpolate_trace``: after the
    size-n INTT of a trace of n − 1 points (the missing point taken as 0),
    c[b, j] = c0[b, j] + v[j]·a_b with a_b = −c0[b, n−1]/v[n−1] and
    v[j] = n⁻¹·g^j, so that coefficient n − 1 vanishes. The kernel computes
    the same words as c0[b, j] − g^j·(c0[b, n−1]·g), with g^j from the two
    small tables of a `ntt_kernel.GeoScale`: no table of n words. One launch
    for the batch at every n; bound by bytes.

On a CPU tensor each wrapper runs its plain-torch twin (the JAX package's
form, same arguments), on a CUDA tensor only the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build, ntt_kernel

from_mont_launches = 0  # launches of from_mont_kernel, counted by from_mont
endpoint_launches = 0  # launches of endpoint_fix_kernel, counted by endpoint_fix


def from_mont_plain(x: torch.Tensor, field: Field = FIELD101) -> torch.Tensor:
    """Plain-torch twin of `from_mont`: ``fp.from_mont_f``."""
    return fp.from_mont_f(field, x)


def from_mont(x: torch.Tensor, field: Field = FIELD101, out: torch.Tensor | None = None):
    """Montgomery form → standard residues, word by word, of a uint32 tensor
    of any shape, written into `out` where given (a tree's values, at the head
    of its one allocation: `hash.merkle.tree_values`), else a new tensor."""
    global from_mont_launches
    if x.dtype != torch.uint32:
        raise TypeError(f"from_mont: needs torch.uint32, got {x.dtype}")
    out = _build.out_tensor(out, tuple(x.shape), x, "from_mont")
    if x.device.type == "cpu":
        return out.copy_(from_mont_plain(x, field))
    _build.require(x, "from_mont", x.dim())
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.kernels().zk_from_mont(
                x.data_ptr(), out.data_ptr(), x.numel(), field.p, field.p_inv_neg,
                _build.stream(x),
            )
        _build.check(rc, "from_mont")
        from_mont_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def endpoint_basis(n: int, field: Field = FIELD101):
    """v = INTT(e_{n-1}), v[j] = n^{-1}·g^{-(n-1)j}, in Montgomery form, and
    the Montgomery form of 1/v[n-1] (host numpy): the plain twin's tables."""
    p = field.p
    g = field.subgroup_generator(n)
    g_inv = pow(g, p - 2, p)
    n_inv = pow(n, p - 2, p)
    base = pow(g_inv, n - 1, p)
    v = (field.host_powers_pow2(base, n).astype(np.uint64) * n_inv % p).astype(np.uint32)
    v_last_inv = pow(int(v[n - 1]), p - 2, p)
    return field.host_to_mont(v), field.mont_scalar(v_last_inv)


def endpoint_fix_plain(c0: torch.Tensor, field: Field = FIELD101) -> torch.Tensor:
    """Plain-torch twin of `endpoint_fix`: the JAX package's form, with the
    length-n vector v."""
    n = c0.shape[-1]
    v, v_last_inv = endpoint_basis(n, field)
    v = fp.from_host(v, c0.device)
    # choose the free endpoint a_{n-1} so that coefficient n−1 vanishes:
    #   c0[n−1] + a_{n-1}·v[n−1] = 0
    a_last = fp.mont_mul_f(field, fp.neg_f(field, c0[..., n - 1 :]), v_last_inv)
    return fp.add_f(field, c0, fp.mont_mul_f(field, v, a_last))


def endpoint_fix(c0: torch.Tensor, field: Field = FIELD101) -> torch.Tensor:
    """c0 (…, n) uint32 Montgomery, the INTT of traces of n − 1 points with
    the last taken as 0, n a power of two ≥ 2, the leading axes independent
    traces → the coefficients with coefficient n − 1 made 0 (a new tensor)."""
    global endpoint_launches
    n = c0.shape[-1] if c0.dim() else 0
    if c0.dtype != torch.uint32 or n < 2 or n & (n - 1):
        raise ValueError(f"endpoint_fix: needs a (…, n) uint32 tensor, n a power of two ≥ 2, "
                         f"got {c0.dtype} {tuple(c0.shape)}")
    if c0.device.type == "cpu":
        return endpoint_fix_plain(c0, field)
    _build.require(c0, "endpoint_fix", c0.dim())
    batch = c0.numel() // n
    if batch > 65535:
        raise ValueError(f"endpoint_fix: {batch} rows in one call (at most 65535)")
    out = torch.empty_like(c0)
    if batch:
        g = field.subgroup_generator(n)
        ga, gb, shift = ntt_kernel._geo_tables(g, n, field, c0.device)
        with torch.cuda.device(c0.device):
            rc = _build.kernels().zk_endpoint_fix(
                c0.data_ptr(), out.data_ptr(), ga.data_ptr(), gb.data_ptr(), shift,
                field.mont_scalar(g), batch, n, field.p, field.p_inv_neg, _build.stream(c0),
            )
        _build.check(rc, "endpoint_fix")
        endpoint_launches += 1
    return out
