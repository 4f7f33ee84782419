"""NTT/INTT over F_p — counterpart of ``zkstark_tpu/ntt/core.py``.

Montgomery-form uint32 tensors, natural order in and out. The route depends
only on the size n, never on the device:

  * n < `ops.ntt_kernel.MIN_FOURSTEP` (2^14): one `ntt_rows` call, batch =
    the product of the leading axes;
  * larger n: the four-step factorization (`ops.ntt_kernel.ntt_fourstep`),
    whose two passes of row transforms are `ntt_rows` calls as well (past
    2^26, where a factor exceeds the longest `ntt_rows` row, and under
    ``ZKSTARK_MXU=on``: `limb_dft.limb_dft_rows`; under ``ZKSTARK_PEASE=on``:
    `ntt_rows_pease`; sizes above 2^28 raise); the leading axes are one batch
    of the same five launches, whatever their size.

Evaluation on the coset offset·⟨h⟩ (prover.rs:69) is a pointwise pre-scale by
offset^j followed by a plain NTT. The pre-scale, the zero tail of a short
coefficient vector, an INTT's 1/n and the inverse coset scale are all handed
to `ntt_rows`, which applies them on load or on store: on a CUDA tensor
`ntt`, `intt`, `coset_ntt` and `coset_intt` launch hand-written kernels only
(csrc/ntt.cu, csrc/transpose.cu, csrc/limb_dft.cu, csrc/ntt_pease.cu), on a
CPU tensor the kernels' plain-torch twins, so the CPU tests run the same glue.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field

def bit_reverse_indices(n: int) -> np.ndarray:
    """perm[i] = bit-reverse of i in log2(n) bits."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass(frozen=True)
class NttPlan:
    """A size-n transform with root ω of exact order n. The stage twiddles
    are built on demand by the row transform that uses them
    (`ops.ntt_kernel.stage_twiddles`), so no table depends on the route."""

    n: int
    root: int  # standard-form n-th root of unity
    field: Field
    scale_mont: int | None  # Montgomery-form n^{-1} for inverse transforms


@functools.lru_cache(maxsize=None)
def make_plan(n: int, root: int, inverse: bool = False, field: Field = FIELD101):
    p = field.p
    assert n & (n - 1) == 0 and n >= 2, "NTT size must be a power of two ≥ 2"
    assert pow(root, n, p) == 1 and pow(root, n // 2, p) != 1, (
        "root must have exact order n"
    )
    scale = field.mont_scalar(pow(n, p - 2, p)) if inverse else None
    return NttPlan(n=n, root=root, field=field, scale_mont=scale)


def forward_plan(n: int, field: Field = FIELD101) -> NttPlan:
    """Evaluation at ⟨h⟩ in natural order, h = g^((p-1)/n) (prover.rs:48-57)."""
    return make_plan(n, field.subgroup_generator(n), inverse=False, field=field)


def inverse_plan(n: int, field: Field = FIELD101) -> NttPlan:
    return make_plan(n, field.subgroup_generator(n), inverse=True, field=field)


def _effective_root(plan: NttPlan) -> int:
    """The root the plan transforms with (inverted for INTT plans)."""
    p = plan.field.p
    return pow(plan.root, p - 2, p) if plan.scale_mont is not None else plan.root


def _transform(x: torch.Tensor, plan: NttPlan, scaled: bool, pre=None, post=None):
    """The size-n transform of `plan` along the last axis of x, whose last
    axis may be shorter than n (the tail taken as zero): input j times
    pre^j, output k times post^k (standard-form residues) and, if `scaled`,
    times the plan's n^{-1}."""
    from zkstark_tpu_torch.ops import ntt_kernel

    n, field = plan.n, plan.field
    w = _effective_root(plan)
    scale = plan.scale_mont if scaled else None
    rows = fp.as_u32(fp.as_i32(x).reshape(-1, x.shape[-1]).contiguous())
    if n >= ntt_kernel.MIN_FOURSTEP:  # the whole batch in one four-step
        out = ntt_kernel.ntt_fourstep(rows, n, w, scale, field, pre_offset=pre, post_offset=post)
    else:
        geo = ntt_kernel.GeoScale
        out = ntt_kernel.ntt_rows(
            rows,
            w,
            field,
            m=n,
            pre=None if pre is None else geo(pre, n),
            post=None if post is None else geo(post, n),
            scale=scale,
        )
    return out.reshape(x.shape[:-1] + (n,))


def ntt(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """X[k] = Σ_j x[j]·ω^{jk} along the last axis; leading axes are
    independent transforms."""
    assert x.shape[-1] == plan.n
    return _transform(x, plan, scaled=False)


def intt(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """x[j] = n^{-1}·Σ_k X[k]·ω^{-jk}; the plan must be an inverse plan. The
    last axis of x may be shorter than n: the missing tail is taken as zero
    and is neither allocated nor read. The 1/n is applied by the row kernel
    on store (below the four-step size) or folded into the four-step twiddle
    table."""
    assert plan.scale_mont is not None, "intt needs a plan built with inverse=True"
    assert 1 <= x.shape[-1] <= plan.n
    return _transform(x, plan, scaled=True)


def coset_ntt(coeffs: torch.Tensor, n: int, offset: int, field: Field = FIELD101):
    """Evaluate the polynomial with `coeffs` (length ≤ n, Montgomery form) on
    the coset {offset·h^i} in natural order (prover.rs:69-70). The zero tail
    of the coefficients is neither allocated nor read."""
    return _transform(coeffs, forward_plan(n, field), scaled=False, pre=offset % field.p)


def coset_intt(evals: torch.Tensor, offset: int, field: Field = FIELD101):
    """Inverse of coset_ntt: coefficients from coset evaluations."""
    plan = inverse_plan(evals.shape[-1], field)
    return _transform(evals, plan, scaled=True, post=pow(offset, field.p - 2, field.p))
