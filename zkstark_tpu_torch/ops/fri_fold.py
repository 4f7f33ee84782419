"""One evaluation-form FRI fold on Hopper (CUDA kernel G, ``csrc/fri_fold.cu``).

`fri_fold` replaces the body of ``zkstark_tpu/protocol/prover.py``
``fri_fold_eval`` (without the Merkle tree), which XLA fused into one
elementwise pass on the TPU: from evals (B, m) and beta (B,), both
Montgomery-form device tensors, one pass writes `folded` (B, m/2) Montgomery
and `res` (B, m/2) standard residues,

    folded[j] = (a + b)/2 + β·(a − b)/(2·x_j),  a = evals[j], b = evals[j + m/2],

on the layer's half-domain x_j = off·base^j. 1/x_j is geometric: the kernel
takes inv_base^j from the two small cached device tables of a
`ntt_kernel.GeoScale` and folds 1/(2·off) into one scalar, so no table of m/2
words is built or uploaded, and beta is read from device memory, so the host
never waits for the challenge. The kernel is bound by bytes (4·m read,
2·2·m written a proof); every operand must be a reduced residue. On a CPU
tensor `fri_fold` runs `fri_fold_plain`, on a CUDA tensor only the kernel.
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build, ntt_kernel

fold_launches = 0  # launches of fri_fold_kernel, counted by fri_fold


def _beta_tensor(beta, batch: int, device) -> torch.Tensor:
    """beta as a (batch,) uint32 device tensor; a Python int is filled in on
    the device (no upload)."""
    if isinstance(beta, torch.Tensor):
        return fp.as_u32(fp.as_i32(beta).reshape(-1).expand(batch).contiguous())
    v = int(beta)
    signed = v - (1 << 32) if v >= 1 << 31 else v
    return fp.as_u32(torch.full((batch,), signed, dtype=torch.int32, device=device))


def fri_fold_plain(evals, beta, inv_base: int, inv_off: int, field: Field = FIELD101):
    """Plain-torch twin of the kernel, same arguments: the JAX fold's seven
    field ops in its order, with 1/x_j = inv_off·inv_base^j from the same two
    tables the kernel reads."""
    half = evals.shape[-1] // 2
    geo = ntt_kernel.GeoScale(inv_base, half)
    inv_x = fp.mont_mul_w(field, ntt_kernel._geo_factor_plain(geo, 1, half, field, evals.device)[0],
                          field.mont_scalar(inv_off))
    if isinstance(beta, torch.Tensor):
        beta = fp.wide(beta).reshape(evals.shape[:-1] + (1,))
    w = fp.wide(evals)
    a, b = w[..., :half], w[..., half:]
    inv2 = field.mont_scalar((field.p + 1) // 2)
    even = fp.mont_mul_w(field, fp.add_w(field, a, b), inv2)
    odd = fp.mont_mul_w(field, fp.mont_mul_w(field, fp.sub_w(field, a, b), inv2), inv_x)
    folded = fp.add_w(field, even, fp.mont_mul_w(field, odd, beta))
    return fp.narrow(folded), fp.narrow(fp.redc_w(field, 0, folded))


def fri_fold(evals: torch.Tensor, beta, inv_base: int, inv_off: int, field: Field = FIELD101,
             res_out: torch.Tensor | None = None):
    """evals (…, m) uint32 Montgomery residues, m ≥ 2 a power of two; beta a
    uint32 Montgomery tensor with one element per leading index of evals (or
    a Python int for all); inv_base, inv_off standard-form residues with
    1/x_j = inv_off·inv_base^j. Returns (folded, res), each (…, m/2), the
    residues written into `res_out` where given (the layer tree's values at
    the head of its one allocation: `hash.merkle.tree_values`)."""
    global fold_launches
    if evals.dtype != torch.uint32 or evals.dim() < 1:
        raise TypeError(f"fri_fold: needs a uint32 tensor, got {evals.dtype} {tuple(evals.shape)}")
    m = evals.shape[-1]
    if m < 2 or m & (m - 1):
        raise ValueError(f"fri_fold: layer size {m} is not a power of two ≥ 2")
    lead = evals.shape[:-1]
    batch = evals.numel() // m
    if isinstance(beta, torch.Tensor) and (beta.dtype != torch.uint32 or beta.numel() != batch
                                           or beta.device != evals.device):
        raise ValueError("fri_fold: beta must hold one uint32 per proof on the evals' device")
    half = m // 2
    res = _build.out_tensor(res_out, tuple(lead) + (half,), evals, "fri_fold")
    if evals.device.type == "cpu":
        folded, plain = fri_fold_plain(evals, beta, inv_base, inv_off, field)
        return folded, res.copy_(plain)
    _build.require(evals, "fri_fold", evals.dim())
    if batch > 65535:
        raise ValueError(f"fri_fold: {batch} proofs in one call (at most 65535)")
    dev = evals.device
    folded = torch.empty(tuple(lead) + (half,), dtype=torch.uint32, device=dev)
    if batch:
        ga, gb, shift = ntt_kernel._geo_tables(inv_base % field.p, half, field, dev)
        beta_t = _beta_tensor(beta, batch, dev)
        p = field.p
        inv2 = (p + 1) // 2
        with torch.cuda.device(dev):
            rc = _build.kernels().zk_fri_fold(
                evals.data_ptr(),
                beta_t.data_ptr(),
                ga.data_ptr(),
                gb.data_ptr(),
                shift,
                folded.data_ptr(),
                res.data_ptr(),
                batch,
                half,
                field.mont_scalar(inv2 * inv_off % p),
                field.mont_scalar(inv2),
                p,
                field.p_inv_neg,
                _build.stream(evals),
            )
        _build.check(rc, "fri_fold")
        fold_launches += 1
    return folded, res
