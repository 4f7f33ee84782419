"""The proof program, phase by phase — counterpart of
``zkstark_tpu/parallel/pipeline.py``: the steps that ``protocol/fused.py``
and `proof_core` run, each on one device or sharded over a mesh.

A value of the program is whole (a tensor with a leading axis of B proofs,
B = 1 on a mesh) or sharded (the list of this process's blocks of one proof).
Without a mesh every step is the single-device function on the batch axis.
Where the JAX package left a step to GSPMD, the sharded rule is written out
here:

  * the LDE is the six-step NTT (``parallel/ntt_sharded.py``);
  * a tree is sharded while its leaves are at least S
    (``parallel/merkle_sharded.py``), else built whole;
  * the composition runs one kernel launch a shard on its block and a halo
    of max(shift)·blowup words from the next shard, cyclically (one
    exchange); a shard smaller than its halo falls back to the whole domain,
    gathered;
  * a fold is sharded while m/2 ≥ S (``parallel/fri_sharded.py``); below,
    the layer is gathered and folded whole, as the JAX package does;
  * the packed result: each shard writes the values and auth-path siblings
    it owns in one launch (owner masks in the kernel), shard 0 those of whole
    levels, the roots, the draws and the free term, and one `replicate`
    makes it whole on every process.

`proof_core(cfg, mesh)` is phases 1–3 with the challenges as inputs.
"""

from __future__ import annotations

import functools
import math

import torch

from zkstark_tpu_torch import ntt, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import composition as comp_op
from zkstark_tpu_torch.ops import elementwise
from zkstark_tpu_torch.parallel.fri_sharded import fold_sharded
from zkstark_tpu_torch.parallel.merkle_sharded import sharded_build_levels
from zkstark_tpu_torch.parallel.mesh import Mesh
from zkstark_tpu_torch.parallel.ntt_sharded import coset_ntt_sixstep
from zkstark_tpu_torch.protocol import air
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.openings import packed_result


def lde(cfg: StarkConfig, coeffs: torch.Tensor, mesh: Mesh | None):
    """Phase 1's coset LDE of the (B, ·) coefficients, or (B, w, ·) of a
    trace of w > 1 columns: the columns ride the batch axis."""
    if mesh is None:
        return ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field)
    return coset_ntt_sixstep(coeffs[0], cfg.eval_domain, cfg.coset_offset, mesh, cfg.field)


def _tree_values(shape: tuple, device, width: int = 1) -> tuple:
    """`merkle.tree_values` in `shape` (…, n), or (…, w, n) for trees of rows
    of `width` = w > 1 words: (values, room), the values at the head of
    their tree's one allocation."""
    lead = shape[:-1] if width == 1 else shape[:-2]
    values, room = merkle.tree_values(math.prod(lead), shape[-1], device, width)
    return values.view(shape), room


def build_levels(res, mesh: Mesh | None, room: torch.Tensor | None = None) -> list:
    """The tree's levels, leaf level first, each (B, k, 8) where whole:
    sharded below the subtree roots where `res` is; `levels[-1][:, 0]` is
    the (B, 8) root. A whole `res` made by `_tree_values` passes its `room`,
    where the levels are written after it."""
    if isinstance(res, list):
        with tracing.span("merkle"):
            levels = sharded_build_levels(res, mesh)  # a ShardedLevels: keep its buffers
            levels[:] = [lv if isinstance(lv, list) else lv[None] for lv in levels]
            return levels
    return merkle.build_levels_batch(res, room)


def commit_lde(cfg: StarkConfig, f_eval, mesh: Mesh | None) -> tuple:
    """Phase 1's commitment, (f_res, f_levels): the standard residues of a
    whole or sharded f_eval (``ops/elementwise.py``: one launch a tensor or
    block on a card) and their tree; a whole one in one allocation with its
    levels (`merkle.tree_values`). A trace of w > 1 columns, f_eval (B, w,
    d), is one tree of d row leaves a proof."""
    if isinstance(f_eval, list):
        res = [elementwise.from_mont(b, cfg.field) for b in f_eval]
        return res, build_levels(res, mesh)
    res, room = _tree_values(f_eval.shape, f_eval.device, cfg.air.width)
    elementwise.from_mont(f_eval, cfg.field, out=res)
    return res, build_levels(res, mesh, room)


def halo_words(cfg: StarkConfig) -> int:
    """How far past its block a shard's composition reads: max(shift)·blowup."""
    return max(cfg.air.shifts) * cfg.blowup


def composition(cfg: StarkConfig, f_eval, alphas_mont, mesh: Mesh | None):
    """(cp_eval, cp_res, cp_levels): `prover.composition_eval_res`, whole
    or sharded like f_eval, and the tree of the residues (a whole one in one
    allocation with its levels). A whole f_eval of w > 1 columns is (B, w,
    d), the composition (B, d)."""
    if not isinstance(f_eval, list):
        shape = f_eval.shape if cfg.air.width == 1 else f_eval.shape[:-2] + f_eval.shape[-1:]
        res, room = _tree_values(shape, f_eval.device)
        cp, res = pr.composition_eval_res(cfg, f_eval, alphas_mont, res_out=res)
        return cp, res, build_levels(res, None, room)
    s_count = mesh.size
    points = cfg.eval_domain // s_count
    reach = halo_words(cfg)
    if points < reach:  # the halo would span shards: the whole domain, gathered
        cp, res = pr.composition_eval_res(cfg, mesh.all_gather(f_eval)[None],
                                          alphas_mont.reshape(1, -1))
        res = mesh.shard(res[0])
        return mesh.shard(cp[0]), res, build_levels(res, mesh)
    if reach:
        halos = mesh.exchange([b[:reach] for b in f_eval], lambda s: [(s - 1) % s_count])
    else:
        halos = [fp.zeros((0,), mesh.device) for _ in f_eval]
    inv = pr.composition_constants(cfg, mesh.device)
    prog = pr.composition_program(cfg)
    out = [
        comp_op.composition(blk, inv, alphas_mont, prog, cfg.field, halo=halo, start=t * points)
        for t, blk, halo in zip(mesh.local, f_eval, halos)
    ]
    res = [o[1] for o in out]
    return [o[0] for o in out], res, build_levels(res, mesh)


def fold(cfg: StarkConfig, layer: int, evals, beta_mont, mesh: Mesh | None):
    """FRI layer `layer`'s fold and tree: (folded, res, levels), beta_mont
    (B,); sharded while m/2 ≥ S, else whole (a sharded layer is gathered
    first)."""
    with tracing.span("fold"):
        if isinstance(evals, list) and evals[0].shape[0] * mesh.size // 2 >= mesh.size:
            inv_base, inv_off = pr._fri_layer_params(cfg, layer)
            folded, res = fold_sharded(evals, beta_mont, inv_base, inv_off, mesh, cfg.field)
            return folded, res, build_levels(res, mesh)
        evals = whole(evals, mesh)
        res, room = _tree_values(evals.shape[:-1] + (evals.shape[-1] // 2,), evals.device)
        return pr.fri_fold_eval(cfg, layer, evals, beta_mont, res_out=res,
                                build=functools.partial(merkle.build_levels_batch, room=room))


def whole(value, mesh: Mesh | None) -> torch.Tensor:
    """The value as a whole (B, n) tensor (a sharded one gathered, B = 1)."""
    return mesh.all_gather(value)[None] if isinstance(value, list) else value


def packed(cfg: StarkConfig, f_res, f_levels, layer_res, layer_levels, draws,
           mesh: Mesh | None) -> torch.Tensor:
    """The fused core's packed result (`openings.packed_result`): one kernel
    launch; on a mesh one a local shard, each writing the words it owns (shard
    0 the whole ones), made whole on every process by one `replicate`."""
    if mesh is None:
        return packed_result(cfg, f_res, f_levels, layer_res, layer_levels, draws)
    return mesh.replicate([
        packed_result(cfg, f_res, f_levels, layer_res, layer_levels, draws, shard=shard, block=i)
        for i, shard in enumerate(mesh.local)
    ])


def proof_core(cfg: StarkConfig, mesh: Mesh | None = None):
    """fn(trace_mont, alphas_mont, betas_mont) → {"roots": (2 + fri_rounds,
    8), "free_term": (), "final_layer": (d >> fri_rounds,)}, uint32 and
    replicated: phases 1–3 with the challenges given (Montgomery, (3,) and
    (fri_rounds,) tensors on the trace's device), sharded over `mesh` when
    given. The JAX package's dry-run program: every collective of the sharded
    prover appears in one call."""
    fld = cfg.field

    def fn(trace_mont, alphas_mont, betas_mont):
        coeffs = air.interpolate_trace(trace_mont[None], cfg.trace_domain, fld)
        f_eval = lde(cfg, coeffs, mesh)
        roots = [commit_lde(cfg, f_eval, mesh)[1][-1][:, 0]]
        evals, res, levels = composition(cfg, f_eval, alphas_mont[None], mesh)
        del f_eval
        roots.append(levels[-1][:, 0])
        for layer in range(cfg.fri_rounds):
            evals, res, levels = fold(cfg, layer, evals, betas_mont[layer : layer + 1], mesh)
            roots.append(levels[-1][:, 0])
        final = whole(res, mesh)[0]
        return {
            "roots": fp.as_u32(torch.cat([fp.as_i32(r) for r in roots])),
            "free_term": fp.as_u32(fp.as_i32(final)[0]),
            "final_layer": final,
        }

    return fn
