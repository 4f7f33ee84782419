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
  * the openings: each shard gathers the values and auth-path siblings it
    owns in one launch (owner masks in the kernel), shard 0 those of whole
    levels, and one `replicate` makes the packed result whole on every
    process.

`proof_core(cfg, mesh)` is phases 1–3 with the challenges as inputs.
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch import ntt
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
from zkstark_tpu_torch.protocol.openings import (
    opening_shapes,
    sparse_openings_device,
    sparse_openings_packed,
    unpack_tree,
)


def lde(cfg: StarkConfig, coeffs: torch.Tensor, mesh: Mesh | None):
    """Phase 1's coset LDE of the (B, ·) coefficients."""
    if mesh is None:
        return ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field)
    return coset_ntt_sixstep(coeffs[0], cfg.eval_domain, cfg.coset_offset, mesh, cfg.field)


def from_mont(cfg: StarkConfig, value):
    """The standard residues of a whole or sharded value (``ops/elementwise.py``:
    one launch a tensor or block on a card)."""
    if isinstance(value, list):
        return [elementwise.from_mont(b, cfg.field) for b in value]
    return elementwise.from_mont(value, cfg.field)


def build_levels(res, mesh: Mesh | None) -> list:
    """The tree's levels, leaf level first, each (B, k, 8) where whole:
    sharded below the subtree roots where `res` is; `levels[-1][:, 0]` is
    the (B, 8) root."""
    if isinstance(res, list):
        return [lv if isinstance(lv, list) else lv[None] for lv in sharded_build_levels(res, mesh)]
    return merkle.build_levels_batch(res)


def halo_words(cfg: StarkConfig) -> int:
    """How far past its block a shard's composition reads: max(shift)·blowup."""
    return max(cfg.air.shifts) * cfg.blowup


def composition(cfg: StarkConfig, f_eval, alphas_mont, mesh: Mesh | None):
    """(cp_eval, cp_res) of `prover.composition_eval_res`, whole or sharded
    like f_eval."""
    if not isinstance(f_eval, list):
        return pr.composition_eval_res(cfg, f_eval, alphas_mont)
    s_count = mesh.size
    points = cfg.eval_domain // s_count
    reach = halo_words(cfg)
    if points < reach:  # the halo would span shards: the whole domain, gathered
        cp, res = pr.composition_eval_res(cfg, mesh.all_gather(f_eval)[None],
                                          alphas_mont.reshape(1, -1))
        return mesh.shard(cp[0]), mesh.shard(res[0])
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
    return [o[0] for o in out], [o[1] for o in out]


def fold(cfg: StarkConfig, layer: int, evals, beta_mont, mesh: Mesh | None):
    """FRI layer `layer`'s fold and tree: (folded, res, levels), beta_mont
    (B,); sharded while m/2 ≥ S, else whole (a sharded layer is gathered
    first)."""
    if isinstance(evals, list) and evals[0].shape[0] * mesh.size // 2 >= mesh.size:
        inv_base, inv_off = pr._fri_layer_params(cfg, layer)
        folded, res = fold_sharded(evals, beta_mont, inv_base, inv_off, mesh, cfg.field)
        return folded, res, build_levels(res, mesh)
    return pr.fri_fold_eval(cfg, layer, whole(evals, mesh), beta_mont,
                            build=merkle.build_levels_batch)


def whole(value, mesh: Mesh | None) -> torch.Tensor:
    """The value as a whole (B, n) tensor (a sharded one gathered, B = 1)."""
    return mesh.all_gather(value)[None] if isinstance(value, list) else value


def openings(cfg: StarkConfig, f_res, f_levels, layer_res, layer_levels, queries,
             mesh: Mesh | None) -> dict:
    """`openings.sparse_openings_device` at the (B, q) queries. On a mesh:
    each local shard's owned words in one kernel launch, made whole on every
    process by one `replicate`, and unpacked into views of that vector."""
    if mesh is None:
        return sparse_openings_device(cfg, f_res, f_levels, layer_res, layer_levels, queries)
    parts = [
        sparse_openings_packed(cfg, f_res, f_levels, layer_res, layer_levels, queries,
                               shard=shard, block=i)
        for i, shard in enumerate(mesh.local)
    ]
    return unpack_tree(mesh.replicate(parts), opening_shapes(cfg, tuple(queries.shape[:-1])))


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
        roots = [build_levels(from_mont(cfg, f_eval), mesh)[-1][:, 0]]
        evals, res = composition(cfg, f_eval, alphas_mont[None], mesh)
        del f_eval
        roots.append(build_levels(res, mesh)[-1][:, 0])
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
