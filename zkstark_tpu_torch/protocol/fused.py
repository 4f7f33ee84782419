"""The one-fetch prover core — counterpart of ``zkstark_tpu/protocol/fused.py``.

The host-synced prover waits for a 32-byte fetch at every challenge boundary
(13 per stark-101 proof). Here the channel's hash chain runs on the device
(the CUDA kernel behind ``ops/fs_chain.py``, one launch per boundary), so
interpolation, LDE, Merkle commits, composition, every FRI fold, every
challenge and the phase-4 opening gathers are enqueued without one call that
waits for the device: challenges stay device tensors, the fold reads its beta
from device memory, and every constant table is cached on the device. Only
one packed vector (roots, challenges, a few KB of openings) crosses to the
host, through pinned memory behind an event (`PendingFetch`); the openings
kernel writes that vector whole, the draws and roots included, so nothing is
stacked or concatenated around it.

"One program" is one uninterrupted run of launches on the current stream,
and since nothing inside it waits, a warm one is one CUDA graph
(``protocol/graph.py``): on a card, below 2^20 points × B and without a
mesh, the first call of a (config, B) runs eagerly and fills the
per-statement caches, the second captures the launches, and every later
call replays them with a single ``cudaGraphLaunch`` (a stark-101 core is 48
launches whose Python enqueue costs about eight times their device time).
A mesh (collectives), the CPU, and larger statements, where the enqueue is
a few per cent of the device's work and a graph's private memory pool would
hold gigabytes, stay eager. The host then replays the byte transcript from
the fetched roots and checks every challenge (`prover.fused_replay`).

Every function takes a leading batch axis: B proofs are B chains in lockstep
and B trees hashed as one flat batch (``protocol/batch.py``); `fused_core` is
the B = 1 case with that axis removed. A trace of w > 1 columns
(`Air.width`) is (B, w, trace_len): its w polynomials ride the batch axis
through the interpolation and the LDE, its tree's leaf i is row i of the w
columns (``ops/sha256_kernel.py`` `leaf_hash_rows`), the composition reads
column c at shift k, and a trace opening is the row. A mesh proves traces of
one column. The steps are those of
``parallel/pipeline.py``, one body for both forms below.

With a `mesh` (``parallel/mesh.py``, B = 1) the program is sharded over the
evaluation domain: six-step LDE, subtree Merkle commits, the composition with
a halo, sharded folds and the owner-masked openings. The Fiat-Shamir chain
and the packed result are replicated: the chain runs once in each process
(once for a local mesh), and the bytes equal the single-device proof's at any
mesh size and shape.
"""

from __future__ import annotations

import numpy as np
import torch

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ops import fs_chain, tables
from zkstark_tpu_torch.parallel import pipeline as pl
from zkstark_tpu_torch.protocol import air, graph
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.openings import (  # noqa: F401 (pack_tree, map_leaves: the module's API)
    draw_columns,
    map_leaves,
    opening_shapes,
    pack_tree,
    unpack_tree,
)
from zkstark_tpu_torch.transcript import device_channel as dc


@tables.device_table(16)
@tracing.on_miss("_zero_state")
def _zero_state(bsz: int, device: torch.device) -> torch.Tensor:
    """B channels' zero state on `device`, made once: the chain kernel reads
    it and writes a new state, so no prove fills it again."""
    return dc.zero_state((bsz,), device)


def fused_core_batch_packed(cfg: StarkConfig, traces_mont: torch.Tensor,
                            mesh=None) -> torch.Tensor:
    """(B, trace_len) Montgomery traces ((B, w, trace_len) for w > 1
    columns) → everything B transcripts and
    decommitments need, as one flat uint32 vector on the traces' device, the
    challenges derived there: the leaves of `out_shapes(cfg, (B,))` (roots,
    alphas, betas, free_term, queries and the openings), keys sorted, each
    B-major, written by one launch of the openings kernel
    (`openings.packed_result`). Makes no call that waits for the device once
    its constant tables are cached (after one prove of the config on the
    device). With a `mesh`, B = 1 and the program is sharded over the
    evaluation domain; the vector is whole on every process. Warm calls on a
    card replay a CUDA graph of the launches (the module's docstring); the
    vector is the caller's own either way."""
    with tracing.span("enqueue"):
        return _GRAPHS(cfg, traces_mont, mesh)


def _core(cfg: StarkConfig, traces_mont: torch.Tensor, mesh) -> torch.Tensor:
    """The body of `fused_core_batch_packed`."""
    fld = cfg.field
    bsz = traces_mont.shape[0]
    dev = traces_mont.device
    if mesh is not None and bsz != 1:
        raise ValueError(f"a sharded core proves one trace, not {bsz}")
    if mesh is not None:
        pr.require_one_column(cfg, "a sharded core")

    # ---- Phase 1: interpolate + LDE + commit (prover.rs:24-85) ----
    with tracing.span("lde"):
        coeffs = air.interpolate_trace(traces_mont, cfg.trace_domain, fld)
        f_eval = pl.lde(cfg, coeffs, mesh)
    f_res, f_levels = pl.commit_lde(cfg, f_eval, mesh)

    # ---- Phase 2: composition (prover.rs:87-180). Every draw the host
    # replays goes into its column of one (B, ·) tensor ----
    cols = draw_columns(cfg)
    draws = torch.empty((bsz, sum(count for _, count in cols)), dtype=torch.uint32, device=dev)

    def column(which: int, first: int = 0, count: int | None = None) -> torch.Tensor:
        at = cols[which][0] + first
        return draws[:, at : at + (cols[which][1] if count is None else count)]

    state = _zero_state(bsz, dev)
    with tracing.span("chain"):
        state, _, alphas_mont, _ = fs_chain.chain_step(
            state, digest=f_levels[-1][:, 0], draws=cfg.n_constraints, field=fld,
            draws_out=column(0),
        )
    cp, cp_res, cp_levels = pl.composition(cfg, f_eval, alphas_mont, mesh)
    del f_eval, coeffs

    # ---- Phase 3: FRI (prover.rs:182-254). One chain launch per boundary:
    # the root just built, then the draw that follows it ----
    layer_res, layer_levels = [cp_res], [cp_levels]
    evals = cp
    for layer in range(cfg.fri_rounds):
        with tracing.span("chain"):
            state, _, beta_mont, _ = fs_chain.chain_step(
                state, digest=layer_levels[-1][-1][:, 0], draws=1, field=fld,
                draws_out=column(1, layer, 1),
            )
        evals, res, levels = pl.fold(cfg, layer, evals, beta_mont[:, 0], mesh)
        layer_res.append(res)
        layer_levels.append(levels)
    last = pl.whole(layer_res[-1], mesh)  # (B, n): word 0 is the free term

    # ---- Phase 4 prologue: the last root, the free term (read in place),
    # then every query draw before any opening (prover.rs:263, generalised to
    # n_queries) ----
    with tracing.span("chain"):
        fs_chain.chain_step(
            state, digest=layer_levels[-1][-1][:, 0], word=last[:, 0], draws=cfg.n_queries,
            field=fld, query_range=cfg.query_range, mod_out=column(2),
        )
    return pl.packed(cfg, f_res, f_levels, layer_res, layer_levels, draws, mesh)


# The core's graphs (``protocol/graph.py``). A config whose constants leave
# their cache loses its graphs, which would otherwise keep the constants.
_GRAPHS = graph.CoreGraphs(_core)
pr.composition_constants.on_drop.append(lambda cfg, device: _GRAPHS.drop(cfg))


def fused_core_batch(cfg: StarkConfig, traces_mont: torch.Tensor, mesh=None) -> dict:
    """`fused_core_batch_packed` as a dict of views of its vector: roots
    (B, 2 + fri_rounds, 8) digests in commit order, alphas (B,
    n_constraints), betas (B, fri_rounds), free_term (B,), queries (B,
    n_queries), and the openings of `openings.sparse_openings_device` behind
    the leading B."""
    flat = fused_core_batch_packed(cfg, traces_mont, mesh)
    return unpack_tree(flat, out_shapes(cfg, (traces_mont.shape[0],)))


def fused_core(cfg: StarkConfig, trace_mont: torch.Tensor, mesh=None) -> dict:
    """(trace_len,) Montgomery trace → the dict of `fused_core_batch` without
    the batch axis, the JAX package's shapes: roots (2 + fri_rounds, 8),
    alphas (n_constraints,), betas (fri_rounds,), free_term (), queries
    (n_queries,), open_f_vals (q, n_shifts) ((q, n_shifts, w) for w > 1
    columns), open_f_paths (q, n_shifts,
    depth, 8), open_cp_vals (q,), open_cp_paths (q, depth, 8) and per FRI
    layer open_fri_vals (q, 2), open_fri_paths (q, 2, depth, 8); views of
    `fused_core_packed`'s vector. With a `mesh`, sharded over the evaluation
    domain (the trace replicated on the mesh's device); every leaf is whole
    on every process."""
    return unpack_tree(fused_core_packed(cfg, trace_mont, mesh), out_shapes(cfg))


def out_shapes(cfg: StarkConfig, lead: tuple = ()) -> dict:
    """The shape of every leaf of `fused_core` (lead = ()) or
    `fused_core_batch` (lead = (B,)), from the config alone."""
    rounds = cfg.fri_rounds
    return {
        "roots": lead + (2 + rounds, 8),
        "alphas": lead + (cfg.n_constraints,),
        "betas": lead + (rounds,),
        "free_term": lead,
        "queries": lead + (cfg.n_queries,),
        **opening_shapes(cfg, lead),
    }


def fused_core_packed(cfg: StarkConfig, trace_mont: torch.Tensor, mesh=None) -> torch.Tensor:
    """`fused_core` with the whole result packed into one flat uint32 vector
    (with a mesh: the same vector in every process): `pack_tree` of its dict,
    which the kernel writes as it is (B = 1 of `fused_core_batch_packed`)."""
    return fused_core_batch_packed(cfg, fp.as_u32(fp.as_i32(trace_mont)[None]), mesh)


def unpack_out(cfg: StarkConfig, flat: np.ndarray) -> dict:
    """Host-side inverse of `fused_core_packed`."""
    return unpack_tree(flat, out_shapes(cfg))


class PendingFetch:
    """A packed result on its way to the host. On a card the words are copied
    to pinned host memory on the current stream without blocking, behind a
    recorded event; `wait` blocks on that event alone, so kernels enqueued
    after the copy keep the card busy meanwhile."""

    def __init__(self, flat: torch.Tensor):
        words = fp.as_i32(flat)
        if flat.device.type == "cuda":
            self.host = torch.empty(words.shape, dtype=torch.int32, pin_memory=True)
            self.host.copy_(words, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(flat.device))
        else:
            self.host, self.event = words, None

    def wait(self) -> np.ndarray:
        """The fetched words as a uint32 numpy array."""
        with tracing.span("wait"):
            if self.event is not None:
                self.event.synchronize()
            return self.host.numpy().view(np.uint32)
