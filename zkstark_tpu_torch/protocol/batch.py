"""Batched proving: B independent proofs through one run of launches —
counterpart of ``zkstark_tpu/protocol/batch.py``.

A small statement is bound by launch overhead, not by the card: every launch
of a stark-101 prove moves a few KB. With B witnesses as a leading axis each
launch does B times the work: B Fiat-Shamir chains advance in lockstep (one
thread each in the chain kernel), B Merkle trees are hashed per level as one
flat batch by the same two hash kernels, and the row transform takes B rows.
Each proof's bytes equal a solo `prove` of the same secret.

With a mesh (``parallel/mesh.py``) the batch axis is split over the shards —
pure data parallelism: each shard proves its group of witnesses, and one
`replicate` makes every group's packed result whole on every process.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.protocol import fused
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.fused import fused_core_batch
from zkstark_tpu_torch.protocol.proof import Proof

__all__ = ["fused_core_batch", "prove_batch", "prove_batch_pipelined"]


def _witnesses(cfg: StarkConfig, secrets, device: torch.device, offset: int = 0) -> torch.Tensor:
    """(B, trace_len) Montgomery witnesses in host memory that `upload` sends
    to `device` (``prover.witness_words``), each checked against the public
    boundary."""
    with tracing.span("witness"):
        words, last = pr.witness_words(cfg, secrets, device)
        for i, s in enumerate(secrets):
            if int(last[i]) != cfg.boundary_last:
                raise ValueError(f"witness {offset + i} (secret {s}) fails the public boundary")
        return words


def _dispatch_batch(cfg: StarkConfig, secrets, device: torch.device) -> fused.PendingFetch:
    """Witness check, upload, and one fused batch enqueued; does not wait for
    the device."""
    traces_mont = pr.upload(_witnesses(cfg, secrets, device), device)
    return fused.PendingFetch(fused.fused_core_batch_packed(cfg, traces_mont))


def _finish_batch(cfg: StarkConfig, secrets, words: np.ndarray) -> list[Proof]:
    """One batch's fetched packed result → each proof's host replay and
    decommit serialization."""
    out = fused.unpack_tree(words, fused.out_shapes(cfg, (len(secrets),)))
    proofs = []
    for i in range(len(secrets)):
        one = fused.map_leaves(out, lambda a: a[i])
        try:
            proofs.append(pr.finish_fused(cfg, one))
        except pr.DeviceChannelMismatch as e:
            raise pr.DeviceChannelMismatch(f"proof {i} {e}") from None
    return proofs


def prove_batch(cfg: StarkConfig, secrets, device="cuda", mesh=None,
                data_axis: str | None = None) -> list[Proof]:
    """Prove B witnesses; returns B proofs, each byte-identical to a solo
    `prove` of the same secret. Raises ValueError if a secret's trace misses
    the public boundary.

    mesh: the batch axis is split over the mesh's axis `data_axis` (default:
    all axes, flattened) into equal groups, each proved on the mesh's device
    by the first shard of its group (the others along the remaining axes hold
    it replicated); every process returns all B proofs. A mesh takes traces
    of one column (ValueError otherwise, before any launch)."""
    secrets = list(secrets)
    if mesh is not None:
        pr.require_one_column(cfg, "prove_batch over a mesh")
    with tracing.span("prove_batch"):
        if mesh is None:
            dev = pr.resolve_device(device)
            return _finish_batch(cfg, secrets, _dispatch_batch(cfg, secrets, dev).wait())
        return _prove_batch_mesh(cfg, secrets, mesh, data_axis)


def _prove_batch_mesh(cfg: StarkConfig, secrets: list, mesh, data_axis) -> list[Proof]:
    axes = mesh.axis_names
    if data_axis is not None and data_axis not in axes:
        raise ValueError(f"prove_batch: the mesh has no axis {data_axis!r} (axes {axes})")
    groups = mesh.size if data_axis is None else mesh.shape[data_axis]
    if len(secrets) % groups:
        raise ValueError(f"prove_batch: {len(secrets)} witnesses do not split into {groups} groups")
    inner = 1  # shards along the axes after data_axis
    if data_axis is not None:
        for name in axes[axes.index(data_axis) + 1 :]:
            inner *= mesh.shape[name]

    per = len(secrets) // groups
    size = sum(int(np.prod(s)) for v in fused.out_shapes(cfg, (per,)).values()
               for s in (v if isinstance(v, list) else [v]))
    parts = []
    for shard in mesh.local:
        g = (shard // inner) % groups  # the data-axis coordinate
        g = g if shard == g * inner else None  # only the group's first shard proves it
        part = torch.zeros((groups, size), dtype=torch.int32, device=mesh.device)
        if g is not None:
            chunk = secrets[g * per : (g + 1) * per]
            traces = _witnesses(cfg, chunk, mesh.device, offset=g * per)
            flat = fused.fused_core_batch_packed(cfg, pr.upload(traces, mesh.device))
            part[g].copy_(fp.as_i32(flat))
        parts.append(part)
    whole = fused.PendingFetch(mesh.replicate(parts).reshape(-1)).wait().reshape(groups, size)
    proofs = []
    for g in range(groups):
        proofs += _finish_batch(cfg, secrets[g * per : (g + 1) * per], whole[g])
    return proofs


def prove_batch_pipelined(cfg: StarkConfig, secret_batches, depth: int = 2, device="cuda") -> list[Proof]:
    """A stream of batches with up to `depth` fused batches enqueued: the
    host work of one batch (B witnesses before, B replays and serializations
    after) overlaps the next batch's kernels instead of following them. The
    bytes equal `prove_batch` and solo `prove`."""
    with tracing.span("prove_batch_pipelined"):
        dev = pr.resolve_device(device)
        pending, proofs = deque(), []
        for secrets in secret_batches:
            secrets = list(secrets)
            pending.append((secrets, _dispatch_batch(cfg, secrets, dev)))
            if len(pending) > depth:
                batch, fetch = pending.popleft()
                proofs.extend(_finish_batch(cfg, batch, fetch.wait()))
        while pending:
            batch, fetch = pending.popleft()
            proofs.extend(_finish_batch(cfg, batch, fetch.wait()))
        return proofs
