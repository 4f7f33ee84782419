"""Batched proving: B independent proofs through one run of launches —
counterpart of ``zkstark_tpu/protocol/batch.py``.

A small statement is bound by launch overhead, not by the card: every launch
of a stark-101 prove moves a few KB. With B witnesses as a leading axis each
launch does B times the work: B Fiat-Shamir chains advance in lockstep (one
thread each in the chain kernel), B Merkle trees are hashed per level as one
flat batch by the same two hash kernels, and the row transform takes B rows.
Each proof's bytes equal a solo `prove` of the same secret.

Sharding the batch axis over a mesh is not ported.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from zkstark_tpu_torch.protocol import fused
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.fused import fused_core_batch
from zkstark_tpu_torch.protocol.proof import Proof

__all__ = ["fused_core_batch", "prove_batch", "prove_batch_pipelined"]


def _dispatch_batch(cfg: StarkConfig, secrets, device: torch.device) -> fused.PendingFetch:
    """Witness check, upload, and one fused batch enqueued; does not wait for
    the device."""
    traces = np.stack([cfg.air.trace(cfg.trace_len, s, cfg.field.p) for s in secrets])
    for i, s in enumerate(secrets):
        if int(traces[i, -1]) != cfg.boundary_last:
            raise ValueError(f"witness {i} (secret {s}) fails the public boundary")
    traces_mont = pr.upload(cfg.field.host_to_mont(traces), device)
    return fused.PendingFetch(fused.pack_tree(fused_core_batch(cfg, traces_mont)))


def _finish_batch(cfg: StarkConfig, secrets, pending: fused.PendingFetch) -> list[Proof]:
    """Fetch one batch's packed result (one transfer) and run each proof's
    host replay and decommit serialization."""
    out = fused.unpack_tree(pending.wait(), fused.out_shapes(cfg, (len(secrets),)))
    proofs = []
    for i in range(len(secrets)):
        one = fused.map_leaves(out, lambda a: a[i])
        try:
            proofs.append(pr.finish_fused(cfg, one))
        except pr.DeviceChannelMismatch as e:
            raise pr.DeviceChannelMismatch(f"proof {i} {e}") from None
    return proofs


def prove_batch(cfg: StarkConfig, secrets, device="cuda") -> list[Proof]:
    """Prove B witnesses; returns B proofs, each byte-identical to a solo
    `prove` of the same secret. Raises ValueError if a secret's trace misses
    the public boundary."""
    dev = pr.resolve_device(device)
    secrets = list(secrets)
    return _finish_batch(cfg, secrets, _dispatch_batch(cfg, secrets, dev))


def prove_batch_pipelined(cfg: StarkConfig, secret_batches, depth: int = 2, device="cuda") -> list[Proof]:
    """A stream of batches with up to `depth` fused batches enqueued: the
    host work of one batch (B witnesses before, B replays and serializations
    after) overlaps the next batch's kernels instead of following them. The
    bytes equal `prove_batch` and solo `prove`."""
    dev = pr.resolve_device(device)
    pending, proofs = deque(), []
    for secrets in secret_batches:
        secrets = list(secrets)
        pending.append((secrets, _dispatch_batch(cfg, secrets, dev)))
        if len(pending) > depth:
            proofs.extend(_finish_batch(cfg, *pending.popleft()))
    while pending:
        proofs.extend(_finish_batch(cfg, *pending.popleft()))
    return proofs
