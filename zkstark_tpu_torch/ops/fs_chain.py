"""The Fiat-Shamir chain on Hopper (CUDA kernel F, ``csrc/fs_chain.cu``).

`chain_step` runs one challenge boundary of B independent channels in one
launch: an optional commit (a Merkle root, or the FRI free term as a
little-endian u32), then k draws, each returned with its Montgomery form and,
for query indices, modulo the query range. It replaces what XLA fused out of
``zkstark_tpu/transcript/device_channel.py`` inside the one prover program on
the TPU; as plain tensor ops each compression would be hundreds of launches.
One thread runs one chain: the work is serial scalar hashing, so latency
bounds it, not bytes or instruction slots.

On a CPU tensor `chain_step` runs the plain version, the functions of
``transcript/device_channel.py``; on a CUDA tensor only the kernel.
`absorb_hash`, `absorb_u32_le` and `draw` are `chain_step` with one part.
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build
from zkstark_tpu_torch.transcript import device_channel as dc

chain_launches = 0  # launches of fs_chain_kernel, counted by chain_step


def chain_step_plain(state, *, digest=None, word=None, draws: int = 0,
                     field: Field = FIELD101, query_range: int | None = None, draws_out=None,
                     mod_out=None):
    """Plain-torch twin of the kernel, same arguments and results."""
    lead = state.shape[:-1]
    if digest is not None:
        state = dc.absorb_hash(state, digest)
    if word is not None:
        state = dc.absorb_u32_le(state, word)
    drawn = []
    for _ in range(draws):
        d, state = dc.draw_u32(state)
        drawn.append(fp.as_i32(d))
    if drawn:
        out = fp.as_u32(torch.stack(drawn, dim=-1))
    else:
        out = fp.zeros(lead + (0,), state.device)
    mont = dc.draw_to_mont(out, field)
    mod = None if query_range is None else fp.narrow(fp.wide(out) % query_range)
    if draws_out is not None:
        out = draws_out.copy_(out)
    if mod_out is not None:
        mod = mod_out.copy_(mod)
    return state, out, mont, mod


def chain_step(state: torch.Tensor, *, digest=None, word=None, draws: int = 0,
               field: Field = FIELD101, query_range: int | None = None, draws_out=None,
               mod_out=None):
    """state (…, 8) uint32 → (state', draws, mont, mod) after committing
    `digest` ((…, 8) uint32, any row stride), then `word` ((…,) uint32, a
    little-endian u32 commit, any stride), then drawing `draws` challenges.
    draws, mont and mod are (…, draws) uint32: the raw draws, their
    Montgomery forms over `field`, and (with `query_range`, else None) the
    draws modulo it; the first and the last are written into `draws_out` and
    `mod_out` where given, (…, draws) views whose rows are evenly strided
    (columns of the fused core's draws)."""
    global chain_launches
    if state.dtype != torch.uint32 or state.dim() < 1 or state.shape[-1] != 8:
        raise ValueError(f"fs_chain: needs a (…, 8) uint32 state, got {state.dtype} {tuple(state.shape)}")
    lead = state.shape[:-1]
    for name, t, shape in (("digest", digest, lead + (8,)), ("word", word, lead)):
        if t is None:
            continue
        if t.dtype != torch.uint32 or t.shape != shape or t.device != state.device:
            raise ValueError(f"fs_chain: {name} must be uint32 {tuple(shape)} on the state's device")
    if draws < 0 or (query_range is not None and not 0 < query_range < 1 << 32):
        raise ValueError("fs_chain: bad draw count or query range")
    for name, t in (("draws_out", draws_out), ("mod_out", mod_out)):
        if t is not None and (t.dtype != torch.uint32 or t.shape != lead + (draws,)
                              or t.device != state.device or (draws and t.stride(-1) != 1)):
            raise ValueError(f"fs_chain: {name} must be a uint32 {tuple(lead) + (draws,)} view "
                             "with unit column stride on the state's device")
    if mod_out is not None and query_range is None:
        raise ValueError("fs_chain: mod_out without a query range")
    if state.device.type == "cpu":
        return chain_step_plain(state, digest=digest, word=word, draws=draws, field=field,
                                query_range=query_range, draws_out=draws_out, mod_out=mod_out)
    _build.require(state, "fs_chain state", state.dim())
    chains = state.numel() // 8
    dev = state.device
    if digest is not None:
        digest = digest.reshape(chains, 8)  # a view where the rows are evenly strided
        if digest.stride(1) != 1 and chains:
            digest = fp.as_u32(fp.as_i32(digest).contiguous())
    if word is not None:
        word = word.reshape(chains)  # a view where the words are evenly strided
    new = torch.empty((chains, 8), dtype=torch.uint32, device=dev)
    out = torch.empty((3 if query_range is not None else 2, chains, draws),
                      dtype=torch.uint32, device=dev)
    rows = out[0] if draws_out is None else _rows(draws_out, chains, draws, "draws_out")
    mods = None if query_range is None else (
        out[2] if mod_out is None else _rows(mod_out, chains, draws, "mod_out"))
    if chains:
        with torch.cuda.device(dev):
            rc = _build.kernels().zk_fs_chain(
                state.data_ptr(),
                new.data_ptr(),
                None if digest is None else digest.data_ptr(),
                0 if digest is None else (digest.stride(0) if chains > 1 else 8),
                None if word is None else word.data_ptr(),
                0 if word is None else word.stride(0),
                draws,
                rows.data_ptr(),
                rows.stride(0) if chains > 1 else draws,
                out[1].data_ptr(),
                None if mods is None else mods.data_ptr(),
                0 if mods is None else (mods.stride(0) if chains > 1 else draws),
                query_range or 0,
                field.r2_mod_p,
                field.p,
                field.p_inv_neg,
                chains,
                _build.stream(state),
            )
        _build.check(rc, "fs_chain")
        chain_launches += 1
    parts = [t.reshape(lead + (draws,)) for t in out]
    raw = parts[0] if draws_out is None else draws_out
    mod = None if query_range is None else (parts[2] if mod_out is None else mod_out)
    return new.reshape(state.shape), raw, parts[1], mod


def _rows(view: torch.Tensor, chains: int, draws: int, name: str) -> torch.Tensor:
    """A (…, draws) view as (chains, draws) rows that are evenly strided."""
    rows = view.reshape(chains, draws)
    if draws and chains > 1 and rows.data_ptr() != view.data_ptr():
        raise ValueError(f"fs_chain: {name}'s rows must be evenly strided")
    return rows


def absorb_hash(state, digest):
    """state' = SHA256(state ‖ digest), as `device_channel.absorb_hash`."""
    return chain_step(state, digest=digest)[0]


def absorb_u32_le(state, word):
    """state' = SHA256(state ‖ LE(word)), as `device_channel.absorb_u32_le`."""
    return chain_step(state, word=word)[0]


def draw(state, k: int = 1, field: Field = FIELD101, query_range: int | None = None):
    """k successive draws in one launch: (state', draws, mont, mod)."""
    return chain_step(state, draws=k, field=field, query_range=query_range)
