"""The Fiat-Shamir channel's hash chain on device tensors, in plain torch —
counterpart of ``zkstark_tpu/transcript/device_channel.py``.

The channel (channel.rs:19-32) is a serial SHA-256 chain. With its state as
an (…, 8) uint32 word tensor on the device, the prover derives every
challenge where the Merkle roots already are, and the host waits for nothing
until the one fetch at the end (``protocol/fused.py``). These functions are
the plain version of the chain: the CUDA kernel ``csrc/fs_chain.cu`` computes
the same words in one launch per challenge boundary, and ``ops/fs_chain.py``
chooses between the two by the tensor's device.

The last axis holds the state or digest words; the leading axes are
independent channels, so B proofs run B chains in lockstep
(``protocol/batch.py``).

Byte conventions, exactly the reference's:
  * state words = the 32-byte state as 8 big-endian u32s (the SHA-256 word
    order, `sha256.digest_to_bytes`);
  * commit(hash): the payload is 32 raw bytes, the message state ‖ payload is
    64 bytes, so two compressions;
  * get_u32(): the draw is state word 0 (channel.rs:29), self-committed as 4
    little-endian bytes (bincode u32), which as a message word is
    bswap32(draw); the message is 36 bytes, one compression.

torch's uint32 has no arithmetic, so words are widened to int64 (`fp.wide`)
and narrowed back; a draw ≥ 2^31 is an ordinary value there.
"""

from __future__ import annotations

import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import sha256


def zero_state(batch_shape: tuple = (), device="cuda") -> torch.Tensor:
    """The channel's initial all-zero 32-byte state (channel.rs:13-16)."""
    return fp.zeros(tuple(batch_shape) + (8,), fp.resolve_device(device))


def bswap32(x: torch.Tensor) -> torch.Tensor:
    w = fp.wide(x)
    return fp.narrow(
        ((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00) | (w >> 24)
    )


def _h0(like: torch.Tensor) -> list:
    zero = like & 0
    return [zero + h for h in sha256.H0]


def absorb_hash(state: torch.Tensor, digest: torch.Tensor) -> torch.Tensor:
    """state' = SHA256(state ‖ digest): a 64-byte message, two compressions."""
    s, d = fp.wide(state), fp.wide(digest)
    block = [s[..., i] for i in range(8)] + [d[..., i] for i in range(8)]
    mid = sha256.compress_words(_h0(block[0]), block)
    return fp.narrow(torch.stack(sha256.compress_words(mid, list(sha256.PAD_BLOCK_512)), dim=-1))


def absorb_u32_le(state: torch.Tensor, word) -> torch.Tensor:
    """state' = SHA256(state ‖ LE(word)): a 36-byte message, one compression.
    word: a uint32 tensor of the state's leading shape (or broadcastable to
    it), or a Python int."""
    s = fp.wide(state)
    if not isinstance(word, torch.Tensor):
        word = fp.narrow(torch.full(s.shape[:-1], int(word), dtype=torch.int64, device=s.device))
    w = fp.wide(bswap32(word)).expand(s.shape[:-1])
    block = [s[..., i] for i in range(8)] + [w, 0x80000000, 0, 0, 0, 0, 0, 36 * 8]
    return fp.narrow(torch.stack(sha256.compress_words(_h0(w), block), dim=-1))


def draw_u32(state: torch.Tensor):
    """(draw, state'): the draw is state word 0, then its little-endian bytes
    are self-committed (channel.rs:28-32). The draw has the state's leading
    shape."""
    draw = fp.as_u32(fp.as_i32(state)[..., 0].contiguous())
    return draw, absorb_u32_le(state, draw)


def draw_to_mont(draw: torch.Tensor, field: fp.Field = fp.FIELD101) -> torch.Tensor:
    """Challenge u32 → Montgomery field element (the reference's From<u32>:
    the value mod p). One REDC of draw·R², valid for any uint32."""
    return fp.to_mont_f(field, draw)
