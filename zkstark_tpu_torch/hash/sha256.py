"""Batched SHA-256 in plain torch — counterpart of ``zkstark_tpu/hash/sha256.py``.

N independent hashes per call: states are (N, 8) and message blocks (N, 16)
uint32 tensors. The arithmetic runs on int64 tensors holding 32-bit words
(torch's uint32 has no add or shift on every backend), masked back to 32 bits
after each add. These are the plain twins of the CUDA kernels in
``ops/sha256_kernel.py``; Merkle trees go through those wrappers.

Only the message shapes the protocol needs are provided:
  * `leaf_hash` — a 4-byte big-endian u32 (merkle.rs:30-34), one block;
  * `row_hash` — a row of w such words, the leaf of a trace of w columns;
  * `node_hash` — 64 bytes = left‖right digests (merkle.rs:42-45), two blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from zkstark_tpu_torch.field import fp

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_M32 = 0xFFFFFFFF

# The padding block of a 64-byte message: 0x80 then the bit length 512.
PAD_BLOCK_512 = (0x80000000,) + (0,) * 14 + (512,)


def _doubled(x):
    """x in both halves of 64 bits: a right shift by r < 32 of it, masked to
    32 bits, is the 32-bit rotation of x by r."""
    return x | (x << 32)


def schedule(w16: list) -> list:
    """The 64 message-schedule words of 16 block words (int64 tensors or
    Python ints holding 32-bit values)."""
    w = list(w16)
    for t in range(16, 64):
        a, b = w[t - 15], w[t - 2]
        aa, bb = _doubled(a), _doubled(b)
        s0 = aa >> 7
        s0 ^= aa >> 18
        s0 &= _M32
        s0 ^= a >> 3
        s1 = bb >> 17
        s1 ^= bb >> 19
        s1 &= _M32
        s1 ^= b >> 10
        s0 += w[t - 16]
        s0 += w[t - 7]
        s0 += s1
        s0 &= _M32
        w.append(s0)
    return w


def compress_words(state: list, w16: list) -> list:
    """One compression on word lists: 8 state words, 16 block words. Every
    temporary is fresh, so the in-place updates touch no input."""
    w = schedule(w16)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        ee = _doubled(e)
        t1 = ee >> 6
        t1 ^= ee >> 11
        t1 ^= ee >> 25
        t1 &= _M32  # Σ1(e)
        ch = f ^ g
        ch &= e
        ch ^= g  # Ch(e, f, g)
        t1 += ch
        t1 += h
        t1 += K[t] + w[t] if isinstance(w[t], int) else w[t] + K[t]
        aa = _doubled(a)
        t2 = aa >> 2
        t2 ^= aa >> 13
        t2 ^= aa >> 22
        t2 &= _M32  # Σ0(a)
        maj = a | b
        maj &= c
        maj |= a & b  # Maj(a, b, c)
        t2 += maj
        t2 += t1
        t2 &= _M32
        t1 += d
        t1 &= _M32
        a, b, c, d, e, f, g, h = t2, a, b, c, t1, e, f, g
    return [(s + o) & _M32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def _words(t: torch.Tensor, n: int) -> list:
    w = fp.wide(t)
    return [w[..., i] for i in range(n)]


def _stack(words: list) -> torch.Tensor:
    return fp.narrow(torch.stack(words, dim=-1))


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression: state (..., 8), block (..., 16) uint32."""
    return _stack(compress_words(_words(state, 8), _words(block, 16)))


def leaf_hash(values: torch.Tensor) -> torch.Tensor:
    """SHA-256 of the 4-byte big-endian encoding of each uint32 value
    (merkle.rs:30-34): one padded block [v, 0x80000000, 0×13, bitlen=32].
    values: (N,) uint32 → (N, 8) uint32."""
    v = fp.wide(values)
    block = [v, 0x80000000] + [0] * 13 + [32]
    zero = v & 0
    return _stack(compress_words([zero + h for h in H0], block))


def row_hash(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row's w words big-endian: the words, 0x80000000, zeros
    and the bit length 32·w, in as many blocks as that takes (one for
    w ≤ 13). rows: (N, w) uint32 → (N, 8) uint32; w = 1 is `leaf_hash`."""
    words = _words(rows, rows.shape[-1])
    w = len(words)
    pad = -(w + 3) % 16  # the 0x80000000 word, the zeros, the 64-bit length
    msg = words + [0x80000000] + [0] * pad + [0, 32 * w]
    zero = (words[0] if words else fp.wide(rows).sum(-1)) & 0
    state = [zero + h for h in H0]
    for at in range(0, len(msg), 16):
        state = compress_words(state, msg[at : at + 16])
    return _stack(state)


def node_hash(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA-256 of left‖right digests (merkle.rs:42-45). (N,8),(N,8) → (N,8)."""
    block = _words(left, 8) + _words(right, 8)
    zero = block[0] & 0
    mid = compress_words([zero + h for h in H0], block)
    return _stack(compress_words(mid, list(PAD_BLOCK_512)))


def digest_to_bytes(digest: np.ndarray) -> bytes:
    """(8,) uint32 words → canonical 32-byte big-endian digest."""
    return np.asarray(digest, dtype=">u4").tobytes()


def bytes_to_digest(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)
