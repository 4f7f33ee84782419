"""SHA-256 Merkle trees in plain PyTorch and hashlib, for the reference prover.

A leaf is the SHA-256 of one row of w values, each 4 bytes big-endian, in
column order (w = 1: one value); a parent is the SHA-256 of its children's
64 bytes, left then right; a path is the sibling digests from the leaf up.
Wide levels are hashed as whole-tensor int64 ops (32-bit words, masked after
each add) on the values' device, in blocks of rows; levels of at most
`HOST_MAX` digests, and leaves of rows too wide for one SHA-256 block, on
the host with hashlib.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

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
H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
M32 = 0xFFFFFFFF

HOST_MAX = 1 << 12  # levels this narrow are hashed with hashlib
BLOCK_ROWS = 1 << 22  # rows a block of the tensor path
ONE_BLOCK_WORDS = 13  # the widest row whose padded message is one block


def _doubled(x):
    """x in both halves of 64 bits: a right shift of it by r < 32, masked to
    32 bits, is the rotation of x by r."""
    return x | (x << 32)


def _compress(state: list, w16: list) -> list:
    """One compression of 16 words (int64 tensors or ints) into 8; every
    temporary is fresh, so the in-place updates touch no input."""
    w = list(w16)
    for t in range(16, 64):
        a, b = w[t - 15], w[t - 2]
        aa, bb = _doubled(a), _doubled(b)
        s0 = aa >> 7
        s0 ^= aa >> 18
        s0 &= M32
        s0 ^= a >> 3
        s1 = bb >> 17
        s1 ^= bb >> 19
        s1 &= M32
        s1 ^= b >> 10
        s0 += w[t - 16]
        s0 += w[t - 7]
        s0 += s1
        s0 &= M32
        w.append(s0)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        ee = _doubled(e)
        t1 = ee >> 6
        t1 ^= ee >> 11
        t1 ^= ee >> 25
        t1 &= M32  # Σ1(e)
        ch = f ^ g
        ch &= e
        ch ^= g  # Ch(e, f, g)
        t1 += ch
        t1 += h
        t1 += w[t] + K[t]
        aa = _doubled(a)
        t2 = aa >> 2
        t2 ^= aa >> 13
        t2 ^= aa >> 22
        t2 &= M32  # Σ0(a)
        maj = a | b
        maj &= c
        maj |= a & b  # Maj(a, b, c)
        t2 += maj
        t2 += t1
        t2 &= M32
        t1 += d
        t1 &= M32
        a, b, c, d, e, f, g, h = t2, a, b, c, t1, e, f, g
    return [(s + o) & M32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def _leaf_block(rows: torch.Tensor) -> torch.Tensor:
    """(k, w) int64 words, w ≤ ONE_BLOCK_WORDS → (k, 8): the row, the pad
    word, zeros and the message's bit length make one block."""
    w = rows.shape[1]
    cols = [rows[:, j] for j in range(w)]
    words = _compress(list(H0), cols + [0x80000000] + [0] * (14 - w) + [32 * w])
    return torch.stack([x if isinstance(x, torch.Tensor) else torch.full_like(cols[0], x)
                        for x in words], dim=1)


def _node_block(kids: torch.Tensor) -> torch.Tensor:
    """(k, 16) int64 words, left digest then right → (k, 8)."""
    cols = kids.t().contiguous()
    mid = _compress(list(H0), list(cols))
    pad = [0x80000000] + [0] * 14 + [512]
    return torch.stack(_compress(mid, pad), dim=1)


def _blocks(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + BLOCK_ROWS]) for i in range(0, x.shape[0], BLOCK_ROWS)])


def _host_digests(msgs: bytes, size: int) -> np.ndarray:
    out = b"".join(hashlib.sha256(msgs[i:i + size]).digest()
                   for i in range(0, len(msgs), size))
    return np.frombuffer(out, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def leaves(values: torch.Tensor):
    """Leaf digests of (n,) or (n, w) int64 residues, a leaf a row: a (n, 8)
    int64 tensor on their device, or a (n, 8) uint32 host array where
    n ≤ HOST_MAX or w > ONE_BLOCK_WORDS."""
    rows = values.reshape(values.shape[0], -1)
    if rows.shape[0] <= HOST_MAX or rows.shape[1] > ONE_BLOCK_WORDS:
        raw = rows.cpu().numpy().astype(">u4").tobytes()
        return _host_digests(raw, 4 * rows.shape[1])
    return _blocks(_leaf_block, rows)


def parents(level):
    """The level above `level` (as `leaves` returns it)."""
    if isinstance(level, np.ndarray):
        return _host_digests(level.astype(">u4").tobytes(), 64)
    kids = level.reshape(-1, 16)
    if kids.shape[0] <= HOST_MAX:
        return _host_digests(kids.cpu().numpy().astype(">u4").tobytes(), 64)
    return _blocks(_node_block, kids)


def digest_bytes(level, index: int) -> bytes:
    row = level[index]
    row = row.cpu().numpy() if isinstance(row, torch.Tensor) else row
    return np.asarray(row, dtype=">u4").tobytes()


class Tree:
    """Every level of a Merkle tree over (n,) int64 residues or (n, w) rows
    of them, n a power of two, leaf level first."""

    def __init__(self, values: torch.Tensor):
        self.values = values
        self.levels = [leaves(values)]
        while self.levels[-1].shape[0] > 1:
            self.levels.append(parents(self.levels[-1]))

    def root(self) -> bytes:
        return digest_bytes(self.levels[-1], 0)

    def value(self, index: int) -> int:
        return int(self.values[index])

    def row(self, index: int) -> list:
        """The leaf's values, in column order."""
        return self.values[index].reshape(-1).tolist()

    def path(self, index: int) -> list:
        """Sibling digests from the leaf up."""
        out = []
        for level in self.levels[:-1]:
            out.append(digest_bytes(level, index ^ 1))
            index >>= 1
        return out
