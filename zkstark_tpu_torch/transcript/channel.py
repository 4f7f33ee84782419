"""Fiat-Shamir channel — the serial spine of the protocol.

Byte-for-byte reimplementation of the reference Channel (channel.rs:6-37):
  * state starts as 32 zero bytes (channel.rs:13-16);
  * commit(bytes): state = SHA256(state ‖ bytes), transcript += bytes
    (channel.rs:19-26);
  * get_u32(): draw = big-endian state[0..4], then self-commit the draw as a
    little-endian bincode u32 — so challenges appear verbatim in the
    transcript (channel.rs:28-32, the BE-draw/LE-record asymmetry).

This ~40-step serial hash chain is inherently sequential (each challenge
depends on the previous phase's Merkle root), so it runs on the host and
defines the host↔device sync points of the prover (SURVEY.md §3.5). The
replayable state machine doubles as the verifier's challenge re-derivation,
which is strictly stronger than the reference verifier's read-challenges-
from-proof shortcut (proof.rs:22-35; SURVEY.md §3.3 quirk (a)).
"""

from __future__ import annotations

import hashlib

from zkstark_tpu_torch.transcript import bincode


class Channel:
    def __init__(self):
        self.state = b"\x00" * 32
        self.data = bytearray()

    def commit_bytes(self, payload: bytes) -> None:
        self.state = hashlib.sha256(self.state + payload).digest()
        self.data += payload

    def commit_cuts(self, payload, cuts) -> None:
        """`commit_bytes` of each piece of `payload` (any byte buffer) that
        ends at an offset of `cuts` (increasing, the last len(payload)), in
        order: one hash a piece over slices of the one buffer, which the
        transcript then takes whole."""
        view = memoryview(payload).cast("B")
        if not cuts or cuts[-1] != len(view):
            raise ValueError(f"cuts must end at the payload's {len(view)} bytes")
        state, start = self.state, 0
        for end in cuts:
            h = hashlib.sha256(state)
            h.update(view[start:end])
            state, start = h.digest(), end
        self.state = state
        self.data += view

    def commit_hash(self, digest: bytes) -> None:
        self.commit_bytes(bincode.ser_hash(digest))

    def commit_u32(self, value: int) -> None:
        self.commit_bytes(bincode.ser_u32(value))

    def get_u32(self) -> int:
        draw = int.from_bytes(self.state[:4], "big")
        self.commit_u32(draw)
        return draw

    def finalize(self):
        return self.state, bytes(self.data)


class ReplayChannel:
    """Verifier-side channel: replays the transcript prefix, re-deriving every
    challenge from the hash chain instead of trusting the recorded bytes.

    Each expect_u32() checks that the prover's recorded challenge equals the
    replayed one — any tampering with earlier commitments breaks every later
    challenge. Returns structured errors, never panics (unlike proof.rs)."""

    def __init__(self, data: bytes):
        self.reader = bincode.Reader(data)
        self.state = b"\x00" * 32

    def _absorb(self, payload: bytes) -> None:
        self.state = hashlib.sha256(self.state + payload).digest()

    def read_hash(self) -> bytes:
        h = self.reader.hash()
        self._absorb(h)
        return h

    def read_u32(self) -> int:
        v = self.reader.u32()
        self._absorb(bincode.ser_u32(v))
        return v

    def expect_u32(self) -> int:
        """Read a self-committed challenge and verify it against the replay."""
        expected = int.from_bytes(self.state[:4], "big")
        v = self.read_u32()
        if v != expected:
            raise TranscriptError(
                f"challenge mismatch: transcript has {v}, replay derives {expected}"
            )
        return v

    def read_opening(self):
        v = self.reader.u32()
        path = self.reader.auth_path()
        self._absorb(bincode.ser_opening(v, path))
        return v, path

    def read_row_opening(self, width: int):
        """A trace opening of w > 1 columns: the row's w u32s, then its path."""
        row = [self.reader.u32() for _ in range(width)]
        path = self.reader.auth_path()
        self._absorb(b"".join(map(bincode.ser_u32, row)) + bincode.ser_auth_path(path))
        return row, path

    def read_fri_opening(self):
        v0 = self.reader.u32()
        v1 = self.reader.u32()
        p0 = self.reader.auth_path()
        p1 = self.reader.auth_path()
        self._absorb(bincode.ser_fri_opening(v0, v1, p0, p1))
        return v0, v1, p0, p1


class TranscriptError(ValueError):
    pass
