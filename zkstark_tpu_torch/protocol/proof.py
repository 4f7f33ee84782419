"""Proof container — mirrors reference Proof{state, data} (proof.rs:5-8)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Proof:
    state: bytes  # final channel state (32 bytes)
    data: bytes  # the serialized transcript

    def size(self) -> int:
        """Reference size(): 48-byte struct (32 + Box fat pointer) + data
        (proof.rs:151-154)."""
        return 48 + len(self.data)

    def to_bytes(self) -> bytes:
        """Stable on-disk form: state ‖ data (data length is implicit)."""
        return self.state + self.data

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Proof":
        if len(raw) < 32:
            raise ValueError("proof blob shorter than a channel state")
        return cls(state=raw[:32], data=raw[32:])


def expected_proof_len(cfg) -> int:
    """The length of a proof's transcript from the proof layout: the roots
    (32 B each), the free term and every drawn challenge (4 B each), and per
    query the trace openings (a row of w values and a path: 4·w + 8 +
    32·depth each), the composition opening (4 + 8 + 32·depth) and one pair
    per FRI layer (two values, two paths)."""
    depth = cfg.eval_domain.bit_length() - 1
    rounds, q = cfg.fri_rounds, cfg.n_queries
    path = 8 + 32 * depth
    opening = len(cfg.air.shifts) * (4 * cfg.air.width + path) + 4 + path
    pairs = sum(8 + 2 * (8 + 32 * (depth - layer)) for layer in range(rounds))
    return 32 * (2 + rounds) + 4 + 4 * (cfg.n_constraints + rounds + q) + q * (opening + pairs)
