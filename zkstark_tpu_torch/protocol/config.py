"""Protocol configuration — counterpart of ``zkstark_tpu/protocol/config.py``.

A STARK has no weights: a configuration and the proof bytes are the whole
state. `from_reference` carries a JAX `StarkConfig` across by its attributes,
without importing JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from zkstark_tpu_torch.field.fp import FIELD101, FIELD_ALT, Field, field_for
from zkstark_tpu_torch.protocol.air import AIRS, FIBONACCI_SQ, Air


@dataclass(frozen=True)
class StarkConfig:
    trace_len: int = 1023  # number of trace steps (subgroup size − 1)
    blowup: int = 8
    coset_offset: int = 5  # prover.rs:69: evaluation coset = offset·⟨h⟩
    boundary_first: int = 1  # public input a[0] (proof.rs:69)
    boundary_last: int = 2338775057  # public output a[trace_len−1] (proof.rs:70)
    n_queries: int = 1  # FRI query count (the reference draws 1, prover.rs:263)
    air: Air = dc_field(default=FIBONACCI_SQ)
    field: Field = dc_field(default=FIELD101)

    def __post_init__(self):
        n = self.trace_domain
        p = self.field.p
        if n & (n - 1):
            raise ValueError("trace domain must be a power of two")
        if self.blowup & (self.blowup - 1):
            raise ValueError("blowup must be a power of two")
        if (p - 1) % self.eval_domain:
            raise ValueError(
                f"domain {self.eval_domain} too large for field: needs 2-adicity "
                f"{self.eval_domain.bit_length() - 1}, p-1 has {self.field.two_adicity}"
            )
        if pow(self.coset_offset, self.eval_domain, p) == 1:
            raise ValueError("coset offset lies in the evaluation subgroup")
        if not (0 <= self.boundary_first < p and 0 <= self.boundary_last < p):
            raise ValueError("boundary values must be residues mod p")
        if self.n_queries < 1:
            raise ValueError("n_queries must be at least 1")
        if 1 << self.fri_rounds >= self.eval_domain:
            raise ValueError(
                f"a degree-{self.air.degree} AIR's composition has degree under "
                f"{1 << self.fri_rounds}, not below the evaluation domain of "
                f"{self.eval_domain} points: blowup {self.blowup} is too small"
            )

    @property
    def trace_domain(self) -> int:
        """Size of the trace subgroup ⟨g⟩ (reference: 1024, prover.rs:52)."""
        return self.trace_len + 1

    @property
    def eval_domain(self) -> int:
        """Size of the evaluation coset (reference: 8192, prover.rs:53)."""
        return self.trace_domain * self.blowup

    @property
    def fri_rounds(self) -> int:
        """Folds until degree 0 (reference: 10, prover.rs:198): log2 of the
        composition's degree bound. A transition numerator of degree k over
        a trace polynomial of degree n − 2, divided by a vanishing polynomial
        of degree n − |exempt|, has degree under n·max(1, k − 1), rounded up
        to a power of two: log2 n for k ≤ 2, log2(2n) for k = 3."""
        return (self.trace_domain * max(1, self.air.degree - 1) - 1).bit_length()

    @property
    def query_range(self) -> int:
        """domain − max_shift·blowup (reference: 8176, prover.rs:263)."""
        return self.eval_domain - self.air.max_shift * self.blowup

    @property
    def constraints(self) -> tuple:
        return self.air.constraints(self)

    @property
    def n_constraints(self) -> int:
        return len(self.constraints)

    @property
    def trace_generator(self) -> int:
        return self.field.subgroup_generator(self.trace_domain)

    @property
    def domain_generator(self) -> int:
        return self.field.subgroup_generator(self.eval_domain)


STARK101 = StarkConfig()
STARK101_SECRET = 3141592  # the reference's baked-in witness (prover.rs:34)
# The same statement with three FRI queries (tests/test_protocol_golden_q3.py).
STARK101_Q3 = StarkConfig(n_queries=3)


def alt_field_config(trace_len: int = 1023, secret: int = 3141592, **kw) -> StarkConfig:
    """The stark-101 statement over the second prime (p = 15·2^27 + 1), its
    public output derived from the witness (the recurrence wraps mod p)."""
    trace = FIBONACCI_SQ.trace(trace_len, secret, FIELD_ALT.p)
    return StarkConfig(trace_len=trace_len, boundary_last=int(trace[-1]), field=FIELD_ALT, **kw)


def from_reference(cfg_like) -> StarkConfig:
    """The port's config for any object with the attributes of the JAX
    `StarkConfig`: trace_len, blowup, coset_offset, boundary_first,
    boundary_last, n_queries, air.name and field.p."""
    return StarkConfig(
        trace_len=int(cfg_like.trace_len),
        blowup=int(cfg_like.blowup),
        coset_offset=int(cfg_like.coset_offset),
        boundary_first=int(cfg_like.boundary_first),
        boundary_last=int(cfg_like.boundary_last),
        n_queries=int(cfg_like.n_queries),
        air=AIRS[cfg_like.air.name],
        field=field_for(int(cfg_like.field.p)),
    )
