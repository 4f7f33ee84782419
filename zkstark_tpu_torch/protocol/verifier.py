"""Proof verification — transcript replay + the reference's point checks.

Re-implements Proof::verify (proof.rs:15-149) with two deliberate upgrades
(SURVEY.md §3.3 quirks):
  (a) challenges (α, β, query) are re-derived by replaying the Fiat-Shamir
      hash chain and checked against the recorded bytes, instead of being
      trusted from the proof data — strictly stronger, still byte-compatible;
  (b) failures raise structured `VerificationError`s with context instead of
      panicking asserts (main.rs:26 notes the reference just panics).

The verifier is deliberately polynomial-free, exactly like the reference: it
checks the composition identity and FRI consistency at one point with ~dozens
of host-side exact field ops, plus 24 Merkle path recomputations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from zkstark_tpu_torch.hash.merkle import compute_root_from_path
from zkstark_tpu_torch.protocol import air
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.proof import Proof
from zkstark_tpu_torch.transcript import TranscriptError
from zkstark_tpu_torch.transcript.channel import ReplayChannel


class VerificationError(Exception):
    """Structured verification failure (check name + context)."""

    def __init__(self, check: str, detail: str):
        self.check = check
        self.detail = detail
        super().__init__(f"{check}: {detail}")


@dataclass
class VerifyReport:
    checks_passed: list = field(default_factory=list)

    def ok(self, name: str):
        self.checks_passed.append(name)


def verify(proof: Proof, cfg: StarkConfig = StarkConfig()) -> VerifyReport:
    report = VerifyReport()
    p = cfg.field.p
    _inv = lambda a: pow(a % p, p - 2, p)  # noqa: E731
    rounds = cfg.fri_rounds
    shifts = cfg.air.shifts
    try:
        ch = ReplayChannel(proof.data)

        # ---- transcript parse + challenge replay (proof.rs:16-46) ----
        f_root = ch.read_hash()
        alphas = [ch.expect_u32() for _ in range(cfg.n_constraints)]
        betas = [0]  # dummy slot 0, matching proof.rs:27
        roots = [ch.read_hash()]
        for _ in range(rounds):
            betas.append(ch.expect_u32())
            roots.append(ch.read_hash())
        free_term = ch.read_u32()
        # all query draws precede the openings (prover.rs:263 generalized)
        query_raws = [ch.expect_u32() for _ in range(cfg.n_queries)]
        width = cfg.air.width
        per_query = []
        for _ in range(cfg.n_queries):
            trace_open = [ch.read_opening() if width == 1 else ch.read_row_opening(width)
                          for _ in shifts] + [ch.read_opening()]
            fri_open = [ch.read_fri_opening() for _ in range(rounds)]
            per_query.append((trace_open, fri_open))
        if not ch.reader.exhausted:
            raise VerificationError(
                "transcript", f"{ch.reader.remaining} trailing bytes"
            )
        if ch.state != proof.state:
            raise VerificationError(
                "transcript",
                f"final state {ch.state.hex()} != recorded {proof.state.hex()}",
            )
        report.ok("transcript-replay")
    except TranscriptError as e:
        raise VerificationError("fiat-shamir", str(e)) from e
    except ValueError as e:
        raise VerificationError("transcript", str(e)) from e

    # ---- protocol constants (proof.rs:49-54) ----
    d = cfg.eval_domain
    h = cfg.domain_generator
    b = cfg.blowup
    inv2 = _inv(2)  # (p+1)/2

    for q, (query_raw, (trace_open, fri_open)) in enumerate(
        zip(query_raws, per_query)
    ):
        test_point = query_raw % cfg.query_range
        x = cfg.coset_offset * pow(h, test_point, p) % p

        # ---- composition identity at the query point (proof.rs:63-77),
        #      derived from the config's AIR — one constraint definition
        #      shared with the prover (protocol/air.py); a trace of w > 1
        #      columns opens rows ----
        f_vals = {k: trace_open[i][0] for i, k in enumerate(shifts)}
        cp0_x = trace_open[len(shifts)][0]
        cp0_calc = air.composition_at_point(cfg, x, f_vals, alphas)
        if cp0_calc != cp0_x % p:
            raise VerificationError(
                "composition",
                f"query {q}: cp0(x) = {cp0_x} but constraints give {cp0_calc}",
            )

        # ---- trace auth paths (proof.rs:80-95) ----
        for i, k in enumerate(shifts):
            val, path = trace_open[i]
            if compute_root_from_path(val, test_point + k * b, path) != f_root:
                raise VerificationError(
                    "merkle", f"query {q}: auth path for f(g^{k}x) does not match"
                )
        val, path = trace_open[len(shifts)]
        if compute_root_from_path(val, test_point, path) != roots[0]:
            raise VerificationError(
                "merkle", f"query {q}: auth path for cp0(x) does not match"
            )

        # ---- FRI consistency (proof.rs:101-126) ----
        for layer in range(rounds):
            cp_x, cp_nx, _, _ = fri_open[layer]
            xl = pow(x, 1 << layer, p)
            g_xx = (cp_x + cp_nx) * inv2 % p
            h_xx = (cp_x - cp_nx) * inv2 % p * _inv(xl) % p
            calc = (g_xx + betas[layer + 1] * h_xx) % p
            nxt = fri_open[layer + 1][0] if layer + 1 < rounds else free_term
            if nxt % p != calc:
                raise VerificationError(
                    "fri",
                    f"query {q}: layer {layer + 1} value {nxt} != folded {calc}",
                )

        # ---- FRI auth paths (proof.rs:129-148) ----
        for layer in range(rounds):
            size = d >> layer
            cp_x, cp_nx, path_x, path_nx = fri_open[layer]
            for val, idx, path in (
                (cp_x, test_point % size, path_x),
                (cp_nx, (test_point + size // 2) % size, path_nx),
            ):
                if compute_root_from_path(val, idx, path) != roots[layer]:
                    raise VerificationError(
                        "merkle",
                        f"query {q}: FRI layer {layer} path at index {idx} "
                        "does not match",
                    )

    report.ok("composition-identity")
    report.ok("trace-auth-paths")
    report.ok("fri-consistency")
    report.ok("fri-auth-paths")
    return report
