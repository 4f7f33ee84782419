"""The statements a cell proves, made from `--seed`: the benchmark's own copy
of each AIR's recurrence, so that no change to the program can move what is
proved.

A statement file (``configs/<name>.json``) fixes the AIR, the trace length,
the blowup, the coset offset, the query count and the field. The seed draws
one secret s, uniform in [1, p − 1]; the public output `boundary_last` is the
last row of s's trace. Both AIRs read the secret only through its square, so
s and p − s are the two witnesses of that output: a run's proofs alternate
them, and consecutive proofs differ in their trace rows, roots, challenges
and openings.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

SQUARE_CHAIN_C = 1234567891  # the square chain's round constant


def _fibonacci_sq(trace_len: int, secret: int, p: int) -> np.ndarray:
    """a[0] = 1, a[1] = s, a[i] = a[i-2]² + a[i-1]²."""
    a = np.empty(trace_len, dtype=np.uint32)
    prev2, prev1 = 1, secret % p
    a[0] = prev2
    if trace_len > 1:
        a[1] = prev1
    for i in range(2, trace_len):
        prev2, prev1 = prev1, (prev2 * prev2 + prev1 * prev1) % p
        a[i] = prev1
    return a


def _square_chain(trace_len: int, secret: int, p: int) -> np.ndarray:
    """a[0] = s, a[i] = a[i-1]² + C."""
    a = np.empty(trace_len, dtype=np.uint32)
    cur = secret % p
    a[0] = cur
    for i in range(1, trace_len):
        cur = (cur * cur + SQUARE_CHAIN_C) % p
        a[i] = cur
    return a


TRACES = {"fibonacci-sq": _fibonacci_sq, "square-chain": _square_chain}


def trace(air: str, trace_len: int, secret: int, p: int) -> np.ndarray:
    """The witness rows of `air` (uint32 residues)."""
    return TRACES[air](trace_len, secret, p)


@dataclass(frozen=True)
class Statement:
    """One statement: the file's fields, the public output and the two
    witnesses the seed gives."""

    name: str
    air: str
    trace_len: int
    blowup: int
    coset_offset: int
    n_queries: int
    p: int
    generator: int
    boundary_first: int
    boundary_last: int
    secret: int

    @property
    def trace_domain(self) -> int:
        return self.trace_len + 1

    @property
    def eval_domain(self) -> int:
        return self.trace_domain * self.blowup

    @property
    def fri_rounds(self) -> int:
        return self.trace_domain.bit_length() - 1

    def witness(self, k: int) -> int:
        """The secret of a run's proof k: s for even k, p − s for odd."""
        return self.secret if k % 2 == 0 else self.p - self.secret


def load_config(name: str) -> dict:
    """A statement file by its name in BENCHMARK.json."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def draw_secret(seed: int, p: int) -> int:
    """s, uniform in [1, p − 1], from any whole seed."""
    return random.Random(int(seed)).randrange(1, p)


def make(name: str, cfg: dict, seed: int) -> Statement:
    """The statement of `cfg` (a statement file's dict) for `seed`."""
    p = int(cfg["field_p"])
    s = draw_secret(seed, p)
    last = int(trace(cfg["air"], int(cfg["trace_len"]), s, p)[-1])
    return Statement(
        name=name, air=cfg["air"], trace_len=int(cfg["trace_len"]),
        blowup=int(cfg["blowup"]), coset_offset=int(cfg["coset_offset"]),
        n_queries=int(cfg["n_queries"]), p=p, generator=int(cfg["field_generator"]),
        boundary_first=int(cfg["boundary_first"]), boundary_last=last, secret=s,
    )
