"""FibonacciSq, the STARK 101 statement: a[0] = 1, a[1] = s,
a[i] = a[i-2]² + a[i-1]², with public a[0] and a[trace_len − 1]
(Crocodoctopus/zkstark src/prover.rs:32-39, proof.rs:63-77).

The secret enters only through its square, so s and p − s are two
witnesses of one public output: a run's proofs alternate them.
"""

import numpy as np

from proofbench.yardstick.statement import draw_secret


def trace(trace_len: int, secret: int, p: int) -> np.ndarray:
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


def witnesses(seed: int, cfg: dict) -> list:
    """s from the seed, then p − s, with the one output they share."""
    p, s = int(cfg["field_p"]), draw_secret(seed, int(cfg["field_p"]))
    publics = {"boundary_first": int(cfg["boundary_first"]),
               "boundary_last": int(trace(int(cfg["trace_len"]), s, p)[-1])}
    return [(s, publics), (p - s, publics)]


def constraints(st, publics: dict) -> tuple:
    """a[0] and a[trace_len − 1] pinned; the recurrence on every step but
    the last three of the trace group."""
    n, p = st.trace_domain, st.p

    def num(fld, f):
        return (f[2] - fld.mul(f[1], f[1]) - fld.mul(f[0], f[0])) % p

    return [("boundary", (0, publics["boundary_first"])),
            ("boundary", (st.trace_len - 1, publics["boundary_last"])),
            ("transition", (num, (n - 3, n - 2, n - 1)))], (0, 1, 2)


def fri_rounds(trace_domain: int) -> int:
    """A quadratic transition keeps the composition under degree n: log2 n
    folds reach degree 0 (prover.rs:198, 10 at n = 1024)."""
    return trace_domain.bit_length() - 1
