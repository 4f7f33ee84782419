"""The square chain: a[0] = s, a[i] = a[i-1]² + C, with public
a[trace_len − 1] (the port's and the JAX package's third statement).

The secret enters only through its square, so s and p − s are two
witnesses of one public output: a run's proofs alternate them.
"""

import numpy as np

from proofbench.yardstick.statement import draw_secret

SQUARE_CHAIN_C = 1234567891  # the round constant


def trace(trace_len: int, secret: int, p: int) -> np.ndarray:
    """a[0] = s, a[i] = a[i-1]² + C."""
    a = np.empty(trace_len, dtype=np.uint32)
    cur = secret % p
    a[0] = cur
    for i in range(1, trace_len):
        cur = (cur * cur + SQUARE_CHAIN_C) % p
        a[i] = cur
    return a


def witnesses(seed: int, cfg: dict) -> list:
    """s from the seed, then p − s, with the one output they share."""
    p, s = int(cfg["field_p"]), draw_secret(seed, int(cfg["field_p"]))
    publics = {"boundary_first": int(cfg["boundary_first"]),
               "boundary_last": int(trace(int(cfg["trace_len"]), s, p)[-1])}
    return [(s, publics), (p - s, publics)]


def constraints(st, publics: dict) -> tuple:
    """a[trace_len − 1] pinned; the recurrence on every step but the last
    two of the trace group."""
    n, p = st.trace_domain, st.p

    def num(fld, f):
        return (f[1] - fld.mul(f[0], f[0]) - SQUARE_CHAIN_C) % p

    return [("boundary", (st.trace_len - 1, publics["boundary_last"])),
            ("transition", (num, (n - 2, n - 1)))], (0, 1)


def fri_rounds(trace_domain: int) -> int:
    """A quadratic transition keeps the composition under degree n: log2 n
    folds reach degree 0."""
    return trace_domain.bit_length() - 1
