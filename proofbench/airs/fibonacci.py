"""Additive Fibonacci: a[0] = 1, a[1] = s, a[i] = a[i-2] + a[i-1], with
public a[0] and a[trace_len − 1] (the port's third AIR).

The recurrence is linear in s, so no two secrets share an output: each
witness of a run's cycle, s and p − s, states its own `boundary_last`.
"""

import numpy as np

from proofbench.yardstick.statement import draw_secret


def trace(trace_len: int, secret: int, p: int) -> np.ndarray:
    """a[0] = 1, a[1] = s, a[i] = a[i-2] + a[i-1]."""
    a = np.empty(trace_len, dtype=np.uint32)
    prev2, prev1 = 1, secret % p
    a[0] = prev2
    if trace_len > 1:
        a[1] = prev1
    for i in range(2, trace_len):
        prev2, prev1 = prev1, (prev2 + prev1) % p
        a[i] = prev1
    return a


def witnesses(seed: int, cfg: dict) -> list:
    """s from the seed, then p − s, each with its own output."""
    p, s = int(cfg["field_p"]), draw_secret(seed, int(cfg["field_p"]))
    n, first = int(cfg["trace_len"]), int(cfg["boundary_first"])
    return [(w, {"boundary_first": first, "boundary_last": int(trace(n, w, p)[-1])})
            for w in (s, p - s)]


def constraints(st, publics: dict) -> tuple:
    """a[0] and a[trace_len − 1] pinned; the recurrence on every step but
    the last three of the trace group."""
    n, p = st.trace_domain, st.p

    def num(fld, f):
        return (f[2] - f[1] - f[0]) % p

    return [("boundary", (0, publics["boundary_first"])),
            ("boundary", (st.trace_len - 1, publics["boundary_last"])),
            ("transition", (num, (n - 3, n - 2, n - 1)))], (0, 1, 2)


def fri_rounds(trace_domain: int) -> int:
    """A linear transition keeps the composition under degree n: log2 n
    folds reach degree 0."""
    return trace_domain.bit_length() - 1
