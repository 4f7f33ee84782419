"""Winterfell's `do_work`: a[0] = a public start, a[i] = a[i-1]³ + 42, with
public a[0] and a[trace_len − 1] (facebook/winterfell README, "Usage":
`do_work` and `WorkAir`, one transition constraint of degree 3).

The start is public, so each witness states its own output: a run's cycle
is two starts drawn from the seed, each with its own public values.
"""

import random

import numpy as np

ROUND_CONSTANT = 42


def trace(trace_len: int, secret: int, p: int) -> np.ndarray:
    """a[0] = the start, a[i] = a[i-1]³ + 42."""
    a = np.empty(trace_len, dtype=np.uint32)
    x = secret % p
    a[0] = x
    for i in range(1, trace_len):
        x = (pow(x, 3, p) + ROUND_CONSTANT) % p
        a[i] = x
    return a


def witnesses(seed: int, cfg: dict) -> list:
    """Two distinct starts uniform in [1, p − 1] from the seed, each the
    witness and the public first value of its own statement."""
    p, n = int(cfg["field_p"]), int(cfg["trace_len"])
    rng = random.Random(int(seed))
    starts = [rng.randrange(1, p)]
    while len(starts) < 2:
        s = rng.randrange(1, p)
        if s != starts[0]:
            starts.append(s)
    return [(s, {"boundary_first": s, "boundary_last": int(trace(n, s, p)[-1])})
            for s in starts]


def constraints(st, publics: dict) -> tuple:
    """a[0] and a[trace_len − 1] pinned; the step on every row but the last
    two of the trace group (the last row holds no state)."""
    n, p = st.trace_domain, st.p

    def num(fld, f):
        return (f[1] - fld.mul(fld.mul(f[0], f[0]), f[0]) - ROUND_CONSTANT) % p

    return [("boundary", (0, publics["boundary_first"])),
            ("boundary", (st.trace_len - 1, publics["boundary_last"])),
            ("transition", (num, (n - 2, n - 1)))], (0, 1)


def fri_rounds(trace_domain: int) -> int:
    """The trace polynomial f has degree n − 2 (n = trace_domain). The
    numerator f(gx) − f(x)³ − 42 has degree 3(n − 2); the vanishing
    polynomial of the n − 2 constrained steps has degree n − 2; so the
    quotient has degree 2(n − 2), and the boundary quotients less. That is
    under 2n, and log2(2n) folds reach degree 0 (log2 n would stop at
    degree 1)."""
    return (2 * trace_domain).bit_length() - 1
