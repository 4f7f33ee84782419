"""Winterfell's `mulfib8`: the multiplicative Fibonacci sequence in 8
registers s0…s7 a row (facebook/winterfell, examples/src/fibonacci/mulfib8:
air.rs, prover.rs). Row 0 is s0 = 1, s1 = b, s_j = s_{j−2}·s_{j−1} for j ≥ 2;
each next row continues the sequence (8 transition constraints of degree 2,
each reading the current and the next row):

    s0' = s6·s7,  s1' = s7·s0',  s_j' = s_{j−2}'·s_{j−1}'  (j = 2…7)

so cell (i, j) is b^F(8i + j) with F(0) = 0, F(1) = 1, and b = 2 gives the
source's first row 1, 2, 2, 4, 8, 32, 256, 8192. Assertions, in the
source's order: s0[0] = 1, s1[0] = b and s6 at the last row, the result.

Departures from the source:
* b, the witness, is drawn from the seed where the source fixes 2; it is the
  statement's public `boundary_first`, and s6 at the last row its
  `boundary_last`;
* the result is the value of register s6 at the last row, the register and
  step the source's last assertion names; here it is taken from the rows,
  b^F(8(n − 2) + 6), and not from a closed form of the sequence;
* n − 1 rows on an n-point trace group, the port's one convention for every
  statement, where the source fills all n rows;
* the field p = 3·2^30 + 1 with no extension, SHA-256 Merkle trees and
  Fiat-Shamir channel, and FRI by 2 down to a constant, as
  ``configs/winterfell_work.json`` lists them for the Winterfell statements.
"""

import random

import numpy as np

WIDTH = 8


def trace(trace_len: int, secret: int, p: int) -> np.ndarray:
    """(trace_len, 8) rows: row 0 by the in-row rule from s0 = 1, s1 = b,
    each next row by the transitions."""
    rows = np.empty((trace_len, WIDTH), dtype=np.uint32)
    s = [1, secret % p]
    for j in range(2, WIDTH):
        s.append(s[j - 2] * s[j - 1] % p)
    for i in range(trace_len):
        rows[i] = s
        nxt = [s[6] * s[7] % p]
        nxt.append(s[7] * nxt[0] % p)
        for j in range(2, WIDTH):
            nxt.append(nxt[j - 2] * nxt[j - 1] % p)
        s = nxt
    return rows


def witnesses(seed: int, cfg: dict) -> list:
    """Two distinct b uniform in [2, p − 1] from the seed, each the witness
    and the public s1[0] of its own statement, with its own s6 at the last
    row."""
    p, n = int(cfg["field_p"]), int(cfg["trace_len"])
    rng = random.Random(int(seed))
    starts = [rng.randrange(2, p)]
    while len(starts) < 2:
        b = rng.randrange(2, p)
        if b != starts[0]:
            starts.append(b)
    return [(b, {"boundary_first": b, "boundary_last": int(trace(n, b, p)[-1, 6])})
            for b in starts]


def constraints(st, publics: dict) -> tuple:
    """s0[0] = 1, s1[0] = b, s6[trace_len − 1] = the result; the 8
    transitions on every row but the last two of the trace group (the last
    row holds no state)."""
    n, p = st.trace_domain, st.p

    def transition(j):
        def num(fld, f):
            cur, nxt = f[0], f[1]
            if j == 0:
                a, b = cur[6], cur[7]
            elif j == 1:
                a, b = cur[7], nxt[0]
            else:
                a, b = nxt[j - 2], nxt[j - 1]
            return (nxt[j] - fld.mul(a, b)) % p
        return "transition", (num, (n - 2, n - 1))

    return [("boundary", (0, 1, 0)),
            ("boundary", (0, publics["boundary_first"], 1)),
            ("boundary", (st.trace_len - 1, publics["boundary_last"], 6)),
            *(transition(j) for j in range(WIDTH))], (0, 1)


def fri_rounds(trace_domain: int) -> int:
    """A degree-2 transition keeps the composition under degree n: log2 n
    folds reach degree 0."""
    return trace_domain.bit_length() - 1
