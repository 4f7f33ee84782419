"""The card's roofline and the work of one proof, counted from the
statement's sizes: the benchmark's frozen copy of the peaks and the SHA-256
and butterfly op counts, kept under ``proofbench/`` so that a change to the
program cannot move the yardstick.

A share of a roofline is the least time the card could take for the work
over the device time its kernels took. The work is counted from the
statement, not from the kernels that happen to run, so a change that fuses
or reorders the same work is held to the same count.
"""

from __future__ import annotations

# Published: NVIDIA H100 SXM data sheet, device memory rate.
HBM_BYTES_PER_S = 3.35e12
# ASSUMED, not published: no data sheet gives an integer rate. Taken as half
# the float32 rate (67 TFLOP/s is 2 flops on 128 lanes per SM; an SM has 64
# INT32 lanes), one integer machine op a lane a cycle.
INT32_INSTR_PER_S = 67e12 / 4

# The fewest integer machine ops the arithmetic needs (loads, stores and
# addressing not counted):
#  * a Montgomery product 6, a modular add 4, a modular subtract 3: 13 a
#    butterfly;
#  * a SHA-256 round 14, a schedule step 10 (two σ of 4, two 3-input adds),
#    8 adds to feed forward. A parent hashes one full block and the constant
#    padding block, whose schedule costs nothing. A leaf of one word hashes
#    one block whose words 1..15 are constants: round 0 runs on constant
#    state (3 instead of 14), and its 48 schedule steps fold to 370 ops
#    (`schedule_ops`).
FP_MUL, FP_ADD, FP_SUB = 6, 4, 3
BUTTERFLY = FP_MUL + FP_ADD + FP_SUB
SHA_ROUNDS = 64 * 14 + 8
SHA_SIGMA = 4
SHA_NODE = (SHA_ROUNDS + 48 * 10) + SHA_ROUNDS
SHA_LEAF = SHA_ROUNDS - 11 + 370


def schedule_ops(variable: int) -> int:
    """The ops of one block's 48 schedule steps when its first `variable`
    words vary and the rest are constants: each σ of a varying word costs
    4, and a step's varying terms and one folded constant are summed by
    3-input adds; a step of constants alone costs nothing (370 for 1 word,
    480 for 16)."""
    varies = [j < variable for j in range(16)]
    ops = 0
    for t in range(16, 64):
        terms = (varies[t - 15], varies[t - 2], varies[t - 16], varies[t - 7])
        n = sum(terms)
        if n:
            summands = n + (n < 4)
            ops += SHA_SIGMA * (terms[0] + terms[1]) + summands // 2
        varies.append(n > 0)
    return ops


def leaf_ops(width: int) -> int:
    """The ops of one leaf of `width` words: the message, the pad byte and
    the 8-byte length in as many blocks as they need; round 0 of the first
    block runs on constant state; a block of padding alone has a constant
    schedule (SHA_LEAF for one word)."""
    blocks = (4 * width + 8) // 64 + 1
    ops = -11
    for k in range(blocks):
        ops += SHA_ROUNDS + schedule_ops(max(0, min(16, width - 16 * k)))
    return ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds for `nbytes` moved (each input read once, each
    output written once) and `ops` integer ops."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_INSTR_PER_S)


def tree_sizes(st) -> list:
    """The leaves of every Merkle tree of one proof: the trace's and the
    composition's on the evaluation domain, then one a FRI round."""
    d = st.eval_domain
    return [d, d] + [d >> k for k in range(1, st.fri_rounds + 1)]


def merkle_work(st) -> tuple:
    """(bytes, ops) of every leaf and parent hash of one proof's trees: the
    values read once (a trace leaf is a row of w words), every digest
    written once."""
    nbytes = ops = 0
    for k, n in enumerate(tree_sizes(st)):
        width = st.width if k == 0 else 1
        nbytes += 4 * width * n + 32 * (2 * n - 1)
        ops += n * leaf_ops(width) + (n - 1) * SHA_NODE
    return nbytes, ops


def _log2(n: int) -> int:
    return n.bit_length() - 1


def lde_work(st) -> tuple:
    """(bytes, ops) of one proof's transforms, two a trace column: the
    inverse NTT of the n trace points (n/2·log2 n butterflies), and the
    coset NTT of the n coefficients onto n·blowup points, which needs no
    more than blowup n-point NTTs with their n coset products each. Inputs
    read once, outputs written once."""
    n, d, w = st.trace_domain, st.eval_domain, st.width
    intt = (4 * 2 * n, n // 2 * _log2(n) * BUTTERFLY)
    coset = (4 * (n + d), st.blowup * (n // 2 * _log2(n) * BUTTERFLY + n * FP_MUL))
    return w * (intt[0] + coset[0]), w * (intt[1] + coset[1])
