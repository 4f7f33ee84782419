"""The card's roofline: the published peaks of one NVIDIA H100 SXM and the
fewest operations each kernel's arithmetic needs, as the bounds take them.

`bound` gives the least time the card could take for some work: the larger
of its bytes over the memory rate and its operations over the peak rate of
their type. ``chip_smoke.py`` holds every kernel against these bounds, and
``tools.bench`` its NTT throughput, so both read one count of the same work.
"""

from __future__ import annotations

# The card's published peaks (NVIDIA H100 SXM data sheet) that the bounds are
# taken against: device memory rate, and integer ops per second as
# half the float32 lanes (67 TFLOP/s is 2 flops on 128 lanes per SM; an SM
# has 64 INT32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4
# Dense INT8 rate of the tensor cores, same data sheet: 1,979 TOP/s, an
# operation being a multiply or an add, so half as many multiply-adds.
INT8_OPS_PER_S = 1979e12
# The fewest integer ops (machine ops, one issue slot each) the arithmetic needs (loads, stores and
# addressing not counted), as the bounds take them:
#  * a Montgomery product of reduced residues 6 (a wide multiply, a low
#    multiply, a high multiply, a subtract, a compare, a conditional add), a
#    modular add 4, a modular subtract 3 (csrc/fp.cuh): 13 a butterfly;
#  * a SHA-256 round 14 (two Σ of 3 rotates and one 3-input xor, Ch, Maj,
#    4 three-input adds), a schedule step 10 (two σ of 4, two three-input
#    adds), 8 adds to feed forward. A parent hashes one full block and the
#    constant padding block, whose schedule costs nothing. A leaf hashes one
#    block whose words 1..15 are constants: round 0 runs on constant state
#    (3 instead of 14), and its 48 schedule steps fold to 370 ops
#    (steps 16..30 to 52, every other step from 32 to 36 to 6, the rest 10).
FP_MUL, FP_ADD, FP_SUB = 6, 4, 3
SHA_ROUNDS = 64 * 14 + 8
SHA_NODE = (SHA_ROUNDS + 48 * 10) + SHA_ROUNDS
SHA_LEAF = SHA_ROUNDS - 11 + 370
#  * one compression of a full block: the rounds and 48 schedule steps; a
#    digest commit of the channel is that and the constant padding block, a
#    u32 commit or a draw one full block;
#  * an output of the FRI fold: 1/x_j from its two table words (a product),
#    (a + b)/2 (an add, a product), β·(a − b)/(2x) (a subtract, two products),
#    their sum, and the REDC of from_mont (5): 4 products, 2 adds, 1 subtract.
#  * an output of a limb-DFT stage, outside the tensor cores: three 64-bit
#    shift-adds of the limb sums (two ops each), the REDC (5) and, in the first
#    stage, the in-row twiddle (a product);
#  * a point of the composition: the field ops of its program (counted by
#    `ops.composition.Program.field_ops`) and the REDC of from_mont (5).
SHA_BLOCK = SHA_ROUNDS + 48 * 10
FOLD_OPS = 4 * FP_MUL + 2 * FP_ADD + FP_SUB + 5
LIMB_RECOMBINE = 6 + 5


def bound(nbytes: float, instr: float, int8_macs: float = 0.0) -> dict:
    """The least milliseconds the card could take to move `nbytes` (each
    input read once, each output written once), to execute `instr` integer
    ops and to do `int8_macs` u8 multiply-adds on the tensor cores, and
    whether the bytes or the operations (of either type) set it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(instr / INT32_INSTR_PER_S, 2 * int8_macs / INT8_OPS_PER_S) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def ntt_rows_work(batch, valid, m, pre=False, uv=False, post=False, scale=False) -> tuple:
    """(bytes, integer ops) of one `ntt_rows` call: rows and tables read
    once, the result written once; (m/2)·log2(m) butterflies a row and the
    fused products."""
    log_m = m.bit_length() - 1
    words = batch * (valid + m) + (m - 1) + (batch // min(128, batch) + min(128, batch)) * m * uv
    muls = batch * (m // 2 * log_m + 2 * valid * pre + 2 * m * uv + 2 * m * post + m * scale)
    adds = batch * (m // 2 * log_m)
    return 4 * words, muls * FP_MUL + adds * (FP_ADD + FP_SUB)


def ntt_rows_bound(batch, valid, m, pre=False, uv=False, post=False, scale=False) -> dict:
    """Bound of one `ntt_rows` call (`ntt_rows_work`)."""
    return bound(*ntt_rows_work(batch, valid, m, pre, uv, post, scale))


def limb_rows_bound(batch, valid, m, pre=False, uv=False, post=False, scale=False) -> dict:
    """Bound of one `limb_dft_rows` call: rows, the in-row twiddle, the two
    limb matrices and the tables read once, the result written once; the
    multiply-adds of the two matrix products (the first contracts only the
    rows of the (k1, k2) view that hold input), and per output the
    recombination, the REDC and the fused products."""
    from zkstark_tpu_torch.ops import ntt_kernel

    k1, k2 = ntt_kernel.split(m)
    rows_in = -(-(-(-valid // k2)) // 8) * 8  # whole k-steps of 8
    words = (batch * (valid + m) + m + 4 * k1 * k1 + 4 * k2 * k2
             + (batch // min(128, batch) + min(128, batch)) * m * uv)
    macs = batch * (16 * k1 * rows_in * k2 + 16 * k2 * m)
    instr = batch * (m * (2 * LIMB_RECOMBINE + FP_MUL)
                     + FP_MUL * (2 * valid * pre + 2 * m * uv + 2 * m * post + m * scale))
    return bound(4 * words, instr, macs)


def fourstep_ops(n: int) -> int:
    """Integer ops of a forward four-step NTT of n points on the `ntt_rows`
    route: its two row passes, n2 rows of n1 with the U·V twiddle, then n1
    rows of n2 (`ops.ntt_kernel.ntt_fourstep`); the transposes do none."""
    from zkstark_tpu_torch.ops import ntt_kernel

    n1, n2 = ntt_kernel.split(n)
    return ntt_rows_work(n2, n1, n1, uv=True)[1] + ntt_rows_work(n1, n2, n2)[1]
