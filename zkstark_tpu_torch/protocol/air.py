"""AIR framework and the four concrete AIRs — counterpart of
``zkstark_tpu/protocol/air.py``, which has the first three.

An `Air` generates the witness trace and declares an ordered list of
constraints, `Boundary(step, value, column)` and `Transition(numerator,
exempt)`. One numerator definition runs in three modes: on Montgomery-form
tensors for the prover's composition (`device_ops`), on exact Python ints for
the verifier's point check (`host_ops`), and on a recorder that emits the RPN
program the C++ verifier interprets (`serialize_air`).

A trace has `Air.width` columns, w. A numerator reads f(k), the trace at
g^k·x: at w = 1 the value itself, at w > 1 a row of w values, f(k)[j] being
column j (`row`).

`interpolate_trace` replaces the reference's O(n³) Lagrange interpolation
(polynomial.rs:337-383) by one size-n INTT plus a rank-1 correction that
makes the degree-(n−1) coefficient vanish.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from zkstark_tpu_torch import ntt
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import elementwise
from zkstark_tpu_torch.protocol import witness


@dataclass(frozen=True)
class Boundary:
    """c(x) = (f(x)[column] − value) / (x − g^step) (reference c0/c1,
    prover.rs:101-113; column 0 of a trace of one)."""

    step: int
    value: int
    column: int = 0


@dataclass(frozen=True)
class Transition:
    """c(x) = numerator(ops, f, x) / Z(x), Z = (x^n − 1) / Π_{e ∈ exempt}
    (x − g^e) (reference c2, prover.rs:134-145). f(k) yields f(g^k·x)."""

    numerator: Callable
    exempt: tuple


class _DeviceOps:
    """Montgomery-form uint32 tensors, bound to one Field."""

    def __init__(self, field: Field):
        self.field = field
        self.mul = functools.partial(fp.mont_mul_f, field)
        self.add = functools.partial(fp.add_f, field)
        self.sub = functools.partial(fp.sub_f, field)

    def const(self, v: int) -> int:
        return self.field.mont_scalar(v)


class _HostOps:
    """Exact Python ints mod p (the verifier's point checks)."""

    def __init__(self, p: int):
        self.p = p

    def mul(self, a, b):
        return a * b % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def const(self, v: int):
        return v % self.p


@functools.lru_cache(maxsize=None)
def device_ops(field: Field = FIELD101) -> _DeviceOps:
    return _DeviceOps(field)


@functools.lru_cache(maxsize=None)
def host_ops(p: int = fp.P) -> _HostOps:
    return _HostOps(p)


# RPN opcodes shared with native/zkstark_native.cpp
OP_F, OP_X, OP_CONST, OP_ADD, OP_SUB, OP_MUL = range(6)


class _Node:
    __slots__ = ("op", "arg", "children")

    def __init__(self, op, arg=0, children=()):
        self.op = op
        self.arg = arg
        self.children = children


class RecorderOps:
    """Records a numerator as an expression tree for `numerator_program`."""

    def __init__(self, p: int = fp.P):
        self.p = p

    @staticmethod
    def mul(a, b):
        return _Node(OP_MUL, children=(a, b))

    @staticmethod
    def add(a, b):
        return _Node(OP_ADD, children=(a, b))

    @staticmethod
    def sub(a, b):
        return _Node(OP_SUB, children=(a, b))

    def const(self, v: int):
        return _Node(OP_CONST, v % self.p)


def row(read: Callable, width: int) -> Callable:
    """A numerator's f from `read(k, j)`, column j at shift k: f(k) is the
    value of column 0 at w = 1, else the row [read(k, 0), …, read(k, w − 1)]."""
    if width == 1:
        return lambda k: read(k, 0)
    return lambda k: [read(k, j) for j in range(width)]


def numerator_program(numerator: Callable, shifts: tuple, p: int = fp.P, width: int = 1) -> list:
    """[(op, arg), …] postfix encoding of a transition numerator. OP_F's
    argument is j·len(shifts) + the shift's index, column j at that shift:
    the index alone at w = 1 (and in column 0)."""
    f = row(lambda k, j: _Node(OP_F, j * len(shifts) + shifts.index(k)), width)
    root = numerator(RecorderOps(p), f, _Node(OP_X))
    prog = []

    def emit(node):
        for c in node.children:
            emit(c)
        prog.append((node.op, node.arg))

    emit(root)
    return prog


@dataclass(frozen=True)
class Air:
    """Witness generation plus an ordered constraint list. `width` is the
    trace's columns; `shifts` names the f(g^k·x) openings the constraints
    read; `degree` is the largest degree of a transition numerator in the
    trace values, which bounds the composition's degree and so sets the FRI
    rounds (``config.py`` `fri_rounds`). `recurrence` names the witness's
    loop in ``csrc/witness.cpp`` (``protocol/witness.py``), `constant` its
    round constant; None: the AIR has no witness."""

    width = 1
    shifts = (0,)
    name = "air"
    degree = 2
    recurrence = None
    constant = 0

    @property
    def max_shift(self) -> int:
        return max(self.shifts)

    def trace(self, trace_len: int, secret: int, p: int = fp.P) -> np.ndarray:
        """The witness from `secret`: trace_len canonical uint32 residues, or
        (width, trace_len) of them, one column a row, at w > 1."""
        return witness.traces(self, [secret], trace_len, fp.field_for(p), mont=False)[0][0]

    def constraints(self, cfg) -> tuple:
        raise NotImplementedError


def fibonacci_sq_trace(
    length: int = 1023, secret: int = 3141592, p: int = fp.P
) -> np.ndarray:
    """a[0]=1, a[1]=secret, a[i]=a[i-2]²+a[i-1]² over F_p (prover.rs:32-39)."""
    return FIBONACCI_SQ.trace(length, secret, p)


def _fib_sq_numerator(ops, f, x):
    """f(g²x) − f(gx)² − f(x)² (prover.rs:134-136)."""
    return ops.sub(ops.sub(f(2), ops.mul(f(1), f(1))), ops.mul(f(0), f(0)))


@dataclass(frozen=True)
class FibonacciSqAir(Air):
    """The reference statement: a[i] = a[i-1]² + a[i-2]² with public a[0]
    and a[trace_len−1] (prover.rs:32-39, proof.rs:63-77)."""

    shifts = (0, 1, 2)
    name = "fibonacci-sq"
    recurrence = witness.FIBONACCI_SQ

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, cfg.boundary_first),
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_fib_sq_numerator, (n - 3, n - 2, n - 1)),
        )


def _fib_numerator(ops, f, x):
    return ops.sub(ops.sub(f(2), f(1)), f(0))


@dataclass(frozen=True)
class FibonacciAir(Air):
    """Additive Fibonacci: a[i] = a[i-1] + a[i-2]."""

    shifts = (0, 1, 2)
    name = "fibonacci"
    degree = 1
    recurrence = witness.FIBONACCI

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, cfg.boundary_first),
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_fib_numerator, (n - 3, n - 2, n - 1)),
        )


SQUARE_CHAIN_C = 1234567891  # the round constant the JAX package pins


def _square_chain_numerator(ops, f, x):
    """f(gx) − f(x)² − C."""
    return ops.sub(ops.sub(f(1), ops.mul(f(0), f(0))), ops.const(SQUARE_CHAIN_C))


@dataclass(frozen=True)
class SquareChainAir(Air):
    """a[i] = a[i-1]² + C with the secret a[0] and public a[trace_len−1]."""

    shifts = (0, 1)
    name = "square-chain"
    recurrence = witness.SQUARE_CHAIN
    constant = SQUARE_CHAIN_C

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_square_chain_numerator, (n - 2, n - 1)),
        )


WORK_C = 42  # the round constant of Winterfell's `do_work`


def _work_numerator(ops, f, x):
    """f(gx) − f(x)³ − 42."""
    cube = ops.mul(ops.mul(f(0), f(0)), f(0))
    return ops.sub(ops.sub(f(1), cube), ops.const(WORK_C))


@dataclass(frozen=True)
class WinterfellWorkAir(Air):
    """Winterfell's `do_work` statement (facebook/winterfell README,
    "Usage", `WorkAir`): a[0] = the public start, a[i] = a[i-1]³ + 42, with
    public a[0] and a[trace_len−1]. The transition has degree 3, so the
    composition's degree is about 2n and FRI folds once more than for the
    quadratic AIRs."""

    shifts = (0, 1)
    name = "winterfell-work"
    degree = 3
    recurrence = witness.WORK
    constant = WORK_C

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, cfg.boundary_first),
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_work_numerator, (n - 2, n - 1)),
        )


MULFIB8_WIDTH = 8


def _mulfib8_numerator(j: int) -> Callable:
    """s_j' − a·b, where (a, b) = (s6, s7) for j = 0, (s7, s0') for j = 1 and
    (s_{j−2}', s_{j−1}') above: the next row follows from the current one."""

    def numerator(ops, f, x):
        cur, nxt = f(0), f(1)
        a, b = ((cur[6], cur[7]) if j == 0 else (cur[7], nxt[0]) if j == 1
                else (nxt[j - 2], nxt[j - 1]))
        return ops.sub(nxt[j], ops.mul(a, b))

    return numerator


_MULFIB8_NUMERATORS = tuple(_mulfib8_numerator(j) for j in range(MULFIB8_WIDTH))


@dataclass(frozen=True)
class WinterfellMulfib8Air(Air):
    """Winterfell's `mulfib8` (facebook/winterfell, examples/src/fibonacci/
    mulfib8: air.rs, prover.rs): the multiplicative Fibonacci sequence in 8
    registers a row. Row 0 is 1, b, s0·s1, …; each next row follows from
    s0' = s6·s7, s1' = s7·s0', s_j' = s_{j−2}'·s_{j−1}', 8 transitions of
    degree 2 across the row and the next. The assertions are s0[0] = 1,
    s1[0] = b (the public `boundary_first`) and s6 at the last row (the
    public `boundary_last`, the result)."""

    width = MULFIB8_WIDTH
    shifts = (0, 1)
    name = "winterfell-mulfib8"
    recurrence = witness.MULFIB8

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, 1, 0),
            Boundary(0, cfg.boundary_first, 1),
            Boundary(cfg.trace_len - 1, cfg.boundary_last, 6),
            *(Transition(num, (n - 2, n - 1)) for num in _MULFIB8_NUMERATORS),
        )


FIBONACCI_SQ = FibonacciSqAir()
FIBONACCI = FibonacciAir()
SQUARE_CHAIN = SquareChainAir()
WINTERFELL_WORK = WinterfellWorkAir()
WINTERFELL_MULFIB8 = WinterfellMulfib8Air()

AIRS = {a.name: a for a in (FIBONACCI_SQ, FIBONACCI, SQUARE_CHAIN, WINTERFELL_WORK,
                            WINTERFELL_MULFIB8)}


# The Python twins of the compiled witness loops (``csrc/witness.cpp``):
# the tests' reference, never on a prove path.


def _fibonacci_sq_trace_plain(length: int, secret: int, p: int) -> np.ndarray:
    a = np.empty(length, dtype=np.uint32)
    prev2, prev1 = 1, secret % p
    a[0] = prev2
    if length > 1:
        a[1] = prev1
    for i in range(2, length):
        cur = (prev2 * prev2 + prev1 * prev1) % p
        a[i] = cur
        prev2, prev1 = prev1, cur
    return a


def _fibonacci_trace_plain(length: int, secret: int, p: int) -> np.ndarray:
    a = np.empty(length, dtype=np.uint32)
    prev2, prev1 = 1, secret % p
    a[0] = prev2
    if length > 1:
        a[1] = prev1
    for i in range(2, length):
        cur = (prev2 + prev1) % p
        a[i] = cur
        prev2, prev1 = prev1, cur
    return a


def _square_chain_trace_plain(length: int, secret: int, p: int) -> np.ndarray:
    a = np.empty(length, dtype=np.uint32)
    cur = secret % p
    a[0] = cur
    for i in range(1, length):
        cur = (cur * cur + SQUARE_CHAIN_C) % p
        a[i] = cur
    return a


def _work_trace_plain(length: int, secret: int, p: int) -> np.ndarray:
    a = np.empty(length, dtype=np.uint32)
    cur = secret % p
    a[0] = cur
    for i in range(1, length):
        cur = (cur * cur % p * cur + WORK_C) % p
        a[i] = cur
    return a


def _mulfib8_trace_plain(length: int, secret: int, p: int) -> np.ndarray:
    """(8, length): column j of row i is s_j at row i."""
    a = np.empty((length, MULFIB8_WIDTH), dtype=np.uint32)
    s = [1, secret % p]
    for j in range(2, MULFIB8_WIDTH):
        s.append(s[j - 2] * s[j - 1] % p)
    for i in range(length):
        a[i] = s
        nxt = [s[6] * s[7] % p]
        nxt.append(s[7] * nxt[0] % p)
        for j in range(2, MULFIB8_WIDTH):
            nxt.append(nxt[j - 2] * nxt[j - 1] % p)
        s = nxt
    return np.ascontiguousarray(a.T)


_PLAIN_TRACES = {
    FIBONACCI_SQ.name: _fibonacci_sq_trace_plain,
    FIBONACCI.name: _fibonacci_trace_plain,
    SQUARE_CHAIN.name: _square_chain_trace_plain,
    WINTERFELL_WORK.name: _work_trace_plain,
    WINTERFELL_MULFIB8.name: _mulfib8_trace_plain,
}


def composition_at_point(cfg, x: int, f_vals: dict, alphas: list) -> int:
    """Σ αᵢ·cᵢ(x) with exact ints — the verifier's composition check value
    (proof.rs:63-77 generalised). f_vals maps shift k → opened f(g^k·x): the
    value at w = 1, the row of w values otherwise."""
    p = cfg.field.p
    g = cfg.trace_generator
    n = cfg.trace_domain
    width = cfg.air.width
    f = row(lambda k, j: (f_vals[k] if width == 1 else f_vals[k][j]) % p, width)

    def inv(a):
        return pow(a % p, p - 2, p)

    acc = 0
    for alpha, con in zip(alphas, cfg.constraints):
        if isinstance(con, Boundary):
            num = (f_vals[0] if width == 1 else f_vals[0][con.column]) - con.value
            num %= p
            den = (x - pow(g, con.step, p)) % p
        else:
            num = con.numerator(host_ops(p), f, x % p)
            z = (pow(x, n, p) - 1) % p
            for e in con.exempt:
                z = z * inv(x - pow(g, e, p)) % p
            den = z
        acc = (acc + alpha * num % p * inv(den)) % p
    return acc


def serialize_air(cfg) -> np.ndarray:
    """Flat uint32 blob of the constraint system for the C++ verifier:

    [n_shifts, shifts…, n_constraints] then per constraint:
      Boundary:   [0, step, value] on column 0, [2, step, value, column] on
                  another (the C++ verifier reads traces of one column)
      Transition: [1, n_exempt, exempt…, n_ops, (op, arg)…], OP_F's
                  argument that of `numerator_program`
    """
    shifts = cfg.air.shifts
    words = [len(shifts), *shifts, len(cfg.constraints)]
    for con in cfg.constraints:
        if isinstance(con, Boundary):
            value = con.value % cfg.field.p
            words += [0, con.step, value] if con.column == 0 else [2, con.step, value, con.column]
        else:
            prog = numerator_program(con.numerator, shifts, cfg.field.p, cfg.air.width)
            words += [1, len(con.exempt), *con.exempt, len(prog)]
            for op, arg in prog:
                words += [op, arg]
    return np.asarray(words, dtype=np.uint32)


def interpolate_trace(trace_mont: torch.Tensor, n: int, field: Field = FIELD101):
    """Coefficients (Montgomery form, natural order, degree ≤ n−2) of the
    unique polynomial through (g^i, trace[i]) for i < n−1 — the reference's
    lagrange() output (prover.rs:60-61), as one INTT of the n − 1 points (the
    missing point taken as 0, never allocated) plus the rank-1 endpoint fix
    (``ops/elementwise.py`` `endpoint_fix`, one launch on a card).
    trace_mont is uint32 with a last axis of length n−1; leading axes are
    independent traces."""
    assert trace_mont.shape[-1] == n - 1
    c0 = ntt.intt(trace_mont, ntt.inverse_plan(n, field))
    return elementwise.endpoint_fix(c0, field)
