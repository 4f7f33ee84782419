"""The constraint composition on Hopper (CUDA kernel I, ``csrc/composition.cu``).

`composition` replaces the body of ``zkstark_tpu/protocol/prover.py``
``composition_eval`` and the `from_mont` that follows it, which XLA fused
into one elementwise pass on the TPU and which as plain tensor ops are a few
hundred launches over int64 temporaries of the whole domain. For each of B
proofs and each point j of the evaluation domain, one pass computes

    cp[j] = Σ_c α_c · num_c(f(x_j), f(g·x_j), …, x_j) · inv_den_c[j]

and writes two outputs: `cp_eval` (Montgomery) and `cp_res` (standard
residues, one more REDC on the register). The constraint system is a small
device program (`Program`), the postfix form that ``air.numerator_program``
hands to the C++ verifier, with its arguments made ready for the device:

    [n_constraints] then per constraint
      boundary:   [0, to_mont(value)]                     num = f(x) − value
      transition: [1, n_ops, (op, arg)…]                  num = the program's result
        OP_F arg = (shift·blowup) mod d: f(g^k·x_j) is f_eval[(j + arg) mod d];
        with w > 1 columns, arg = c·d + (shift·blowup) mod d: column c;
        OP_CONST arg = to_mont(constant); OP_X reads x_j = offset·h^j, taken
        from the two small cached tables of a `ntt_kernel.GeoScale` (no vector
        of the domain is kept for it); OP_ADD, OP_SUB, OP_MUL pop two, push one.

A trace of `Program.width` = w > 1 columns is (…, w, d), each proof's
columns one after the other, and the results are (…, d); a boundary on a
column c > 0 is encoded as the transition program f_c − value, which is the
same arithmetic. Such a program takes no halo: the sharded prover proves
traces of one column.

A shard of the sharded prover passes its block of `len` points from domain
index `start` on, and the first words of the next shard's block as `halo`:
f(g^k·x_j) is then read from the block or the halo, never wrapped, and x_j
and the inverse denominators are taken at start + i.

Every thread of the kernel interprets the same program (one branch for all),
with a stack of `MAX_DEPTH` words per point. The kernel is bound by bytes (4
read for f, 4 per constraint for the inverse denominators, 8 written, a
point); every operand must be a reduced residue. On a CPU tensor `composition`
runs `composition_plain`, on a CUDA tensor only the kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build, ntt_kernel, tables

# opcodes of air.numerator_program and of native/zkstark_native.cpp
OP_F, OP_X, OP_CONST, OP_ADD, OP_SUB, OP_MUL = range(6)
MAX_DEPTH = 8  # the kernel's stack, words per point

composition_launches = 0  # launches of composition_kernel, counted by composition


@dataclass(frozen=True)
class Program:
    """A constraint system ready for the device (hashable: a cache key).
    `words` is the encoding of the module docstring; `generator` and `offset`
    (standard form) give the domain x_j = offset·generator^j of size `domain`."""

    words: tuple
    n_constraints: int
    domain: int
    generator: int
    offset: int
    width: int = 1

    def constraints(self):
        """[(0, value_mont) | (1, [(op, arg), …]), …] decoded from `words`."""
        w, out, i = self.words, [], 1
        for _ in range(w[0]):
            if w[i] == 0:
                out.append((0, w[i + 1]))
                i += 2
            else:
                n = w[i + 1]
                out.append((1, [(w[i + 2 + 2 * o], w[i + 3 + 2 * o]) for o in range(n)]))
                i += 2 + 2 * n
        return out

    @property
    def shifts_by_4(self) -> bool:
        """Every OP_F argument is a multiple of 4: four neighbouring points
        read four neighbouring words at every shift (16-byte accesses)."""
        return all(arg % 4 == 0 for arg in _f_args(self))

    @property
    def reach(self) -> int:
        """The largest shift of an OP_F argument: how far past a point its
        reads go."""
        return max((arg % self.domain for arg in _f_args(self)), default=0)

    @property
    def field_ops(self) -> tuple[int, int, int]:
        """(products, adds, subtracts) per point, the final `from_mont` not
        counted: the programs' own, two products per constraint (the inverse
        denominator, alpha), the x_j of each OP_X (two products) and the
        running sum."""
        mul = add = sub = 0
        for kind, body in self.constraints():
            mul, add = mul + 2, add + 1
            if kind == 0:
                sub += 1
                continue
            for op, _ in body:
                mul += (op == OP_MUL) + 2 * (op == OP_X)
                add += op == OP_ADD
                sub += op == OP_SUB
        return mul, add, sub


@functools.lru_cache(maxsize=64)
def _f_args(prog: Program) -> tuple:
    """Every OP_F argument of the program (decoded once a program)."""
    return tuple(arg for kind, body in prog.constraints() if kind for op, arg in body if op == OP_F)


def encode(constraints, shifts, blowup: int, domain: int, generator: int, offset: int,
           field: Field = FIELD101, width: int = 1) -> Program:
    """`constraints`: ("boundary", value) on column 0, ("boundary", (value,
    column)), or ("transition", postfix program of ``air.numerator_program``:
    OP_F takes column·len(shifts) + an index into `shifts`, OP_CONST a
    standard residue), over a trace of `width` columns. Raises ValueError for
    a program whose stack does not fit `MAX_DEPTH` or does not end with one
    value."""
    if width > 1 and (domain & (domain - 1) or width * domain > 1 << 32):
        raise ValueError(f"composition: {width} columns of {domain} points")
    words = [len(constraints)]
    for kind, body in constraints:
        if kind == "boundary":
            value, column = body if isinstance(body, tuple) else (body, 0)
            if not 0 <= column < width:
                raise ValueError(f"composition: a boundary on column {column} of {width}")
            if column == 0:
                words += [0, field.mont_scalar(value)]
                continue
            body = [(OP_F, column * len(shifts) + shifts.index(0)), (OP_CONST, value), (OP_SUB, 0)]
        depth, ops = 0, []
        for op, arg in body:
            if op == OP_F:
                column, k = divmod(arg, len(shifts))
                if column >= width:
                    raise ValueError(f"composition: a read of column {column} of {width}")
                arg = column * domain + shifts[k] * blowup % domain
            elif op == OP_CONST:
                arg = field.mont_scalar(arg)
            elif op not in (OP_X, OP_ADD, OP_SUB, OP_MUL):
                raise ValueError(f"composition: unknown opcode {op}")
            depth += 1 if op in (OP_F, OP_X, OP_CONST) else -1
            if depth < 1 or depth > MAX_DEPTH:
                raise ValueError(f"composition: the program's stack leaves [1, {MAX_DEPTH}]")
            ops += [op, arg]
        if depth != 1:
            raise ValueError("composition: the program does not end with one value")
        words += [1, len(body), *ops]
    return Program(tuple(int(w) for w in words), len(constraints), domain, generator % field.p,
                   offset % field.p, width)


def _xs_plain(prog: Program, field: Field, device) -> torch.Tensor:
    """x_j for j < domain as (1, domain) int64 Montgomery words, from the
    tables the kernel reads."""
    geo = ntt_kernel.GeoScale(prog.generator, prog.domain)
    powers = ntt_kernel._geo_factor_plain(geo, 1, prog.domain, field, device)
    return fp.mont_mul_w(field, powers, field.mont_scalar(prog.offset))


def composition_plain(f_eval, inv_dens, alphas, prog: Program, field: Field = FIELD101, *,
                      halo=None, start: int = 0):
    """Plain-torch twin of the kernel, same arguments: the program
    interpreted with whole-tensor field ops, f(g^k·x) as a roll (or, with a
    halo, a slice of the block followed by its halo); column c of a wide
    trace's (…, w, d) at c."""
    f = fp.wide(f_eval)
    points = f.shape[-1]
    cols = [f] if prog.width == 1 else list(f.unbind(-2))
    f = cols[0]
    inv = fp.wide(inv_dens)[:, start : start + points]
    ext = None if halo is None else torch.cat([f, fp.wide(halo)], dim=-1)
    if isinstance(alphas, torch.Tensor):
        n = prog.n_constraints  # one row for all proofs, or one per proof
        shape = (n,) if alphas.numel() == n else f.shape[:-1] + (n,)
        alphas = [fp.wide(alphas).reshape(shape)[..., c : c + 1] for c in range(n)]
    acc = None
    for c, (kind, body) in enumerate(prog.constraints()):
        if kind == 0:
            num = fp.sub_w(field, f, body)
        else:
            stack = []
            for op, arg in body:
                if op == OP_F:
                    column, arg = divmod(arg, prog.domain)
                    stack.append(torch.roll(cols[column], -arg, dims=-1) if ext is None
                                 else ext[..., arg : arg + points])
                elif op == OP_X:
                    stack.append(_xs_plain(prog, field, f.device)[0, start : start + points])
                elif op == OP_CONST:
                    stack.append(arg)
                else:
                    b, a = stack.pop(), stack.pop()
                    fn = {OP_ADD: fp.add_w, OP_SUB: fp.sub_w, OP_MUL: fp.mont_mul_w}[op]
                    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
                        a = torch.full_like(f, a)  # two constants: no tensor to broadcast over
                    stack.append(fn(field, a, b))
            num = stack.pop()
            if not isinstance(num, torch.Tensor):
                num = torch.full_like(f, num)
        term = fp.mont_mul_w(field, fp.mont_mul_w(field, num, inv[c]), alphas[c])
        acc = term if acc is None else fp.add_w(field, acc, term)
    if acc is None:
        acc = torch.zeros_like(f)
    acc = acc.expand(f.shape)
    return fp.narrow(acc), fp.narrow(fp.redc_w(field, 0, acc))


@tables.device_table(16)
def _device_words(prog: Program, device: torch.device) -> torch.Tensor:
    """The program's words on `device`, uploaded once."""
    return fp.from_host(np.asarray(prog.words, dtype=np.uint32), device)


def _alpha_tensor(alphas, batch: int, n: int, device) -> torch.Tensor:
    """alphas as a contiguous (batch, n) uint32 device tensor; a list of
    Python ints (the host-synced path, which has just waited for them) is
    uploaded."""
    if isinstance(alphas, torch.Tensor):
        return fp.as_u32(fp.as_i32(alphas).reshape(-1, n).expand(batch, n).contiguous())
    row = fp.from_host(np.asarray([int(a) for a in alphas], dtype=np.uint32), device)
    return fp.as_u32(fp.as_i32(row).reshape(1, n).expand(batch, n).contiguous())


def composition(f_eval: torch.Tensor, inv_dens: torch.Tensor, alphas, prog: Program,
                field: Field = FIELD101, *, halo: torch.Tensor | None = None, start: int = 0,
                res_out: torch.Tensor | None = None):
    """f_eval (…, d) uint32 Montgomery residues, the leading axes independent
    proofs, or (…, w, d) for a program of w > 1 columns; inv_dens
    (n_constraints, d) the inverse denominators; alphas
    Montgomery-form ints, one per constraint, or a (…, n_constraints) uint32
    tensor on f_eval's device. Returns (cp_eval, cp_res), each (…, d), the
    residues written into `res_out` where given (the tree's values at the
    head of its one allocation: `hash.merkle.tree_values`).

    A shard: f_eval (…, len) holds points start … start + len − 1 and `halo`
    (…, hlen) the words that follow them cyclically, hlen at least the
    largest shift·blowup; the results are (…, len)."""
    global composition_launches
    d, n = prog.domain, prog.n_constraints
    points = f_eval.shape[-1] if f_eval.dim() else 0
    if f_eval.dtype != torch.uint32 or f_eval.dim() < 1 or (halo is None and points != d):
        raise TypeError(f"composition: needs a (…, {d}) uint32 tensor, got {f_eval.dtype} "
                        f"{tuple(f_eval.shape)}")
    if prog.width > 1 and (halo is not None or f_eval.dim() < 2
                           or f_eval.shape[-2] != prog.width):
        raise ValueError(f"composition: a program of {prog.width} columns needs a "
                         f"(…, {prog.width}, {d}) tensor and no halo, got {tuple(f_eval.shape)}")
    if halo is not None and (
        halo.dtype != torch.uint32 or halo.shape[:-1] != f_eval.shape[:-1]
        or halo.device != f_eval.device or halo.shape[-1] < prog.reach
        or not 0 <= start <= d - points or not halo.is_contiguous()
    ):
        raise ValueError(f"composition: a shard of {points} points from {start} needs a uint32 "
                         f"halo of at least {prog.reach} words a row on its device")
    if (inv_dens.dtype != torch.uint32 or tuple(inv_dens.shape) != (n, d)
            or inv_dens.device != f_eval.device):
        raise ValueError(f"composition: inverse denominators must be ({n}, {d}) uint32 on the "
                         "evaluations' device")
    lead = f_eval.shape[:-1] if prog.width == 1 else f_eval.shape[:-2]
    batch = f_eval.numel() // max(points * prog.width, 1)
    if isinstance(alphas, torch.Tensor):
        if (alphas.dtype != torch.uint32 or alphas.device != f_eval.device
                or alphas.shape[-1] != n or alphas.numel() not in (n, batch * n)):
            raise ValueError("composition: alphas must hold one uint32 per constraint (and "
                             "proof) on the evaluations' device")
    elif len(alphas) != n:
        raise ValueError(f"composition: {len(alphas)} alphas for {n} constraints")
    res = _build.out_tensor(res_out, tuple(lead) + (points,), f_eval, "composition")
    if f_eval.device.type == "cpu":
        cp, plain = composition_plain(f_eval, inv_dens, alphas, prog, field, halo=halo,
                                      start=start)
        return cp, res.copy_(plain)
    _build.require(f_eval, "composition", f_eval.dim())
    _build.require(inv_dens, "composition", 2)
    if batch > 65535:
        raise ValueError(f"composition: {batch} proofs in one call (at most 65535)")
    dev = f_eval.device
    cp = torch.empty(tuple(lead) + (points,), dtype=torch.uint32, device=dev)
    if batch:
        words = _device_words(prog, dev)
        ga, gb, shift = ntt_kernel._geo_tables(prog.generator, d, field, dev)
        alpha_t = _alpha_tensor(alphas, batch, n, dev)
        with torch.cuda.device(dev):
            rc = _build.kernels().zk_composition(
                f_eval.data_ptr(),
                None if halo is None else halo.data_ptr(),
                0 if halo is None else halo.shape[-1],
                inv_dens.data_ptr(),
                alpha_t.data_ptr(),
                words.data_ptr(),
                len(prog.words),
                int(prog.shifts_by_4),
                ga.data_ptr(),
                gb.data_ptr(),
                shift,
                field.mont_scalar(prog.offset),
                cp.data_ptr(),
                res.data_ptr(),
                batch,
                points,
                start,
                d,
                field.p,
                field.p_inv_neg,
                prog.width,
                _build.stream(f_eval),
            )
        _build.check(rc, "composition")
        composition_launches += 1
    return cp, res
