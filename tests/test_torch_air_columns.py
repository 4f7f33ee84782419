"""The AIR framework widened to traces of several columns (``protocol/air.py``).

  * at w = 1 nothing moved: `numerator_program`, `serialize_air` and the
    composition kernel's program (`prover.composition_program`) give the
    words they gave before columns existed, for the four AIRs of one column;
  * at w = 8 (`WinterfellMulfib8Air`) the three modes of one numerator agree
    at random points: Montgomery tensors (`device_ops`), exact ints
    (`host_ops`) and the recorded program, interpreted here, and so does the
    composition at a point (`composition_at_point`) with the plain
    composition over the whole coset;
  * OP_F's argument and a boundary's column in the encodings of a wide
    trace.
"""

import random

import pytest
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.protocol import air
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig

P = fp.FIELD101.p

# The words at trace_len 63, boundaries 5 and 7, before columns existed.
SERIALIZED = {
    "fibonacci-sq": [3, 0, 1, 2, 3, 0, 0, 5, 0, 62, 7, 1, 3, 61, 62, 63, 9, 0, 2, 0, 1, 0, 1, 5,
                     0, 4, 0, 0, 0, 0, 0, 5, 0, 4, 0],
    "fibonacci": [3, 0, 1, 2, 3, 0, 0, 5, 0, 62, 7, 1, 3, 61, 62, 63, 5, 0, 2, 0, 1, 4, 0, 0, 0,
                  4, 0],
    "square-chain": [2, 0, 1, 2, 0, 62, 7, 1, 2, 62, 63, 7, 0, 1, 0, 0, 0, 0, 5, 0, 4, 0, 2,
                     1234567891, 4, 0],
    "winterfell-work": [2, 0, 1, 3, 0, 0, 5, 0, 62, 7, 1, 2, 62, 63, 9, 0, 1, 0, 0, 0, 0, 5, 0,
                        0, 0, 5, 0, 4, 0, 2, 42, 4, 0],
}
PROGRAMS = {
    "fibonacci-sq": [(0, 2), (0, 1), (0, 1), (5, 0), (4, 0), (0, 0), (0, 0), (5, 0), (4, 0)],
    "fibonacci": [(0, 2), (0, 1), (4, 0), (0, 0), (4, 0)],
    "square-chain": [(0, 1), (0, 0), (0, 0), (5, 0), (4, 0), (2, 1234567891), (4, 0)],
    "winterfell-work": [(0, 1), (0, 0), (0, 0), (5, 0), (0, 0), (5, 0), (4, 0), (2, 42), (4, 0)],
}
DEVICE_WORDS = {
    "fibonacci-sq": [3, 0, 2147483642, 0, 1073741815, 1, 9, 0, 16, 0, 8, 0, 8, 5, 0, 4, 0, 0, 0,
                     0, 0, 5, 0, 4, 0],
    "fibonacci": [3, 0, 2147483642, 0, 1073741815, 1, 5, 0, 16, 0, 8, 4, 0, 0, 0, 4, 0],
    "square-chain": [2, 0, 1073741815, 1, 7, 0, 8, 0, 0, 0, 0, 5, 0, 4, 0, 2, 2648876776, 4, 0],
    "winterfell-work": [3, 0, 2147483642, 0, 1073741815, 1, 9, 0, 8, 0, 0, 0, 0, 5, 0, 0, 0, 5,
                        0, 4, 0, 2, 3221225417, 4, 0],
}


def cfg_of(name: str, trace_len: int = 63) -> StarkConfig:
    return StarkConfig(trace_len=trace_len, air=air.AIRS[name], boundary_first=5, boundary_last=7)


@pytest.mark.parametrize("name", sorted(SERIALIZED))
def test_one_column_words_did_not_move(name):
    cfg = cfg_of(name)
    assert cfg.air.width == 1
    assert air.serialize_air(cfg).tolist() == SERIALIZED[name]
    (con,) = [c for c in cfg.constraints if isinstance(c, air.Transition)]
    assert air.numerator_program(con.numerator, cfg.air.shifts, P) == PROGRAMS[name]
    prog = pr.composition_program(cfg)
    assert list(prog.words) == DEVICE_WORDS[name] and prog.width == 1


def _run_program(prog: list, shifts: tuple, width: int, rows: dict, x: int) -> int:
    """The recorded postfix program on exact ints: OP_F's argument is
    column·len(shifts) + the shift's index."""
    stack = []
    for op, arg in prog:
        if op == air.OP_F:
            col, k = divmod(arg, len(shifts))
            stack.append(rows[shifts[k]][col])
        elif op == air.OP_X:
            stack.append(x)
        elif op == air.OP_CONST:
            stack.append(arg)
        else:
            b, a = stack.pop(), stack.pop()
            stack.append({air.OP_ADD: a + b, air.OP_SUB: a - b, air.OP_MUL: a * b}[op] % P)
    (out,) = stack
    return out % P


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 25])
def test_three_numerator_modes_agree_at_width_8(seed):
    cfg = cfg_of("winterfell-mulfib8")
    width, shifts = cfg.air.width, cfg.air.shifts
    rng = random.Random(seed)
    points = 16
    vals = {k: [[rng.randrange(P) for _ in range(points)] for _ in range(width)]
            for k in shifts}
    fld = cfg.field
    dev = {k: fp.from_host(fld.host_to_mont(torch.tensor(v, dtype=torch.int64).numpy()
                                            .astype("uint32")), "cpu")
           for k, v in vals.items()}
    cons = [c for c in cfg.constraints if isinstance(c, air.Transition)]
    assert len(cons) == 8
    for con in cons:
        f_dev = air.row(lambda k, j: dev[k][j], width)
        got_dev = fp.to_host(fp.from_mont_f(fld, con.numerator(air.device_ops(fld), f_dev, None)))
        prog = air.numerator_program(con.numerator, shifts, P, width)
        for i in range(points):
            rows = {k: [vals[k][j][i] for j in range(width)] for k in shifts}
            f_host = air.row(lambda k, j: rows[k][j], width)
            host = con.numerator(air.host_ops(P), f_host, 0)
            assert host == _run_program(prog, shifts, width, rows, 0) == int(got_dev[i])


def test_composition_at_point_equals_the_plain_composition():
    """Σ αᵢ·cᵢ at a coset point from the opened rows equals the plain
    composition of random columns there (boundaries on columns 0, 1, 6)."""
    cfg = cfg_of("winterfell-mulfib8", trace_len=15)
    fld, d, b = cfg.field, cfg.eval_domain, cfg.blowup
    rng = random.Random(7)
    cols = [[rng.randrange(P) for _ in range(d)] for _ in range(cfg.air.width)]
    f_eval = fp.from_host(fld.host_to_mont(torch.tensor(cols).numpy().astype("uint32")), "cpu")
    alphas = [rng.randrange(P) for _ in range(cfg.n_constraints)]
    cp = fp.to_host(fp.from_mont_f(fld, pr.composition_eval_plain(
        cfg, f_eval, [fld.mont_scalar(a) for a in alphas])))
    kernel = fp.to_host(pr.composition_eval_res(cfg, f_eval, [fld.mont_scalar(a)
                                                              for a in alphas])[1])
    xs = fld.host_powers_pow2(cfg.domain_generator, d, scale=cfg.coset_offset)
    for j in (0, 1, d // 2, d - 1):
        rows = {k: [c[(j + k * b) % d] for c in cols] for k in cfg.air.shifts}
        want = air.composition_at_point(cfg, int(xs[j]), rows, alphas)
        assert int(cp[j]) == int(kernel[j]) == want


def test_wide_encodings():
    cfg = cfg_of("winterfell-mulfib8")
    words = air.serialize_air(cfg).tolist()
    assert words[:4] == [2, 0, 1, 11]
    # s0[0] = 1 on column 0, s1[0] = 5 on column 1, s6[62] = 7 on column 6
    assert words[4:15] == [0, 0, 1, 2, 0, 5, 1, 2, 62, 7, 6]
    prog = pr.composition_program(cfg)
    assert prog.width == 8 and prog.n_constraints == 11
    # s1[0] = b: a boundary on column 1 becomes the program f_1 − b
    assert prog.constraints()[1] == (1, [(0, cfg.eval_domain), (2, cfg.field.mont_scalar(5)),
                                         (4, 0)])
    assert prog.reach == cfg.blowup
