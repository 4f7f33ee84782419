"""Winterfell's `mulfib8` as the benchmark's AIR file
(``airs/winterfell_mulfib8.py``): its rows are the closed form b^F(8i + j),
meet every constraint the file states, start as the source's do for b = 2,
and each seeded start states its own output."""

import numpy as np
import pytest
import torch

from proofbench.reference.prover import Field
from proofbench.yardstick import statement

P = 3221225473
CFG = dict(statement.load_config("winterfell_work"), air="winterfell-mulfib8", trace_len=255)
AIR = statement.load_air("winterfell-mulfib8")


def closed_form(trace_len: int, b: int) -> np.ndarray:
    """b^F(8i + j) mod p, the Fibonacci exponents taken mod p − 1."""
    fib = [0, 1]
    while len(fib) < 8 * trace_len:
        fib.append((fib[-2] + fib[-1]) % (P - 1))
    return np.array([pow(b, e, P) for e in fib[:8 * trace_len]],
                    dtype=np.uint32).reshape(trace_len, 8)


@pytest.mark.parametrize("b", [2, 3, P - 1, 2**31 + 11])
def test_rows_are_the_closed_form(b):
    rows = AIR.trace(255, b, P)
    assert rows.shape == (255, AIR.WIDTH) and rows.dtype == np.uint32
    np.testing.assert_array_equal(rows, closed_form(255, b))


def test_two_gives_the_source_first_row():
    assert AIR.trace(4, 2, P)[0].tolist() == [1, 2, 2, 4, 8, 32, 256, 8192]


@pytest.mark.parametrize("seed", [1, 2**31 + 4243, 2**40 + 7])
def test_rows_meet_every_constraint(seed):
    """Every boundary holds on the rows, and every transition numerator is
    0 on each step it constrains (steps 0 … n − 3)."""
    st = statement.make("mulfib8", CFG, seed)
    assert st.width == 8 and st.fri_rounds == 8
    for w in st.cycle:
        rows = AIR.trace(st.trace_len, int(w), P)
        cons, shifts = AIR.constraints(st, w.publics)
        assert shifts == (0, 1) and len(cons) == 11
        f = {k: torch.as_tensor(rows[k:st.trace_len - 1 + k].T.astype(np.int64))
             for k in shifts}
        for kind, data in cons:
            if kind == "boundary":
                step, value, col = data
                assert int(rows[step, col]) == value
            else:
                num, exempt = data
                assert exempt == (st.trace_domain - 2, st.trace_domain - 1)
                assert not num(Field(P), f).any()


def test_a_wrong_cell_breaks_a_transition():
    st = statement.make("mulfib8", CFG, 5)
    w = st.witness(0)
    rows = AIR.trace(st.trace_len, int(w), P).astype(np.int64)
    rows[100, 3] = (rows[100, 3] + 1) % P
    cons, _ = AIR.constraints(st, w.publics)
    f = {k: torch.as_tensor(rows[k:st.trace_len - 1 + k].T) for k in (0, 1)}
    broken = [bool(data[0](Field(P), f).any()) for kind, data in cons if kind == "transition"]
    assert broken == [False, False, False, True, True, True, False, False]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 4243, 2**33 + 5])
def test_seeded_starts_are_distinct_and_state_their_output(seed):
    st = statement.make("mulfib8", CFG, seed)
    assert len(st.cycle) == 2 and int(st.witness(0)) != int(st.witness(1))
    for w in st.cycle:
        assert 2 <= int(w) < P
        assert w.publics["boundary_first"] == int(w)
        assert w.publics["boundary_last"] == int(AIR.trace(st.trace_len, int(w), P)[-1, 6])
    assert statement.make("mulfib8", CFG, seed) == st
