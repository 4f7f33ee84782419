"""A plain verifier of the reference's transcripts for statements of w trace
columns, written here and sharing nothing with the reference but its field
and the AIR files: it replays the Fiat-Shamir channel over the transcript,
checks every opened row's path against the trace root, recomputes the
composition at each query from the opened rows, and follows each query's
FRI pairs down to the free term. It runs on Winterfell's `mulfib8`
(``airs/winterfell_mulfib8.py``, 8 columns) and on a 2-column AIR written
below, as a later statement would bring it."""

import hashlib
import struct

import pytest
import torch

from proofbench.reference import prover
from proofbench.reference.prover import Field
from proofbench.yardstick import statement

P = 3221225473
SEED = 2**31 + 4247
MULFIB8 = dict(statement.load_config("winterfell_work"), air="winterfell-mulfib8",
               n_queries=4)

# FibonacciSq in two columns, as a new statement would bring it: a' = b,
# b' = a² + b², a[0] = 1, b[0] = s; the output is b at the last row. Column
# 0 enters squared, so the control's degree n − 1 in it lifts the
# composition past degree n.
TWO_COLUMNS = '''
import numpy as np

from proofbench.yardstick.statement import draw_secret

WIDTH = 2


def trace(trace_len, secret, p):
    rows = [(1, secret % p)]
    while len(rows) < trace_len:
        a, b = rows[-1]
        rows.append((b, (a * a + b * b) % p))
    return np.array(rows, dtype=np.uint32)


def witnesses(seed, cfg):
    p, n = int(cfg["field_p"]), int(cfg["trace_len"])
    s = draw_secret(seed, p)
    return [(w, {"boundary_first": w, "boundary_last": int(trace(n, w, p)[-1, 1])})
            for w in (s, p - s)]


def constraints(st, publics):
    n, p = st.trace_domain, st.p

    def num_a(fld, f):
        return (f[1][0] - f[0][1]) % p

    def num_b(fld, f):
        return (f[1][1] - fld.mul(f[0][0], f[0][0]) - fld.mul(f[0][1], f[0][1])) % p

    return [("boundary", (0, 1)),
            ("boundary", (0, publics["boundary_first"], 1)),
            ("boundary", (st.trace_len - 1, publics["boundary_last"], 1)),
            ("transition", (num_a, (n - 2, n - 1))),
            ("transition", (num_b, (n - 2, n - 1)))], (0, 1)


def fri_rounds(trace_domain):
    return trace_domain.bit_length() - 1
'''


class Rejected(Exception):
    pass


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise Rejected(what)


class Transcript:
    """Reads the transcript's payloads in order and replays the channel
    over them: state = SHA-256(state ‖ payload)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.state = data, 0, bytes(32)
        self.start = 0

    def take(self, n: int) -> bytes:
        expect(self.pos + n <= len(self.data), "transcript too short")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u32s(self, k: int) -> list:
        return list(struct.unpack(f"<{k}I", self.take(4 * k)))

    def path(self) -> list:
        (count,) = struct.unpack("<Q", self.take(8))
        return [self.take(32) for _ in range(count)]

    def begin(self) -> None:
        self.start = self.pos

    def end(self) -> None:
        """Commits what was read since `begin` as one payload."""
        self.state = hashlib.sha256(self.state + self.data[self.start:self.pos]).digest()

    def root(self) -> bytes:
        self.begin()
        out = self.take(32)
        self.end()
        return out

    def u32(self) -> int:
        self.begin()
        (v,) = self.u32s(1)
        self.end()
        return v

    def draw(self) -> int:
        want = int.from_bytes(self.state[:4], "big")
        expect(self.u32() == want, "a draw is not the channel's")
        return want


def check_path(root: bytes, leaf: bytes, index: int, path: list, depth: int) -> None:
    expect(len(path) == depth, "path length")
    node = hashlib.sha256(leaf).digest()
    for sib in path:
        node = hashlib.sha256(node + sib if index % 2 == 0 else sib + node).digest()
        index >>= 1
    expect(node == root, "path")


def verify(st, witness, state: bytes, data: bytes) -> None:
    """Raises `Rejected` naming the first check the proof fails."""
    p, n, d, b, w = st.p, st.trace_domain, st.eval_domain, st.blowup, st.width
    g, h = pow(st.generator, (p - 1) // n, p), pow(st.generator, (p - 1) // d, p)
    air = statement.load_air(st.air)
    cons, shifts = air.constraints(st, st.publics(witness))
    rounds = air.fri_rounds(n)
    depth = d.bit_length() - 1
    t = Transcript(data)

    f_root = t.root()
    alphas = [t.draw() % p for _ in cons]
    cp_root = t.root()
    betas, roots = [], [cp_root]
    for _ in range(rounds):
        betas.append(t.draw() % p)
        roots.append(t.root())
    free = t.u32()
    queries = [t.draw() % (d - max(shifts) * b) for _ in range(st.n_queries)]
    fld = Field(p)
    for q in queries:
        rows = {}
        for k in shifts:
            t.begin()
            rows[k] = t.u32s(w)
            check_path(f_root, struct.pack(f">{w}I", *rows[k]), q + k * b, t.path(), depth)
            t.end()
        t.begin()
        (cp,) = t.u32s(1)
        check_path(cp_root, struct.pack(">I", cp), q, t.path(), depth)
        t.end()

        x = st.coset_offset * pow(h, q, p) % p
        fk = {k: torch.tensor(r, dtype=torch.int64).reshape(w, 1) for k, r in rows.items()}
        if w == 1:
            fk = {k: v[0] for k, v in fk.items()}
        total = 0
        for alpha, (kind, con) in zip(alphas, cons):
            if kind == "boundary":
                col = con[2] if len(con) > 2 else 0
                term = (rows[0][col] - con[1]) * pow(x - pow(g, con[0], p), p - 2, p)
            else:
                num, exempt = con
                term = int(num(fld, fk)) * pow(pow(x, n, p) - 1, p - 2, p)
                for e in exempt:
                    term = term * (x - pow(g, e, p)) % p
            total = (total + alpha * term) % p
        expect(total == cp, "composition")

        value = cp
        for k in range(rounds):
            m = d >> k
            i0, i1 = q % m, (q + m // 2) % m
            t.begin()
            v0, v1 = t.u32s(2)
            check_path(roots[k], struct.pack(">I", v0), i0, t.path(), depth - k)
            check_path(roots[k], struct.pack(">I", v1), i1, t.path(), depth - k)
            t.end()
            expect(v0 == value, "FRI layer value")
            lo, hi = (v0, v1) if i0 < m // 2 else (v1, v0)
            xk = pow(st.coset_offset, 1 << k, p) * pow(h, (1 << k) * (i0 % (m // 2)), p) % p
            inv2 = pow(2, p - 2, p)
            value = ((lo + hi) * inv2 + betas[k] * (lo - hi) * inv2 * pow(xk, p - 2, p)) % p
        expect(value == free, "FRI free term")
    expect(t.pos == len(data), "bytes after the last opening")
    expect(t.state == state, "final state")


def mulfib8(trace_len: int):
    return statement.make("mulfib8", dict(MULFIB8, trace_len=trace_len), SEED)


@pytest.fixture
def two_columns(tmp_path, monkeypatch):
    (tmp_path / "two_columns.py").write_text(TWO_COLUMNS)
    monkeypatch.setattr(statement, "AIRS", tmp_path)
    cfg = dict(statement.load_config("stark101"), air="two-columns", trace_len=63, n_queries=4)
    return statement.make("two_columns", cfg, SEED)


def first_opening(st) -> int:
    """The offset of the first opened trace word: after the roots, the
    draws and the free term."""
    cons, _ = statement.load_air(st.air).constraints(st, st.publics(st.witness(0)))
    return 32 + 4 * len(cons) + 32 + 36 * st.fri_rounds + 4 + 4 * st.n_queries


def flip_first_word(st, data: bytes) -> bytes:
    """The first opened trace word, one bit flipped."""
    at = first_opening(st)
    return data[:at] + bytes([data[at] ^ 1]) + data[at + 1:]


def swap_first_columns(st, data: bytes) -> bytes:
    """The first opened row with its columns 0 and 1 swapped."""
    at = first_opening(st)
    a, b = data[at:at + 4], data[at + 4:at + 8]
    assert a != b
    return data[:at] + b + a + data[at + 8:]


@pytest.mark.parametrize("trace_len", [127, 255])
def test_mulfib8_proofs_verify(trace_len):
    st = mulfib8(trace_len)
    assert st.width == 8 and st.fri_rounds == (trace_len + 1).bit_length() - 1
    for w in st.cycle:
        verify(st, w, *prover.prove(st, w))


def test_two_column_proofs_verify(two_columns):
    st = two_columns
    assert st.width == 2
    for w in st.cycle:
        verify(st, w, *prover.prove(st, w))


@pytest.mark.parametrize("air", ["fibonacci-sq", "winterfell-work"])
def test_one_column_proofs_verify(air):
    """The same verifier at w = 1: the statements the cells prove."""
    base = "winterfell_work" if air == "winterfell-work" else "stark101"
    st = statement.make(air, dict(statement.load_config(base), air=air, trace_len=63), SEED)
    verify(st, st.witness(0), *prover.prove(st, st.witness(0)))


@pytest.mark.parametrize("fault,check", [(flip_first_word, "path"),
                                         (swap_first_columns, "path")],
                         ids=["flipped_word", "swapped_column"])
@pytest.mark.parametrize("which", ["mulfib8", "two_columns"])
def test_altered_opening_is_rejected(which, fault, check, request):
    st = mulfib8(127) if which == "mulfib8" else request.getfixturevalue("two_columns")
    w = st.witness(0)
    state, data = prover.prove(st, w)
    with pytest.raises(Rejected, match=f"^{check}$"):
        verify(st, w, state, fault(st, data))


def test_swapped_trace_columns_are_rejected(monkeypatch):
    """A prover that commits mulfib8's rows with columns 2 and 3 swapped
    (no boundary reads them): its openings and composition agree with its
    own tree, but the composition is no polynomial of low degree, and FRI
    does not reach the free term."""
    st = mulfib8(127)
    air = statement.load_air(st.air)
    swapped = air.trace

    def trace(trace_len, secret, p):
        return swapped(trace_len, secret, p)[:, [0, 1, 3, 2, 4, 5, 6, 7]]

    monkeypatch.setattr(air, "trace", trace)
    monkeypatch.setattr(prover, "load_air", lambda name: air)
    w = st.witness(0)
    with pytest.raises(Rejected, match="^FRI"):
        verify(st, w, *prover.prove(st, w))


@pytest.mark.parametrize("which", ["two_columns", "fibonacci-sq"])
def test_control_is_rejected(which, request):
    """The control (degree n − 1 in column 0) fails FRI where column 0
    enters a constraint squared: the 2-column AIR, and FibonacciSq at w = 1."""
    if which == "two_columns":
        st = request.getfixturevalue("two_columns")
    else:
        cfg = dict(statement.load_config("stark101"), trace_len=63, n_queries=4)
        st = statement.make(which, cfg, SEED)
    w = st.witness(0)
    with pytest.raises(Rejected, match="^FRI"):
        verify(st, w, *prover.prove(st, w, degree_fix=False))


def test_mulfib8_control_differs_only_in_its_bytes():
    """mulfib8's control is a proof this verifier must accept: every
    constraint multiplies two distinct columns or reads one linearly, so
    column 0 at degree n − 1 keeps the composition under degree n and FRI
    reaches a constant. Its bytes differ from the reference's from the trace
    root on, which is what the benchmark compares."""
    st = mulfib8(127)
    w = st.witness(0)
    control = prover.prove(st, w, degree_fix=False)
    verify(st, w, *control)
    sound = prover.prove(st, w)
    assert control[1][:32] != sound[1][:32] and control[0] != sound[0]
