"""The plain reference prover: a proof worked out again from the statement
and the secret, in plain PyTorch (int64 tensors, on any device) and hashlib.

It follows the protocol of the STARK 101 reference (Crocodoctopus/zkstark,
src/prover.rs, channel.rs, merkle.rs, proof.rs) generalised to an AIR and a
query count, and shares no code with the program:

1. the witness rows (``airs/<air>.py``: its rows of w columns, constraints,
   shifts and FRI rounds; the public values are the witness's), checked
   against every boundary constraint; each column's polynomial of degree at
   most n − 2 on the trace group ⟨g⟩ (n = trace_len + 1): the n − 1 rows and
   the one value at g^(n−1) that makes its top coefficient vanish, then an
   inverse NTT; its evaluations on the coset offset·⟨h⟩ of n·blowup points;
   the root of the one Merkle tree whose leaf i is the row of the w columns
   at point i, into the channel;
2. one α per constraint, the composition Σ αᵢ·cᵢ(x) at every coset point
   (boundary: (f(x) − v)/(x − g^step); transition: numerator·Π(x − g^e) /
   (x^n − 1)); its root;
3. per FRI round a β, the fold P'(x²) = (P(x) + P(−x))/2 + β·(P(x) − P(−x))/(2x),
   its root; the last layer's first value (the free term);
4. the query draws (mod domain − max_shift·blowup), then per query the trace
   openings at q + k·blowup for each shift k (the row's w values, then its
   path), the composition at q, and per
   FRI layer the pair at q and q + m/2 (mod m), each with its path.

The channel: a 32-byte state, each payload committed as state =
SHA-256(state ‖ payload); a draw is the state's first 4 bytes big-endian,
committed back as a little-endian u32; a path is a u64 count and the
digests (bincode 1.3). `prove` returns (final state, transcript bytes).
"""

from __future__ import annotations

import hashlib
import struct

import torch

from proofbench.reference import sha256
from proofbench.yardstick.statement import Statement, load_air


class Field:
    """F_p, p < 2^32, on int64 tensors: every product is split so that no
    intermediate passes 2^49."""

    def __init__(self, p: int):
        self.p = p

    def mul(self, a, b):
        p = self.p
        if isinstance(b, int):
            b = torch.tensor(b % p, dtype=torch.int64, device=a.device)
        hi = (a * (b >> 16)) % p
        return ((hi << 16) + a * (b & 0xFFFF)) % p

    def pow(self, x: torch.Tensor, e: int) -> torch.Tensor:
        out = torch.ones_like(x)
        base = x.clone()
        while e:
            if e & 1:
                out = self.mul(out, base)
            base = self.mul(base, base)
            e >>= 1
        return out

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        return self.pow(x, self.p - 2)

    def powers(self, base: int, count: int, device, scale: int = 1) -> torch.Tensor:
        """scale·base^j for j < count."""
        p = self.p
        out = torch.tensor([scale % p], dtype=torch.int64, device=device)
        while out.shape[0] < count:
            out = torch.cat([out, self.mul(out, pow(base, out.shape[0], p))])
        return out[:count]


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt(fld: Field, x: torch.Tensor, root: int) -> torch.Tensor:
    """Σ_i x_i·root^(ij) for j < N (root of order N = len(x)), natural order
    in and out: radix-2 decimation in frequency, then a bit reversal."""
    n, p = x.shape[0], fld.p
    x = x.clone()
    tw = fld.powers(root, max(n // 2, 1), x.device)
    size = n
    while size >= 2:
        half = size // 2
        v = x.view(n // size, 2, half)
        u, w = v[:, 0, :].clone(), v[:, 1, :].clone()
        v[:, 0, :] = (u + w) % p
        v[:, 1, :] = fld.mul((u - w) % p, tw[:: n // size][:half])
        size = half
    return x[_bit_reverse(n, x.device)]


def intt(fld: Field, x: torch.Tensor, root: int) -> torch.Tensor:
    n, p = x.shape[0], fld.p
    return fld.mul(ntt(fld, x, pow(root, p - 2, p)), pow(n, p - 2, p))


class Channel:
    def __init__(self):
        self.state = bytes(32)
        self.data = bytearray()

    def commit(self, payload: bytes) -> None:
        self.state = hashlib.sha256(self.state + payload).digest()
        self.data += payload

    def commit_u32(self, v: int) -> None:
        self.commit(struct.pack("<I", v))

    def draw(self) -> int:
        v = int.from_bytes(self.state[:4], "big")
        self.commit_u32(v)
        return v


def _path(path: list) -> bytes:
    return struct.pack("<Q", len(path)) + b"".join(path)


def _column(boundary: tuple) -> int:
    """A boundary's column: its third field, 0 where it has two."""
    return boundary[2] if len(boundary) > 2 else 0


def prove(st: Statement, witness: int, device="cpu", degree_fix: bool = True) -> tuple:
    """(state, data) of the proof of `st` for `witness` (a
    ``statement.Witness``, or a bare secret proving the statement's own
    public values). degree_fix=False leaves the top coefficient of column
    0's polynomial in (the control: a polynomial of degree n − 1, past the
    statement's degree bound)."""
    fld, p = Field(st.p), st.p
    n, d, b = st.trace_domain, st.eval_domain, st.blowup
    g = pow(st.generator, (p - 1) // n, p)
    h = pow(st.generator, (p - 1) // d, p)
    air, publics = load_air(st.air), st.publics(witness)
    cons, shifts = air.constraints(st, publics)
    rounds = air.fri_rounds(n)
    ch = Channel()

    # 1. witness, trace polynomials, LDE on the coset, commit
    w = st.width
    cols = air.trace(st.trace_len, int(witness), p).reshape(st.trace_len, w).T
    for kind, data in cons:
        if kind == "boundary" and int(cols[_column(data), data[0]]) != data[1]:
            raise ValueError("the secret's trace misses the public output")
    g_pows = fld.powers(g, n - 1, device)
    f = torch.empty((w, d), dtype=torch.int64, device=device)
    for j in range(w):
        v = torch.as_tensor(cols[j].astype("int64"), device=device)
        fix = degree_fix or j > 0
        top = int(fld.mul(v, g_pows).sum()) % p
        last = (-g * top) % p if fix else 0
        coeffs = intt(fld, torch.cat([v, v.new_tensor([last])]), g)
        if fix and int(coeffs[-1]) != 0:
            raise AssertionError("trace polynomial above its degree bound")
        padded = torch.zeros(d, dtype=torch.int64, device=device)
        padded[:n] = fld.mul(coeffs, fld.powers(st.coset_offset, n, device))
        f[j] = ntt(fld, padded, h)
        del padded, coeffs
    f_tree = sha256.Tree(f.t())
    ch.commit(f_tree.root())

    # 2. composition
    alphas = [ch.draw() % p for _ in cons]
    xs = fld.powers(h, d, device, scale=st.coset_offset)
    fk = {k: torch.roll(f, -k * b, dims=1) for k in shifts}
    if w == 1:
        fk = {k: v[0] for k, v in fk.items()}
    cp = torch.zeros(d, dtype=torch.int64, device=device)
    for alpha, (kind, data) in zip(alphas, cons):
        if kind == "boundary":
            step, value = data[:2]
            col = fk[0] if w == 1 else fk[0][_column(data)]
            term = fld.mul((col - value) % p, fld.inv((xs - pow(g, step, p)) % p))
        else:
            num, exempt = data
            den = fld.inv((fld.pow(xs, n) - 1) % p)
            for e in exempt:
                den = fld.mul(den, (xs - pow(g, e, p)) % p)
            term = fld.mul(num(fld, fk), den)
        cp = (cp + fld.mul(term, alpha)) % p
    del fk
    cp_tree = sha256.Tree(cp)
    ch.commit(cp_tree.root())

    # 3. FRI
    inv2 = pow(2, p - 2, p)
    layers = [cp_tree]
    evals = cp
    for k in range(rounds):
        beta = ch.draw() % p
        m = evals.shape[0]
        base, off = pow(h, 1 << k, p), pow(st.coset_offset, 1 << k, p)
        inv_x = fld.powers(pow(base, p - 2, p), m // 2, device, scale=pow(off, p - 2, p))
        lo, hi = evals[: m // 2], evals[m // 2:]
        even = fld.mul((lo + hi) % p, inv2)
        odd = fld.mul(fld.mul((lo - hi) % p, inv2), inv_x)
        evals = (even + fld.mul(odd, beta)) % p
        tree = sha256.Tree(evals)
        layers.append(tree)
        ch.commit(tree.root())
    ch.commit_u32(int(evals[0]))

    # 4. queries and openings
    query_range = d - max(shifts) * b
    queries = [ch.draw() % query_range for _ in range(st.n_queries)]
    for q in queries:
        for k in shifts:
            i = q + k * b
            ch.commit(struct.pack(f"<{w}I", *f_tree.row(i)) + _path(f_tree.path(i)))
        ch.commit(struct.pack("<I", cp_tree.value(q)) + _path(cp_tree.path(q)))
        for tree in layers[:rounds]:
            m = tree.values.shape[0]
            i0, i1 = q % m, (q + m // 2) % m
            ch.commit(struct.pack("<II", tree.value(i0), tree.value(i1))
                      + _path(tree.path(i0)) + _path(tree.path(i1)))
    return ch.state, bytes(ch.data)
