"""Prime-field arithmetic over F_p on torch tensors, generic over the prime.

Counterpart of ``zkstark_tpu/field/fp.py``. Elements are Montgomery-form
residues (R = 2^32) held in ``torch.uint32`` tensors at every public function,
so they compare bit for bit with the JAX package's uint32 arrays.

Torch's ``uint32`` has no add, shift or compare on every backend, and an int64
product of two residues overflows ((p−1)² > 2^63 for p = 3·2^30+1). So the
plain ops here widen to int64 (`wide`), multiply through a 16-bit split of one
operand (every partial product < 2^48), reduce, and narrow back (`narrow`).
They reproduce the JAX REDC exactly, including its results on inputs that are
not reduced below p. The CUDA kernels use the same REDC through the native
32×32→64 multiply (``csrc/fp.cuh``).

Every ``*_w`` function takes and returns int64 tensors holding values in
[0, 2^32); Python ints are accepted wherever a scalar broadcasts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

R = 1 << 32
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _prime_factors(n: int) -> list[int]:
    """Unique prime factors of n by trial division (n < 2^32)."""
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^32 (bases 2, 7, 61 suffice)."""
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 61):
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 7, 61):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


class Field:
    """All constants of F_p for an odd prime p < 2^32, R = 2^32.

    Hashes and compares by p, so descriptors are valid ``lru_cache`` keys.
    Unlike the JAX descriptor it rejects a composite modulus: a proof over
    one would self-verify while being unsound."""

    __slots__ = (
        "p",
        "two_adicity",
        "r_mod_p",
        "r2_mod_p",
        "p_inv_neg",
        "_p_minus_2_bits",
        "_generator",
    )

    def __init__(self, p: int):
        if p < 3 or p % 2 == 0 or p >= R or not _is_prime(p):
            raise ValueError(f"need an odd prime 3 <= p < 2^32, got {p}")
        self.p = p
        t = p - 1
        two_adicity = 0
        while t % 2 == 0:
            t //= 2
            two_adicity += 1
        self.two_adicity = two_adicity
        self.r_mod_p = R % p
        self.r2_mod_p = (R * R) % p
        self.p_inv_neg = (-pow(p, -1, R)) % R  # Montgomery magic constant
        # LSB-first bits of p−2, walked by inv() as the JAX scan does.
        self._p_minus_2_bits = tuple(((p - 2) >> i) & 1 for i in range(32))
        self._generator = None

    def __hash__(self):
        return hash(self.p)

    def __eq__(self, other):
        return isinstance(other, Field) and other.p == self.p

    def __repr__(self):
        return f"Field({self.p})"

    @property
    def generator(self) -> int:
        """Smallest multiplicative generator of F_p^* (the reference's trial
        algorithm, field.rs:52-86)."""
        if self._generator is None:
            factors = _prime_factors(self.p - 1)
            x = 2
            while not all(pow(x, (self.p - 1) // q, self.p) != 1 for q in factors):
                x += 1
            self._generator = x
        return self._generator

    def subgroup_generator(self, order: int) -> int:
        """g^((p-1)/order), as the reference derives it (prover.rs:48-49)."""
        return _subgroup_generator(self, order)

    def multiplicative_order(self, x: int) -> int:
        """Exact multiplicative order of x in F_p^* (reference field.rs:45-49),
        by refining p − 1 over its prime factors."""
        p = self.p
        x %= p
        if x == 0:
            raise ValueError("0 has no multiplicative order")
        order = p - 1
        for q in _prime_factors(p - 1):
            while order % q == 0 and pow(x, order // q, p) == 1:
                order //= q
        return order

    # -- device ops: the module's *_f functions, bound as methods ----------
    def mont_mul(self, a, b):
        return mont_mul_f(self, a, b)

    def to_mont(self, a):
        return to_mont_f(self, a)

    def from_mont(self, a):
        return from_mont_f(self, a)

    def add(self, a, b):
        return add_f(self, a, b)

    def sub(self, a, b):
        return sub_f(self, a, b)

    def neg(self, a):
        return neg_f(self, a)

    def pow_static(self, a, e: int):
        return pow_static_f(self, a, e)

    def inv(self, a):
        return inv_f(self, a)

    def device_powers(self, base: int, n: int, device="cuda"):
        return device_powers_f(self, base, n, device)

    def powers_iota(self, base: int, n: int, scale: int = 1, device="cuda"):
        return powers_iota_f(self, base, n, scale, device)

    def mont_scalar(self, v: int) -> int:
        """to_mont of one host residue, as a Python int."""
        return int(self.host_to_mont(np.array([v % self.p], np.uint32))[0])

    # -- exact host helpers (numpy u64: every product < 2^64) --------------
    def host_to_mont(self, arr: np.ndarray) -> np.ndarray:
        return (
            (np.asarray(arr).astype(np.uint64) * np.uint64(self.r_mod_p))
            % np.uint64(self.p)
        ).astype(np.uint32)

    def host_powers(self, base: int, count: int, start: int = 1) -> np.ndarray:
        """[start, start·base, start·base², …] as `count` uint32 residues."""
        out = np.empty(count, dtype=np.uint32)
        acc = start % self.p
        for i in range(count):
            out[i] = acc
            acc = (acc * base) % self.p
        return out

    def host_powers_pow2(self, base: int, n: int, scale: int = 1) -> np.ndarray:
        """[scale·base^j for j < n] as uint32 residues, n a power of two, by
        log-doubling."""
        assert n >= 1 and n & (n - 1) == 0
        arr = np.array([scale % self.p], dtype=np.uint64)
        while arr.shape[0] < n:
            step = np.uint64(pow(base, arr.shape[0], self.p))
            arr = np.concatenate([arr, (arr * step) % np.uint64(self.p)])
        return arr.astype(np.uint32)

    def host_vandermonde(self, bases: np.ndarray, n: int) -> np.ndarray:
        """V[i, k] = bases[i]^k mod p for k < n, as uint32 residues."""
        v = np.ones((bases.shape[0], 1), dtype=np.uint64)
        bm = bases.astype(np.uint64)
        p64 = np.uint64(self.p)
        while v.shape[1] < n:
            step = min(v.shape[1], n - v.shape[1])
            v = np.concatenate([v, (v[:, :step] * bm[:, None]) % p64], axis=1)
            bm = (bm * bm) % p64
        return v.astype(np.uint32)

    def host_pow_vec(self, bases: np.ndarray, e: int) -> np.ndarray:
        """bases^e mod p elementwise (square-and-multiply)."""
        r = np.ones_like(bases, dtype=np.uint64)
        b = bases.astype(np.uint64)
        p64 = np.uint64(self.p)
        while e:
            if e & 1:
                r = (r * b) % p64
            b = (b * b) % p64
            e >>= 1
        return r.astype(np.uint32)

    def host_inv_vec(self, a: np.ndarray) -> np.ndarray:
        """Fermat inverse of uint32 residues; zero maps to zero."""
        return self.host_pow_vec(a.astype(np.uint64), self.p - 2)


@functools.lru_cache(maxsize=None)
def field_for(p: int) -> Field:
    """Canonical (cached) descriptor for F_p."""
    return Field(p)


@functools.lru_cache(maxsize=None)
def _subgroup_generator(field: Field, order: int) -> int:
    assert (field.p - 1) % order == 0, f"no subgroup of order {order}"
    return pow(field.generator, (field.p - 1) // order, field.p)


P = 3221225473  # 3·2^30 + 1, the stark-101 prime (reference main.rs:13)
FIELD101 = field_for(P)
FIELD101._generator = 5  # the reference finds 5 (prover.rs:44)

TWO_ADICITY = FIELD101.two_adicity  # 30: p − 1 = 3·2^30
GENERATOR = 5  # smallest multiplicative generator (reference field.rs:52-86)
R_MOD_P = FIELD101.r_mod_p  # Montgomery form of 1
R2_MOD_P = FIELD101.r2_mod_p  # to_mont multiplier
P_INV_NEG = FIELD101.p_inv_neg  # p' = −p^{-1} mod 2^32

# 15·2^27 + 1: the second 2-adic prime the JAX package proves over.
P_ALT = 2013265921
FIELD_ALT = field_for(P_ALT)


def resolve_device(device) -> torch.device:
    """torch.device(device), raising if it is a CUDA device and there is no
    card, or neither CPU nor CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# uint32 <-> int64 and device placement
# ---------------------------------------------------------------------------


def wide(a):
    """uint32 tensor → int64 tensor of the same values; ints pass through."""
    if not isinstance(a, torch.Tensor):
        return int(a)
    if a.dtype == torch.uint32:
        return a.view(torch.int32).to(torch.int64) & _M32
    if a.dtype == torch.int64:
        return a
    raise TypeError(f"field tensors are uint32 (or int64 when wide), got {a.dtype}")


def narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) → uint32 tensor, through int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32).view(torch.uint32)


def as_i32(a: torch.Tensor) -> torch.Tensor:
    """Bit view of a uint32 tensor as int32, for data movement (cat, roll,
    gather, transpose) that every backend implements for int32."""
    return a.view(torch.int32)


def as_u32(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.uint32)


def from_host(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array → uint32 tensor on `device`."""
    a = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device).view(torch.uint32)


def to_host(t: torch.Tensor) -> np.ndarray:
    """uint32 tensor (any device) → uint32 numpy array."""
    return t.detach().view(torch.int32).cpu().numpy().view(np.uint32)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)


# ---------------------------------------------------------------------------
# Montgomery reduction / multiplication on wide (int64) values
# ---------------------------------------------------------------------------


def _mul_wide(a, b):
    """(hi, lo) of the exact 64-bit product of two values < 2^32, through a
    16-bit split of b: both partial products are < 2^48."""
    x1 = a * (b & _M16)
    x2 = a * (b >> 16)
    mid = x1 + ((x2 & _M16) << 16)  # < 2^49
    return (x2 >> 16) + (mid >> 32), mid & _M32


def _mul_lo(a, c: int):
    """(a·c) mod 2^32 for a < 2^32 and a constant c < 2^32."""
    return (a * (c & _M16) + (((a * (c >> 16)) & _M16) << 16)) & _M32


def redc_w(f: Field, hi, lo):
    """REDC of t = hi·2^32 + lo: u = (t + m·p)/2^32 with m = lo·p' mod 2^32,
    then one conditional subtraction of p. u < 2^33 is exact in int64; the
    JAX wraparound detection (fp.py:368-389) gives the same 32-bit result for
    every input."""
    m = _mul_lo(lo, f.p_inv_neg)
    mp_hi, _ = _mul_wide(m, f.p)
    u = hi + mp_hi + (lo != 0).to(torch.int64)
    return torch.where(u >= f.p, u - f.p, u)


def mont_mul_w(f: Field, a, b):
    hi, lo = _mul_wide(a, b)
    return redc_w(f, hi, lo)


def add_w(f: Field, a, b):
    s = a + b
    return torch.where(s >= f.p, (s - f.p) & _M32, s)


def sub_w(f: Field, a, b):
    d = a - b
    return torch.where(d < 0, (d + f.p) & _M32, d)


# ---------------------------------------------------------------------------
# Public uint32 ops (counterparts of fp.py:368-505)
# ---------------------------------------------------------------------------


def mont_reduce_f(f: Field, hi, lo):
    """REDC on uint32 (hi, lo) word tensors."""
    return narrow(redc_w(f, wide(hi), wide(lo)))


def mont_mul_f(f: Field, a, b):
    """Montgomery product a·b·R^{-1} mod p."""
    return narrow(mont_mul_w(f, wide(a), wide(b)))


def to_mont_f(f: Field, a):
    """Standard residue → Montgomery form (a·R mod p)."""
    return narrow(mont_mul_w(f, wide(a), f.r2_mod_p))


def from_mont_f(f: Field, a):
    """Montgomery form → standard residue (reference residue(), field.rs:41)."""
    return narrow(redc_w(f, 0, wide(a)))


def add_f(f: Field, a, b):
    return narrow(add_w(f, wide(a), wide(b)))


def sub_f(f: Field, a, b):
    return narrow(sub_w(f, wide(a), wide(b)))


def neg_f(f: Field, a):
    w = wide(a)
    return narrow(torch.where(w == 0, w, (f.p - w) & _M32))


def _ones_w(f: Field, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, f.r_mod_p, dtype=torch.int64, device=like.device)


def pow_static_f(f: Field, a, e: int):
    """a^e for a Python int e ≥ 0, Montgomery form in and out."""
    if e < 0:
        raise ValueError("use inv() + pow_static for negative exponents")
    result = None
    base = wide(a)
    while e:
        if e & 1:
            result = base if result is None else mont_mul_w(f, result, base)
        e >>= 1
        if e:
            base = mont_mul_w(f, base, base)
    return narrow(_ones_w(f, base) if result is None else result)


def inv_f(f: Field, a):
    """Fermat inverse a^{p-2}: the JAX scan's 32 steps over the LSB-first
    bits of p−2, in the same order (so equal even on unreduced input)."""
    base = wide(a)
    result = _ones_w(f, base)
    bits = f._p_minus_2_bits
    for i, bit in enumerate(bits):
        if bit:
            result = mont_mul_w(f, result, base)
        if i + 1 < len(bits):
            base = mont_mul_w(f, base, base)
    return narrow(result)


def powers_iota_f(f: Field, base: int, n: int, scale: int = 1, device="cuda"):
    """[scale·base^j for j < n] in Montgomery form on `device`, n a power of
    two: the `powers` kernel on a card (``ops/powers.py``), on the CPU its
    plain twin, each element from its own index bits."""
    assert n >= 1 and n & (n - 1) == 0
    from zkstark_tpu_torch.ops import powers

    return powers.powers(f, base, n, scale, resolve_device(device))


def device_powers_f(f: Field, base: int, n: int, device="cuda"):
    """[1, base, …, base^{n-1}] in Montgomery form on `device`, n a power of
    two: `powers_iota_f` with scale 1."""
    return powers_iota_f(f, base, n, 1, device)


# ---------------------------------------------------------------------------
# The protocol field's ops and host helpers as module functions (FIELD101),
# as the JAX package's module exports them
# ---------------------------------------------------------------------------

mont_mul = functools.partial(mont_mul_f, FIELD101)
to_mont = functools.partial(to_mont_f, FIELD101)
from_mont = functools.partial(from_mont_f, FIELD101)
add = functools.partial(add_f, FIELD101)
sub = functools.partial(sub_f, FIELD101)
neg = functools.partial(neg_f, FIELD101)
pow_static = functools.partial(pow_static_f, FIELD101)
inv = functools.partial(inv_f, FIELD101)


def device_powers(base: int, n: int, device="cuda"):
    return device_powers_f(FIELD101, base, n, device)


def powers_iota(base: int, n: int, scale: int = 1, device="cuda"):
    return powers_iota_f(FIELD101, base, n, scale, device)


def host_pow(base: int, e: int, modulus: int = P) -> int:
    return pow(base, e % (modulus - 1) if e >= 0 else e, modulus)


def multiplicative_order(x: int, modulus: int = P) -> int:
    return field_for(modulus).multiplicative_order(x)


def find_generator(modulus: int = P) -> int:
    return field_for(modulus).generator


def subgroup_generator(order: int) -> int:
    return FIELD101.subgroup_generator(order)


def host_powers(base: int, count: int, start: int = 1) -> np.ndarray:
    return FIELD101.host_powers(base, count, start)


def host_to_mont(arr: np.ndarray) -> np.ndarray:
    return FIELD101.host_to_mont(arr)


def host_powers_pow2(base: int, n: int, scale: int = 1) -> np.ndarray:
    return FIELD101.host_powers_pow2(base, n, scale)


def host_vandermonde(bases: np.ndarray, n: int) -> np.ndarray:
    return FIELD101.host_vandermonde(bases, n)


def host_pow_vec(bases: np.ndarray, e: int) -> np.ndarray:
    return FIELD101.host_pow_vec(bases, e)


def host_inv_vec(a: np.ndarray) -> np.ndarray:
    return FIELD101.host_inv_vec(a)
