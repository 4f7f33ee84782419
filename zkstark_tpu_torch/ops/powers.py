"""The geometric sequence [scale·base^j for j < n] on Hopper
(``csrc/powers.cu``).

`powers` is what ``field/fp.py`` `powers_iota_f` and `device_powers_f` (and
the `Field` methods `powers_iota` / `device_powers`) compute on a card: the
counterpart of ``zkstark_tpu/field/fp.py:469 device_powers_f`` and
``:484 powers_iota_f``, which XLA compiled into one elementwise program. Its
plain twin, `powers_plain`, is the JAX `powers_iota_f` written out in int64
torch: log2(n) products an element from its index bits.

The kernel reads the two-table form base^j = A[j >> s]·B[j & (2^s − 1)]
from tables kept on the device per (field, base, n, scale); building
base^j0 from a thread's index bits instead measured half as fast on the card
(PERF.md). No prove path calls it. On the CPU `powers` runs the plain twin,
on a card only the kernel.
"""

from __future__ import annotations

import functools

import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import Field
from zkstark_tpu_torch.ops import _build

powers_launches = 0  # launches of the powers kernel, counted by powers


def _check(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"powers: n must be a power of two, got {n}")


def powers_plain(field: Field, base: int, n: int, scale: int = 1, device="cpu") -> torch.Tensor:
    """Plain-torch twin of `powers`: each element from its own index bits,
    base^j = Π_b (base^(2^b))^(j_b), as the JAX `powers_iota_f`."""
    _check(n)
    bits = max(n.bit_length() - 1, 1)
    j = torch.arange(n, dtype=torch.int64, device=device)
    acc = torch.full((n,), field.mont_scalar(scale), dtype=torch.int64, device=device)
    one = torch.tensor(field.r_mod_p, dtype=torch.int64, device=device)
    for b in range(bits):
        step = torch.tensor(field.mont_scalar(pow(base, 1 << b, field.p)), dtype=torch.int64,
                            device=device)
        acc = fp.mont_mul_w(field, acc, torch.where(((j >> b) & 1) == 1, step, one))
    return fp.narrow(acc)


@functools.lru_cache(maxsize=64)
def _tables(field: Field, base: int, n: int, scale: int, device: torch.device) -> tuple:
    """(A, B, s) on `device`: scale·base^j = A[j >> s]·B[j & (2^s − 1)]."""
    s = (n.bit_length() - 1) // 2
    b = field.host_powers_pow2(base, 1 << s)
    a = field.host_powers_pow2(pow(base, 1 << s, field.p), max(n >> s, 1), scale)
    return (fp.from_host(field.host_to_mont(a), device), fp.from_host(field.host_to_mont(b), device),
            s)


def powers(field: Field, base: int, n: int, scale: int = 1, device="cuda") -> torch.Tensor:
    """[scale·base^j for j < n] in Montgomery form, a (n,) uint32 tensor on
    `device`, n a power of two."""
    global powers_launches
    _check(n)
    dev = torch.device(device)
    if dev.type == "cpu":
        return powers_plain(field, base, n, scale, dev)
    base %= field.p
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    lib = _build.kernels()
    ta, tb, s = _tables(field, base, n, scale % field.p, dev)
    with torch.cuda.device(dev):
        rc = lib.zk_powers(out.data_ptr(), n, ta.data_ptr(), tb.data_ptr(), s, field.p,
                           field.p_inv_neg, _build.stream(out))
    _build.check(rc, "powers")
    powers_launches += 1
    return out
