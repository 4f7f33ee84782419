"""The composition's inverse denominators on Hopper (``csrc/constants.cu``).

`inverse_denominators` replaces ``zkstark_tpu/protocol/prover.py:53-160``
``composition_constants`` (with ``field/fp.py`` ``inv_f``, a 32-step Fermat
scan, and ``powers_iota_f``): one (n_constraints, d) tensor of Montgomery
words, one row a constraint in alpha order, over the coset
x_j = offset·h^j, j < d:

    boundary(g^step):     1/(x_j − g^step)
    transition(exempt):   Π_{e ∈ exempt} (x_j − g^e) · 1/(x_j^n − 1)

A `System` holds the constraints encoded for the kernel, which takes them by
value as kernel parameters (no upload):

    [n_constraints] then per constraint
      boundary:   [0, to_mont(g^step)]
      transition: [1, n_exempt, to_mont(g^e)…]
    then, from word `ztab` on, to_mont(1/(x_j^n − 1)) at j mod blowup

x_j^n = offset^n·(h^n)^j takes only `blowup` values (h^n has order d/n), so
1/(x_j^n − 1) is that table of `blowup` words, made on the host. x_j is read
from the two small tables of a `ntt_kernel.GeoScale`, and a thread inverts
its tile of boundary denominators with one Fermat inversion (Montgomery's
batch inversion). One launch writes the whole tensor; the kernel is bound by
its operations at these sizes.

On a CPU device `inverse_denominators` runs `inverse_denominators_plain`,
which reads the same words with whole-tensor field ops, on a CUDA device only
the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build, ntt_kernel

MAX_WORDS = 768  # the kernel's parameter table of the system, words
_PLAIN_CHUNK = 1 << 22  # points the plain twin computes at once

constants_launches = 0  # launches of constants_kernel, counted by inverse_denominators


@dataclass(frozen=True)
class System:
    """A constraint system's denominators ready for the kernel (hashable).
    `words` is the encoding of the module docstring; the domain is
    x_j = offset·generator^j (standard-form residues), j < domain."""

    words: tuple
    ztab: int
    blowup: int
    domain: int
    generator: int
    offset: int

    @property
    def n_constraints(self) -> int:
        return self.words[0]

    def constraints(self):
        """[(0, point_mont) | (1, (exempt_mont, …)), …] decoded from `words`."""
        w, out, i = self.words, [], 1
        for _ in range(w[0]):
            if w[i] == 0:
                out.append((0, w[i + 1]))
                i += 2
            else:
                out.append((1, tuple(w[i + 2 : i + 2 + w[i + 1]])))
                i += 2 + w[i + 1]
        return out


def encode(constraints, trace_domain: int, blowup: int, generator: int, offset: int,
           field: Field = FIELD101) -> System:
    """`constraints`: ("boundary", point) or ("transition", (exempt point, …)),
    points as standard residues (g^step, g^e); the domain has
    trace_domain·blowup points. Raises ValueError where the encoding does not
    fit the kernel's `MAX_WORDS`."""
    p = field.p
    words = [len(constraints)]
    for kind, arg in constraints:
        if kind == "boundary":
            words += [0, field.mont_scalar(arg)]
        else:
            words += [1, len(arg), *(field.mont_scalar(e) for e in arg)]
    ztab = len(words)
    hn = pow(generator, trace_domain, p)  # order blowup
    on = pow(offset, trace_domain, p)
    words += [field.mont_scalar(pow((on * pow(hn, r, p) - 1) % p, p - 2, p))
              for r in range(blowup)]
    if len(words) > MAX_WORDS:
        raise ValueError(f"constants: the system and its table take {len(words)} words, the "
                         f"kernel at most {MAX_WORDS}")
    return System(tuple(int(w) for w in words), ztab, blowup, trace_domain * blowup,
                  generator % p, offset % p)


def inverse_denominators_plain(system: System, field: Field, device) -> torch.Tensor:
    """Plain-torch twin of the kernel, same arguments: the same words read
    with whole-tensor field ops (a Fermat inversion a point, no batching),
    `_PLAIN_CHUNK` points at a time into the one tensor."""
    d = system.domain
    words = system.words
    ztab = fp.wide(fp.from_host(np.asarray(words[system.ztab :], dtype=np.uint32), device))
    a, b, s = ntt_kernel._geo_tables(system.generator, d, field, torch.device(device))
    a, b = fp.wide(a), fp.wide(b)
    out = torch.empty((system.n_constraints, d), dtype=torch.int32, device=device)
    for start in range(0, d, _PLAIN_CHUNK):
        size = min(_PLAIN_CHUNK, d - start)
        j = torch.arange(start, start + size, dtype=torch.int64, device=device)
        hj = fp.mont_mul_w(field, a[j >> s], b[j & ((1 << s) - 1)])
        xs = fp.mont_mul_w(field, hj, field.mont_scalar(system.offset))
        for c, (kind, arg) in enumerate(system.constraints()):
            if kind == 0:
                inv = fp.wide(fp.inv_f(field, fp.sub_w(field, xs, arg)))
            else:
                inv = ztab[j & (system.blowup - 1)]
                for e in arg:
                    inv = fp.mont_mul_w(field, fp.sub_w(field, xs, e), inv)
            out[c, start : start + size] = fp.as_i32(fp.narrow(inv))
    return fp.as_u32(out)


def inverse_denominators(system: System, field: Field = FIELD101, device="cuda") -> torch.Tensor:
    """The (n_constraints, domain) uint32 Montgomery inverse denominators on
    `device`: one kernel launch on a card."""
    global constants_launches
    dev = torch.device(device)
    if dev.type == "cpu":
        return inverse_denominators_plain(system, field, dev)
    if dev.type != "cuda":
        raise ValueError(f"constants: unsupported device {dev}")
    d = system.domain
    if d < 1 or d & (d - 1) or d > 1 << 32 or system.blowup & (system.blowup - 1):
        raise ValueError(f"constants: a domain of {d} points and blowup {system.blowup}")
    out = torch.empty((system.n_constraints, d), dtype=torch.uint32, device=dev)
    ga, gb, shift = ntt_kernel._geo_tables(system.generator, d, field, dev)
    host = np.asarray(system.words, dtype=np.uint32)
    with torch.cuda.device(dev):
        rc = _build.kernels().zk_constants(
            host.ctypes.data, len(system.words), system.ztab, system.blowup - 1,
            ga.data_ptr(), gb.data_ptr(), shift, field.mont_scalar(system.offset), field.r_mod_p,
            out.data_ptr(), d, field.p, field.p_inv_neg, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "constants")
    constants_launches += 1
    return out
