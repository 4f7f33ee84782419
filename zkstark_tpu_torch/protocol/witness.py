"""The witness on the host: each AIR's recurrence as one compiled loop.

``csrc/witness.cpp`` steps the recurrence that the AIR names
(`Air.recurrence`, with its constant `Air.constant`) over F_p in Montgomery
form and writes each row's words in the same pass: the Montgomery words the
prover uploads, or the canonical values `Air.trace` returns. B secrets step
together, so that their chains of dependent multiplies overlap. A trace of
`Air.width` = w > 1 columns (mulfib8's 8 registers) is written column after
column, (B, w, trace_len), the layout the prover's LDE takes.

At first use ``g++ -O3`` builds the source into ``build/zkstark_tpu_torch/``
(``ops/_build.py`` `gxx`, named by a hash of the source). The call goes
through ctypes, which releases the GIL while the loop runs. Each call adds
its rows (trace_len × B) to the tracer's counter ``witness.rows`` and the
words it wrote (trace_len × w × B) to ``witness.cells``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field.fp import Field
from zkstark_tpu_torch.ops._build import gxx

SRC = Path(__file__).resolve().parents[1] / "csrc" / "witness.cpp"

# The recurrences of csrc/witness.cpp (its enum Kind).
FIBONACCI_SQ, FIBONACCI, SQUARE_CHAIN, WORK, MULFIB8 = range(5)

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(gxx(SRC, "libzkstark_witness")))
    # (kind, secrets, batch, len, c, r, p, p_inv_neg, out, last)
    lib.zk_witness.argtypes = [ctypes.c_int, _P, _I64, _I64, _U32, _U32, _U32, _U32, _P, _P]
    lib.zk_witness.restype = ctypes.c_int
    return lib


def traces(air, secrets, trace_len: int, field: Field, mont: bool = True,
           out: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(words, last) of the B witnesses of `air` from `secrets` (any ints,
    taken mod p): words, (B, trace_len) uint32, row i of each the value
    a[i] in Montgomery form where `mont`, else canonical, written into `out`
    where given; (B, w, trace_len), column j of each its own row, where the
    AIR has w > 1 columns. last, (B,) uint32, each trace's output
    (canonical) for the public-boundary check: the last value a[trace_len−1],
    or mulfib8's register 6 at the last row."""
    if air.recurrence is None:
        raise NotImplementedError(f"the {air.name!r} AIR names no witness recurrence")
    if trace_len < 1:
        raise ValueError(f"a trace has at least one row, got trace_len={trace_len}")
    p = field.p
    seeds = np.array([int(s) % p for s in secrets], dtype=np.uint32)
    shape = (len(seeds), trace_len) if air.width == 1 else (len(seeds), air.width, trace_len)
    if out is None:
        out = np.empty(shape, dtype=np.uint32)
    elif out.dtype != np.uint32 or out.shape != shape or not out.flags.c_contiguous:
        raise ValueError(f"witness: out= must be a C-contiguous uint32 {shape} array")
    last = np.empty(len(seeds), dtype=np.uint32)
    rc = _lib().zk_witness(air.recurrence, seeds.ctypes.data, len(seeds), trace_len,
                           air.constant % p, field.r_mod_p if mont else 1, p, field.p_inv_neg,
                           out.ctypes.data, last.ctypes.data)
    if rc != 0:
        raise ValueError(f"witness: no recurrence {air.recurrence} in {SRC.name}")
    tracing.count("witness.rows", len(seeds) * trace_len)
    tracing.count("witness.cells", out.size)
    return out, last
