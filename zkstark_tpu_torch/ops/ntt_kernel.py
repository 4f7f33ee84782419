"""NTT row transforms on Hopper (CUDA kernel B, ``csrc/ntt.cu``) and the
four-step glue around them.

`ntt_rows` replaces the Pallas kernel ``zkstark_tpu/ops/ntt_kernel.py``
``_ntt_cols_kernel`` (and, on the card, the jnp radix-2 chain of
``zkstark_tpu/ntt/core.py`` ``_butterflies`` below 2^14). One thread block
runs one length-m transform (m ≤ 8192) entirely in shared memory: the row is
loaded once in bit-reversed order (32 KB at m = 8192), all log2(m) radix-2
DIT stages run between ``__syncthreads()`` barriers, and the natural-order
result is stored once. What bounds it on the H100 is per-stage work, not
device memory: each stage is a shared-memory read and write of the whole row
plus m/2 Montgomery multiplies (one 32×32→64 multiply, one 32×32 low
multiply and one ``__umulhi`` each). The design keeps every stage on chip and
uses the native wide multiply; the TPU's 16-bit-limb product and its
column-oriented (m, 128) lane layout are not carried over.

A flat size-n transform (n = n1·n2, n ≥ `MIN_FOURSTEP`) is the four-step
factorization

    X[k1 + n1·k2] = Σ_{j2} ω^{j2·k1} (ω^{n1})^{j2·k2} · Σ_{j1} x[j1·n2+j2] (ω^{n2})^{j1·k1}

  1. transpose to (n2, n1) and row-transform with root ω^{n2}  [kernel]
  2. twiddle by ω^{k1·j2}, factored as U[k1, jh]·V[k1, jl]     [torch]
  3. transpose to (n1, n2) and row-transform with root ω^{n1}  [kernel]
  4. transpose back, so the flat result is in natural order      [torch]

With ``ZKSTARK_PEASE=on`` (the JAX package's own switch, `pease_enabled`,
read at every call) both passes run `ntt_rows_pease` instead (CUDA kernel D,
``csrc/ntt_pease.cu``): the constant-geometry DIF transform of
``_ntt_cols_pease_kernel``, natural rows in and bit-reversed rows out. The
bit-reversals then fall along dim 1; they are undone without a strided
pass: the columns of U.T and V.T are permuted by br1 (host constants), and
the transposes of steps 3 and 4 become row gathers of the transposed views.

Outputs equal the radix-2 transform exactly (pure field identities).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
from zkstark_tpu_torch.ops import _build

MAX_ROW = 8192  # longest row one block transforms (shared memory: 4·m bytes)
MIN_FOURSTEP = 1 << 14  # flat transforms from this size take the four-step glue
_VBLK = 128  # width of the V factor of the four-step twiddle (capped at n2)

ntt_launches = 0  # launches of the CUDA kernel, counted by ntt_rows
pease_launches = 0  # launches of the Pease kernel, counted by ntt_rows_pease


def pease_enabled() -> bool:
    """The four-step route, read at each call as the JAX package reads it
    (``zkstark_tpu/ops/ntt_kernel.py`` ``pease_enabled``): ``ZKSTARK_PEASE=on``
    takes `ntt_rows_pease`, anything else `ntt_rows`."""
    return os.environ.get("ZKSTARK_PEASE", "off") == "on"


@functools.lru_cache(maxsize=None)
def stage_twiddles(m: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(m−1,) uint32 Montgomery stage table for a length-m transform with
    root w: stage s (half = 2^s) sits at offset half−1 and holds
    ω_{2·half}^j for j < half, with ω_{2·half} = w^{m/(2·half)}."""
    parts = []
    for s in range(m.bit_length() - 1):
        wm = pow(w, m >> (s + 1), field.p)
        parts.append(field.host_to_mont(field.host_powers_pow2(wm, 1 << s)))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=64)
def _device_table(table, m: int, w: int, field: Field, device: torch.device):
    """table(m, w, field) (a host numpy twiddle table) on `device`."""
    return fp.from_host(table(m, w, field), device)


def _row_transform(kernel: str, x: torch.Tensor, w: int, field: Field, table, plain):
    """The two row kernels' shared wrapper: checks x, then launches
    ``zk_<kernel>`` on a CUDA tensor (or raises) or runs `plain` on a CPU
    tensor. Returns (out, whether the kernel was launched)."""
    _build.require(x, kernel, 2)
    batch, m = x.shape
    if m < 2 or m > MAX_ROW or m & (m - 1):
        raise ValueError(f"{kernel}: row length {m} is not a power of two in [2, {MAX_ROW}]")
    if x.device.type == "cpu":
        return plain(x, table(m, w, field), field), False
    out = torch.empty_like(x)
    if batch == 0:
        return out, False
    tw_d = _device_table(table, m, w, field, x.device)
    launch = getattr(_build.kernels(), f"zk_{kernel}")
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(),
            out.data_ptr(),
            tw_d.data_ptr(),
            m.bit_length() - 1,
            batch,
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, kernel)
    return out, True


def ntt_rows_plain(x: torch.Tensor, tw: np.ndarray, field: Field = FIELD101):
    """Plain-torch twin of the kernel: bit-reversal gather, then the radix-2
    DIT stages over whole rows. x (batch, m) uint32, natural order in/out."""
    b, m = x.shape
    br = torch.from_numpy(bit_reverse_indices(m).astype(np.int64)).to(x.device)
    v = fp.wide(x)[:, br]
    tw_w = torch.from_numpy(tw.astype(np.int64)).to(x.device)
    half = 1
    while half < m:
        blk = v.reshape(b, m // (2 * half), 2 * half)
        e = blk[..., :half]
        o = fp.mont_mul_w(field, blk[..., half:], tw_w[half - 1 : 2 * half - 1])
        v = torch.cat([fp.add_w(field, e, o), fp.sub_w(field, e, o)], dim=-1)
        v = v.reshape(b, m)
        half *= 2
    return fp.narrow(v)


def ntt_rows(x: torch.Tensor, w: int, field: Field = FIELD101) -> torch.Tensor:
    """Length-m transform with root w (standard form, exact order m) of every
    row of x (batch, m) uint32; natural order in and out. A CUDA tensor runs
    the kernel; a CPU tensor runs `ntt_rows_plain`."""
    global ntt_launches
    out, launched = _row_transform("ntt_rows", x, w, field, stage_twiddles, ntt_rows_plain)
    ntt_launches += launched
    return out


@functools.lru_cache(maxsize=None)
def pease_twiddles(m: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(m/2,) uint32 Montgomery table tw[j] = w^j for a length-m Pease
    transform with root w. Stage t reads W_t[i] = tw[(i >> t) << t]; the
    TPU's lane-padded (m/2, 128) table of every stage is not carried over."""
    return field.host_to_mont(field.host_powers_pow2(w, m // 2))


def ntt_rows_pease_plain(x: torch.Tensor, tw: np.ndarray, field: Field = FIELD101):
    """Plain-torch twin of the Pease kernel: log2(m) identical stages
    a = T + B, b = W_t·(T − B), x' = interleave(a, b) over whole rows (no
    multiply in the last stage, whose twiddles are all w^0). x (batch, m)
    uint32; natural order in, bit-reversed order out."""
    b, m = x.shape
    h = m // 2
    stages = m.bit_length() - 1
    i = torch.arange(h, device=x.device)
    tw_w = torch.from_numpy(tw.astype(np.int64)).to(x.device)
    v = fp.wide(x)
    for t in range(stages):
        top, bot = v[:, :h], v[:, h:]
        a = fp.add_w(field, top, bot)
        d = fp.sub_w(field, top, bot)
        if t < stages - 1:
            d = fp.mont_mul_w(field, d, tw_w[(i >> t) << t])
        v = torch.stack([a, d], dim=-1).reshape(b, m)
    return fp.narrow(v)


def ntt_rows_pease(x: torch.Tensor, w: int, field: Field = FIELD101) -> torch.Tensor:
    """Length-m transform with root w of every row of x (batch, m) uint32:
    natural order in, BIT-REVERSED order out. A CUDA tensor runs the Pease
    kernel; a CPU tensor runs `ntt_rows_pease_plain`."""
    global pease_launches
    out, launched = _row_transform(
        "ntt_rows_pease", x, w, field, pease_twiddles, ntt_rows_pease_plain
    )
    pease_launches += launched
    return out


def _transpose(x: torch.Tensor) -> torch.Tensor:
    return fp.as_u32(fp.as_i32(x).t().contiguous())


def _transpose_gather(x: torch.Tensor, br: np.ndarray) -> torch.Tensor:
    """Rows br of x.T (x's columns in the order br), in one gather pass."""
    idx = torch.from_numpy(br.astype(np.int64)).to(x.device)
    return fp.as_u32(fp.as_i32(x).t().index_select(0, idx))


@functools.lru_cache(maxsize=None)
def _fourstep_constants(
    n: int, w: int, inverse_scale: int | None, field: Field = FIELD101
):
    """n = n1·n2 (n1 ≥ n2) and the transposed twiddle factors U.T, V.T
    (host numpy, contiguous).

    The twiddle matrix T[k1, j2] = w^{k1·j2} is not built: with
    j2 = vblk·jh + jl it factors exactly as U[k1, jh]·V[k1, jl],
    U = (w^{vblk})^{k1·jh} (n1 × n2/vblk) and V = w^{k1·jl} (n1 × vblk),
    vblk = min(128, n2). An INTT's 1/n folds into U."""
    bits = n.bit_length() - 1
    b1 = (bits + 1) // 2
    n1, n2 = 1 << b1, 1 << (bits - b1)
    u, v = _twiddle_uv_host(n1, n2, w, inverse_scale, field)
    return n1, n2, np.ascontiguousarray(u.T), np.ascontiguousarray(v.T)


@functools.lru_cache(maxsize=None)
def _pease_fourstep_constants(
    n: int, w: int, inverse_scale: int | None, field: Field = FIELD101
):
    """The Pease route's constants: `_fourstep_constants` with the columns
    of U.T and V.T permuted by br1 (pass 1 leaves k1 bit-reversed along
    dim 1), and the row orders br1, br2 that undo each pass."""
    n1, n2, ut, vt = _fourstep_constants(n, w, inverse_scale, field)
    br1, br2 = bit_reverse_indices(n1), bit_reverse_indices(n2)
    return n1, n2, np.ascontiguousarray(ut[:, br1]), np.ascontiguousarray(vt[:, br1]), br1, br2


def _twiddle_uv_host(
    n1: int, n2: int, w: int, inverse_scale: int | None, field: Field = FIELD101
):
    """U, V as uint32 Montgomery numpy. inverse_scale (Montgomery form) is
    folded into U as a plain residue multiply before the final to_mont."""
    vblk = min(_VBLK, n2)
    rows = field.host_powers_pow2(w, n1)  # w^{k1} residues
    v = field.host_vandermonde(rows, vblk)  # (n1, vblk): w^{k1·jl}
    rows_blk = field.host_pow_vec(rows, vblk)  # (w^{vblk})^{k1}
    u = field.host_vandermonde(rows_blk, n2 // vblk).astype(np.uint64)
    if inverse_scale is not None:
        s = inverse_scale * pow(fp.R, field.p - 2, field.p) % field.p
        u = (u * np.uint64(s)) % np.uint64(field.p)
    return field.host_to_mont(u.astype(np.uint32)), field.host_to_mont(v)


def _apply_twiddle_t(at: torch.Tensor, ut, vt, field: Field = FIELD101):
    """at[j2, k1]·w^{k1·j2} on the transposed (n2, n1) layout, with
    j2 = vblk·jh + jl: times U.T[jh, k1], then V.T[jl, k1]."""
    n2, n1 = at.shape
    vblk = vt.shape[0]
    a3 = fp.wide(at).reshape(n2 // vblk, vblk, n1)
    uw = fp.wide(fp.from_host(ut, at.device))
    vw = fp.wide(fp.from_host(vt, at.device))
    out = fp.mont_mul_w(field, fp.mont_mul_w(field, a3, uw[:, None, :]), vw[None])
    return fp.narrow(out).reshape(n2, n1)


def ntt_fourstep(
    x: torch.Tensor,
    n: int,
    w: int,
    inverse_scale: int | None = None,
    field: Field = FIELD101,
) -> torch.Tensor:
    """Size-n transform of a flat Montgomery vector with root w (standard
    form), natural order in and out. With inverse_scale (Montgomery n^{-1})
    it is a complete INTT. The route (`pease_enabled`) is read at each call."""
    p = field.p
    if pease_enabled():
        n1, n2, ut, vt, br1, br2 = _pease_fourstep_constants(n, w, inverse_scale, field)
        at = _transpose(x.reshape(n1, n2))  # row j2: x[j1·n2 + j2] over j1
        at = ntt_rows_pease(at, pow(w, n2, p), field)  # [j2, br1(k1)]
        tw = _apply_twiddle_t(at, ut, vt, field)  # U.T, V.T columns in br1 order
        b = _transpose_gather(tw, br1)  # (n1, n2): [k1, j2]
        d = ntt_rows_pease(b, pow(w, n1, p), field)  # [k1, br2(k2)]
        return _transpose_gather(d, br2).reshape(n)  # X[k1 + n1·k2]
    n1, n2, ut, vt = _fourstep_constants(n, w, inverse_scale, field)
    at = _transpose(x.reshape(n1, n2))  # row j2: x[j1·n2 + j2] over j1
    at = ntt_rows(at, pow(w, n2, p), field)  # [j2, k1]
    b = _transpose(_apply_twiddle_t(at, ut, vt, field))  # (n1, n2): [k1, j2]
    d = ntt_rows(b, pow(w, n1, p), field)  # [k1, k2]
    return _transpose(d).reshape(n)  # X[k1 + n1·k2]
