"""NTT row transforms on Hopper (CUDA kernel B, ``csrc/ntt.cu``), the tiled
transpose (kernel E, ``csrc/transpose.cu``) and the four-step glue.

`ntt_rows` replaces the Pallas kernel ``zkstark_tpu/ops/ntt_kernel.py``
``_ntt_cols_kernel`` (and, on the card, the jnp radix-2 chain of
``zkstark_tpu/ntt/core.py`` ``_butterflies`` below 2^14) together with the
elementwise glue XLA fused around it on the TPU. One thread block runs one
length-m transform (m ≤ 8192): a Stockham autosort between two shared-memory
buffers, radix 8 with a thread's 8 words in registers (5 passes and 5
barriers at m = 8192), natural order in and out with no bit-reversed scatter,
16-byte loads and stores. Its contract covers the whole LDE:

  * the row may hold fewer than m words; the missing tail counts as zero and
    is neither allocated nor read (``m=``);
  * on load, word (row r, column i) is multiplied by base^e, e = i·col_stride
    + r·row_stride, taken as A[e >> s]·B[e & (2^s − 1)] from two small cached
    device tables (``pre=``, a `GeoScale`: the coset offset);
  * on store, by the four-step twiddle U.T[r // vblk, i]·V.T[r % vblk, i]
    (``uv=``), by another `GeoScale` (``post=``: the inverse coset offset) and
    by a scalar (``scale=``: an INTT's 1/n).

`transpose` replaces the transposes XLA fused into the JAX four-step; it reads
a (rows, cols) matrix whose missing tail is zero and writes (cols, rows).

A flat size-n transform (n = n1·n2, n ≥ `MIN_FOURSTEP`) is the four-step
factorization

    X[k1 + n1·k2] = Σ_{j2} ω^{j2·k1} (ω^{n1})^{j2·k2} · Σ_{j1} x[j1·n2+j2] (ω^{n2})^{j1·k1}

  1. transpose to (n2, n1)                                       [kernel E]
  2. row-transform with root ω^{n2}, pre-scale on load, twiddle
     ω^{k1·j2} = U[k1, jh]·V[k1, jl] on store                    [kernel B]
  3. transpose to (n1, n2)                                       [kernel E]
  4. row-transform with root ω^{n1}, post-scale on store         [kernel B]
  5. transpose back, so the flat result is in natural order      [kernel E]

On a CUDA tensor every step is a hand-written kernel and every table is on
the device already (`_device_uv`, `_geo_tables`, `_device_table`, each
cached). On a CPU tensor each wrapper runs its plain-torch twin, which takes
the same arguments.

With ``ZKSTARK_PEASE=on`` (the JAX package's own switch, `pease_enabled`,
read at every call) both passes run `ntt_rows_pease` instead (CUDA kernel D,
``csrc/ntt_pease.cu``): the constant-geometry DIF transform of
``_ntt_cols_pease_kernel``, natural rows in and bit-reversed rows out, with
plain-torch glue. The bit-reversals then fall along dim 1; they are undone
without a strided pass: the columns of U.T and V.T are permuted by br1 (host
constants), and the transposes of steps 3 and 5 become row gathers of the
transposed views.

Past 2^26 points n1 exceeds `MAX_ROW`, and both passes run
`limb_dft.limb_dft_rows` instead (CUDA kernel H, ``csrc/limb_dft.cu``: the
limb-matrix DFT on the tensor cores, rows up to 16384), which takes the
contract of `ntt_rows`, so steps 1 to 5 stay as they are, up to 2^28
(`fourstep_supported`). ``ZKSTARK_MXU=on`` (the JAX package's switch) takes
that route wherever both factors are at least 128.

Outputs equal the radix-2 transform exactly (pure field identities).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
from zkstark_tpu_torch.ops import _build

MAX_ROW = 8192  # longest row one block transforms
MIN_FOURSTEP = 1 << 14  # flat transforms from this size take the four-step glue
MAX_FOURSTEP = 1 << 28  # the largest four-step size: both factors 16384, the longest limb-DFT row
_VBLK = 128  # width of the V factor of the four-step twiddle (capped at n2)

ntt_launches = 0  # launches of the CUDA kernel, counted by ntt_rows
transpose_launches = 0  # launches of the transpose kernel, counted by transpose
pease_launches = 0  # launches of the Pease kernel, counted by ntt_rows_pease


def pease_enabled() -> bool:
    """The four-step route, read at each call as the JAX package reads it
    (``zkstark_tpu/ops/ntt_kernel.py`` ``pease_enabled``): ``ZKSTARK_PEASE=on``
    takes `ntt_rows_pease`, anything else `ntt_rows`. The switch does not
    apply where the limb-matrix route carries the transform (a factor above
    `MAX_ROW`, or ``ZKSTARK_MXU=on``): it is then ignored, not refused."""
    return os.environ.get("ZKSTARK_PEASE", "off") == "on"


@functools.lru_cache(maxsize=None)
def stage_twiddles(m: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(m−1,) uint32 Montgomery stage table of the radix-2 transform (the
    plain twin's): stage s (half = 2^s) sits at offset half−1 and holds
    ω_{2·half}^j for j < half, with ω_{2·half} = w^{m/(2·half)}."""
    parts = []
    for s in range(m.bit_length() - 1):
        wm = pow(w, m >> (s + 1), field.p)
        parts.append(field.host_to_mont(field.host_powers_pow2(wm, 1 << s)))
    return np.concatenate(parts)


def pass_radices(m: int) -> list[int]:
    """The kernel's Stockham passes for a length-m row: radix 8 as often as
    it fits, then one radix-4 or radix-2 pass for the stages left over."""
    bits = m.bit_length() - 1
    return [8] * (bits // 3) + ([1 << (bits % 3)] if bits % 3 else [])


@functools.lru_cache(maxsize=None)
def pass_twiddles(m: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(m−1,) uint32 Montgomery pass table of the kernel: the pass of radix R
    at Ns (the product of the radices before it) sits at offset Ns−1 and
    holds W^{r·q} at (r−1)·Ns + q for 1 ≤ r < R, q < Ns, W = w^{m/(R·Ns)}."""
    parts, ns = [], 1
    for radix in pass_radices(m):
        wq = field.host_powers_pow2(pow(w, m // (radix * ns), field.p), ns)  # W^q
        for r in range(1, radix):
            parts.append(field.host_to_mont(field.host_pow_vec(wq, r)))
        ns *= radix
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _radix8_constants(m: int, w: int, field: Field) -> tuple[int, int, int]:
    """W8, W8² = W4 and W8³ in Montgomery form for W8 = w^{m/8}: the inner
    twiddles of a radix-8 (and radix-4) pass; 0 where m is too short."""
    w8 = pow(w, m // 8, field.p) if m >= 8 else 0
    w4 = pow(w, m // 4, field.p) if m >= 4 else 0
    return (
        field.mont_scalar(w8) if m >= 8 else 0,
        field.mont_scalar(w4) if m >= 4 else 0,
        field.mont_scalar(pow(w8, 3, field.p)) if m >= 8 else 0,
    )


@functools.lru_cache(maxsize=64)
def _device_table(table, m: int, w: int, field: Field, device: torch.device):
    """table(m, w, field) (a host numpy twiddle table) on `device`."""
    return fp.from_host(table(m, w, field), device)


@dataclass(frozen=True)
class GeoScale:
    """Word (row r, column i) times base^e, e = i·col_stride + r·row_stride
    < size (a power of two); base is a standard-form residue."""

    base: int
    size: int
    col_stride: int = 1
    row_stride: int = 0


@functools.lru_cache(maxsize=None)
def _geo_tables_host(base: int, size: int, field: Field = FIELD101):
    """(A, B, s): base^e = A[e >> s]·B[e & (2^s − 1)] for e < size, as
    uint32 Montgomery numpy; 2^s entries in B, size/2^s in A."""
    s = (size.bit_length() - 1) // 2
    b = field.host_powers_pow2(base, 1 << s)
    a = field.host_powers_pow2(pow(base, 1 << s, field.p), size >> s)
    return field.host_to_mont(a), field.host_to_mont(b), s


@functools.lru_cache(maxsize=256)
def _geo_tables(base: int, size: int, field: Field, device: torch.device):
    """`_geo_tables_host` on `device`, uploaded once."""
    a, b, s = _geo_tables_host(base, size, field)
    return fp.from_host(a, device), fp.from_host(b, device), s


def _geo_factor_plain(geo: GeoScale, rows: int, cols: int, field: Field, device):
    """The plain twin's factor matrix, (rows, cols) or (1, cols) int64."""
    a, b, s = _geo_tables(geo.base % field.p, geo.size, field, torch.device(device))
    i = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    r = torch.arange(rows if geo.row_stride else 1, dtype=torch.int64, device=device)[:, None]
    e = i * geo.col_stride + r * geo.row_stride
    return fp.mont_mul_w(field, fp.wide(a)[e >> s], fp.wide(b)[e & ((1 << s) - 1)])


def _check_rows_args(x, m, pre, post, uv, what="ntt_rows", shortest=2, longest=MAX_ROW):
    """The checks of the row-transform contract (`ntt_rows`, and
    `limb_dft.limb_dft_rows` with its own bounds on the row length)."""
    _build.require(x, what, 2)
    batch, valid = x.shape
    m = valid if m is None else m
    if m < shortest or m > longest or m & (m - 1):
        raise ValueError(
            f"{what}: row length {m} is not a power of two in [{shortest}, {longest}]"
        )
    if valid < 1 or valid > m:
        raise ValueError(f"{what}: rows of {valid} words do not fit a length-{m} transform")
    for geo in (pre, post):
        if geo is None:
            continue
        size = geo.size
        last = (m - 1) * geo.col_stride + (batch - 1) * geo.row_stride
        if size < 1 or size & (size - 1) or size > 1 << 31 or (batch and last >= size):
            raise ValueError(f"{what}: {geo} does not cover a ({batch}, {m}) block")
    if uv is not None:
        ut, vt = uv
        for t in (ut, vt):
            _build.require(t, f"{what} twiddle", 2)
            if t.device != x.device or t.shape[1] != m:
                raise ValueError(f"{what}: twiddle tables must be (·, m) on the input's device")
        vblk = vt.shape[0]
        if vblk < 1 or vblk & (vblk - 1) or ut.shape[0] * vblk != batch:
            raise ValueError(
                f"{what}: twiddle tables {tuple(ut.shape)}, {tuple(vt.shape)} do not "
                f"cover {batch} rows"
            )
    return batch, valid, m


def load_plain(x: torch.Tensor, m: int, pre: GeoScale | None, field: Field) -> torch.Tensor:
    """What a row kernel does on load, as whole-tensor ops: the pre-scale
    and the zero tail. x (batch, valid) uint32 → (batch, m) int64."""
    b, valid = x.shape
    v = fp.wide(x)
    if pre is not None:
        v = fp.mont_mul_w(field, v, _geo_factor_plain(pre, b, valid, field, x.device))
    if valid < m:
        v = torch.cat([v, torch.zeros((b, m - valid), dtype=torch.int64, device=x.device)], dim=1)
    return v


def store_plain(v: torch.Tensor, post: GeoScale | None, uv, scale, field: Field) -> torch.Tensor:
    """What a row kernel does on store: the U·V twiddle, the post-scale and
    the scalar. v (batch, m) int64 → uint32."""
    b, m = v.shape
    if uv is not None:
        uw, vw = fp.wide(uv[0]), fp.wide(uv[1])
        v3 = v.reshape(uw.shape[0], vw.shape[0], m)
        v3 = fp.mont_mul_w(field, fp.mont_mul_w(field, v3, uw[:, None, :]), vw[None])
        v = v3.reshape(b, m)
    if post is not None:
        v = fp.mont_mul_w(field, v, _geo_factor_plain(post, b, m, field, v.device))
    if scale is not None:
        v = fp.mont_mul_w(field, v, scale)
    return fp.narrow(v)


def ntt_rows_plain(
    x: torch.Tensor,
    w: int,
    field: Field = FIELD101,
    *,
    m: int | None = None,
    pre: GeoScale | None = None,
    post: GeoScale | None = None,
    uv: tuple | None = None,
    scale: int | None = None,
) -> torch.Tensor:
    """Plain-torch twin of the kernel, same arguments: the scales and the
    zero tail as whole-tensor ops around a bit-reversal gather and the
    radix-2 DIT stages."""
    b, valid = x.shape
    m = valid if m is None else m
    v = load_plain(x, m, pre, field)
    br = torch.from_numpy(bit_reverse_indices(m).astype(np.int64)).to(x.device)
    v = v[:, br]
    tw_w = torch.from_numpy(stage_twiddles(m, w, field).astype(np.int64)).to(x.device)
    half = 1
    while half < m:
        blk = v.reshape(b, m // (2 * half), 2 * half)
        e = blk[..., :half]
        o = fp.mont_mul_w(field, blk[..., half:], tw_w[half - 1 : 2 * half - 1])
        v = torch.cat([fp.add_w(field, e, o), fp.sub_w(field, e, o)], dim=-1)
        v = v.reshape(b, m)
        half *= 2
    return store_plain(v, post, uv, scale, field)


def _geo_args(geo: GeoScale | None, field: Field, device) -> tuple:
    """(a, b, shift, col_stride, row_stride) as the kernel takes them; the
    tables stay alive in `_geo_tables`' cache."""
    if geo is None:
        return None, None, 0, 0, 0
    a, b, s = _geo_tables(geo.base % field.p, geo.size, field, device)
    return a.data_ptr(), b.data_ptr(), s, geo.col_stride, geo.row_stride


def ntt_rows(
    x: torch.Tensor,
    w: int,
    field: Field = FIELD101,
    *,
    m: int | None = None,
    pre: GeoScale | None = None,
    post: GeoScale | None = None,
    uv: tuple | None = None,
    scale: int | None = None,
) -> torch.Tensor:
    """Length-m transform with root w (standard form, exact order m) of every
    row of x (batch, valid ≤ m) uint32, the tail of each row up to m (default:
    valid) taken as zero; natural order in and out, result (batch, m).
    `pre` scales on load, `uv` (the device tables U.T, V.T), `post` and
    `scale` (a Montgomery scalar) on store. A CUDA tensor runs the kernel; a
    CPU tensor runs `ntt_rows_plain`."""
    global ntt_launches
    batch, valid, m = _check_rows_args(x, m, pre, post, uv)
    if x.device.type == "cpu":
        return ntt_rows_plain(x, w, field, m=m, pre=pre, post=post, uv=uv, scale=scale)
    out = torch.empty((batch, m), dtype=torch.uint32, device=x.device)
    if batch == 0:
        return out
    tw_d = _device_table(pass_twiddles, m, w, field, x.device)
    ut, vt = uv if uv is not None else (None, None)
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_ntt_rows(
            x.data_ptr(),
            out.data_ptr(),
            tw_d.data_ptr(),
            m.bit_length() - 1,
            batch,
            valid,
            *_radix8_constants(m, w, field),
            *_geo_args(pre, field, x.device),
            *_geo_args(post, field, x.device),
            None if ut is None else ut.data_ptr(),
            None if vt is None else vt.data_ptr(),
            0 if vt is None else vt.shape[0].bit_length() - 1,
            0 if scale is None else scale,
            0 if scale is None else 1,
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, "ntt_rows")
    ntt_launches += 1
    return out


def transpose_plain(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Plain-torch twin of `transpose`: zero-pad, view, ``.t().contiguous()``."""
    flat = fp.as_i32(x)
    if flat.shape[0] < rows * cols:
        pad = torch.zeros(rows * cols - flat.shape[0], dtype=torch.int32, device=x.device)
        flat = torch.cat([flat, pad])
    return fp.as_u32(flat.reshape(rows, cols).t().contiguous())


def transpose(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The (cols, rows) transpose of the row-major (rows, cols) matrix whose
    first words are the flat uint32 vector x and whose missing tail is zero.
    A CUDA tensor runs the kernel; a CPU tensor runs `transpose_plain`."""
    global transpose_launches
    _build.require(x, "transpose", 1)
    if rows < 1 or cols < 1 or x.shape[0] > rows * cols or rows > 65535 * 32:
        raise ValueError(f"transpose: {x.shape[0]} words do not fit a ({rows}, {cols}) matrix")
    if x.device.type == "cpu":
        return transpose_plain(x, rows, cols)
    out = torch.empty((cols, rows), dtype=torch.uint32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_transpose(
            x.data_ptr(), out.data_ptr(), rows, cols, x.shape[0], _build.stream(x)
        )
    _build.check(rc, "transpose")
    transpose_launches += 1
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
    _build.require(x, "ntt_rows_pease", 2)
    batch, m = x.shape
    if m < 2 or m > MAX_ROW or m & (m - 1):
        raise ValueError(f"ntt_rows_pease: row length {m} is not a power of two in [2, {MAX_ROW}]")
    if x.device.type == "cpu":
        return ntt_rows_pease_plain(x, pease_twiddles(m, w, field), field)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    tw_d = _device_table(pease_twiddles, m, w, field, x.device)
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_ntt_rows_pease(
            x.data_ptr(),
            out.data_ptr(),
            tw_d.data_ptr(),
            m.bit_length() - 1,
            batch,
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, "ntt_rows_pease")
    pease_launches += 1
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
    n1, n2 = split(n)
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
    """The Pease route's twiddle in plain torch: at[j2, k1]·w^{k1·j2} on the
    transposed (n2, n1) layout, with j2 = vblk·jh + jl: times U.T[jh, k1],
    then V.T[jl, k1]."""
    n2, n1 = at.shape
    vblk = vt.shape[0]
    a3 = fp.wide(at).reshape(n2 // vblk, vblk, n1)
    uw = fp.wide(fp.from_host(ut, at.device))
    vw = fp.wide(fp.from_host(vt, at.device))
    out = fp.mont_mul_w(field, fp.mont_mul_w(field, a3, uw[:, None, :]), vw[None])
    return fp.narrow(out).reshape(n2, n1)


@functools.lru_cache(maxsize=64)
def _device_uv(n: int, w: int, inverse_scale: int | None, field: Field, device: torch.device):
    """(n1, n2, U.T, V.T) of `_fourstep_constants` with the tables on
    `device`, uploaded once."""
    n1, n2, ut, vt = _fourstep_constants(n, w, inverse_scale, field)
    return n1, n2, fp.from_host(ut, device), fp.from_host(vt, device)


def _fourstep_pease(x, n: int, w: int, inverse_scale, field: Field, pre, post):
    """The Pease route, with plain-torch glue around `ntt_rows_pease`."""
    p = field.p
    if x.shape[0] < n:
        x = fp.as_u32(torch.cat([fp.as_i32(x), fp.as_i32(fp.zeros(n - x.shape[0], x.device))]))
    if pre is not None:
        x = fp.mont_mul_f(field, x, fp.narrow(_geo_factor_plain(pre, 1, n, field, x.device)[0]))
    n1, n2, ut, vt, br1, br2 = _pease_fourstep_constants(n, w, inverse_scale, field)
    at = _transpose(x.reshape(n1, n2))  # row j2: x[j1·n2 + j2] over j1
    at = ntt_rows_pease(at, pow(w, n2, p), field)  # [j2, br1(k1)]
    tw = _apply_twiddle_t(at, ut, vt, field)  # U.T, V.T columns in br1 order
    b = _transpose_gather(tw, br1)  # (n1, n2): [k1, j2]
    d = ntt_rows_pease(b, pow(w, n1, p), field)  # [k1, br2(k2)]
    out = _transpose_gather(d, br2).reshape(n)  # X[k1 + n1·k2]
    if post is not None:
        out = fp.mont_mul_f(field, out, fp.narrow(_geo_factor_plain(post, 1, n, field, x.device)[0]))
    return out


def split(n: int) -> tuple[int, int]:
    """n = n1·n2 with n1 = 2^ceil(log2(n)/2) ≥ n2."""
    bits = n.bit_length() - 1
    b1 = (bits + 1) // 2
    return 1 << b1, 1 << (bits - b1)


def fourstep_supported(n: int) -> bool:
    """Whether `ntt_fourstep` has a route for size n (the JAX package's
    ``fourstep_supported``): `ntt_rows` carries both factors up to 2^26;
    beyond, the limb-matrix transform (`limb_dft.limb_dft_rows`) carries
    them up to 2^28."""
    from zkstark_tpu_torch.ops import limb_dft

    if n < MIN_FOURSTEP:
        return False
    n1, n2 = split(n)
    return n1 <= MAX_ROW or (limb_dft.mxu_supported(n1) and limb_dft.mxu_supported(n2))


def ntt_fourstep(
    x: torch.Tensor,
    n: int,
    w: int,
    inverse_scale: int | None = None,
    field: Field = FIELD101,
    *,
    pre_offset: int | None = None,
    post_offset: int | None = None,
) -> torch.Tensor:
    """Size-n transform with root w (standard form) of the flat Montgomery
    vector x of at most n words (the tail up to n taken as zero), natural
    order in and out. With inverse_scale (Montgomery n^{-1}) it is a complete
    INTT. Input j is first multiplied by pre_offset^j and output k last by
    post_offset^k (standard-form residues), where given.

    The route is read at each call, by the rule of the JAX package: both
    passes run `limb_dft.limb_dft_rows` when ``ZKSTARK_MXU=on`` or n1 exceeds
    `MAX_ROW` (n > 2^26), provided both factors are within its range; else
    `ntt_rows_pease` under ``ZKSTARK_PEASE=on``; else `ntt_rows`.
    `limb_dft_rows` and `ntt_rows` share one contract, so the glue below is
    the same for both."""
    from zkstark_tpu_torch.ops import limb_dft

    _build.require(x, "ntt_fourstep", 1)
    if x.shape[0] > n:
        raise ValueError(f"ntt_fourstep: {x.shape[0]} words do not fit a size-{n} transform")
    n1, n2 = split(n)
    limbs_fit = limb_dft.mxu_supported(n1) and limb_dft.mxu_supported(n2)
    if n1 > MAX_ROW and not limbs_fit:
        raise ValueError(
            f"ntt_fourstep: no route for a size-{n} transform (2^{n.bit_length() - 1}); "
            f"the largest supported size is 2^{MAX_FOURSTEP.bit_length() - 1}"
        )
    p = field.p
    pre = None if pre_offset is None else GeoScale(pre_offset, n)
    post = None if post_offset is None else GeoScale(post_offset, n)
    limbs = (limb_dft.mxu_enabled() or n1 > MAX_ROW) and limbs_fit
    if pease_enabled() and not limbs:
        return _fourstep_pease(x, n, w, inverse_scale, field, pre, post)
    rows = limb_dft.limb_dft_rows if limbs else ntt_rows
    n1, n2, ut, vt = _device_uv(n, w, inverse_scale, field, x.device)
    if pre is not None:  # element (row j2, column j1) is input j1·n2 + j2
        pre = GeoScale(pre_offset, n, col_stride=n2, row_stride=1)
    if post is not None:  # element (row k1, column k2) is output k1 + n1·k2
        post = GeoScale(post_offset, n, col_stride=n1, row_stride=1)
    filled = -(-x.shape[0] // n2)  # rows of the (n1, n2) view that hold input
    at = transpose(x, filled, n2)  # row j2: x[j1·n2 + j2] over j1 < filled
    at = rows(at, pow(w, n2, p), field, m=n1, pre=pre, uv=(ut, vt))  # [j2, k1]·ω^{k1·j2}
    b = transpose(at.reshape(n), n2, n1)  # (n1, n2): [k1, j2]
    d = rows(b, pow(w, n1, p), field, post=post)  # [k1, k2]
    return transpose(d.reshape(n), n1, n2).reshape(n)  # X[k1 + n1·k2]
