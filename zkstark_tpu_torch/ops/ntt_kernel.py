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
a (rows, cols) matrix whose missing tail is zero and writes (cols, rows), for
a batch of such matrices in one launch, its output rows in bit-reversed order
where asked (``brev=``). Its elements may be blocks of words (``elem=``): the
sharded six-step (``parallel/ntt_sharded.py``) cuts each row into one
contiguous chunk a shard.

A flat size-n transform (n = n1·n2, n ≥ `MIN_FOURSTEP`) is the four-step
factorization

    X[k1 + n1·k2] = Σ_{j2} ω^{j2·k1} (ω^{n1})^{j2·k2} · Σ_{j1} x[j1·n2+j2] (ω^{n2})^{j1·k1}

  1. transpose to (n2, n1)                                       [kernel E]
  2. row-transform with root ω^{n2}, pre-scale on load, twiddle
     ω^{k1·j2} = U[k1, jh]·V[k1, jl] on store                    [kernel B]
  3. transpose to (n1, n2)                                       [kernel E]
  4. row-transform with root ω^{n1}, post-scale on store         [kernel B]
  5. transpose back, so the flat result is in natural order      [kernel E]

A batch of B transforms, a (B, ≤ n) input, takes the same 5 launches: the
transposes take B stacked matrices, and the row kernels B·n2 (B·n1) rows
whose factors repeat with a period of n2 (n1) rows (``period=``: the factors
of row r are those of row r mod period), so every transform's rows take the
same pre-scale, twiddle and post-scale.

On a CUDA tensor every step is a hand-written kernel and every table is on
the device already (`_device_uv`, `_geo_tables`, `_device_table`, each
cached). On a CPU tensor each wrapper runs its plain-torch twin, which takes
the same arguments.

With ``ZKSTARK_PEASE=on`` (the JAX package's own switch, `pease_enabled`,
read at every call) both passes run `ntt_rows_pease` instead (CUDA kernel D,
``csrc/ntt_pease.cu``): the constant-geometry DIF transform of
``_ntt_cols_pease_kernel`` under the contract of `ntt_rows`. Its rows come
out in the TPU kernel's bit-reversed order (``bitrev=True``), the U.T and V.T
columns in that order too (`_device_uv`, ``brev``), and the transposes of
steps 3 and 5 put them back in natural order as they write (``brev=True``):
the same 5 launches as the DIT route, and no other op.

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
from typing import NamedTuple

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ntt.core import bit_reverse_indices
from zkstark_tpu_torch.ops import _build, tables

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


@tables.device_table(64)
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


@tables.device_table(256)
def _geo_tables(base: int, size: int, field: Field, device: torch.device):
    """`_geo_tables_host` on `device`, uploaded once."""
    a, b, s = _geo_tables_host(base, size, field)
    return fp.from_host(a, device), fp.from_host(b, device), s


def _geo_factor_plain(geo: GeoScale, rows: int, cols: int, field: Field, device,
                      period: int | None = None):
    """The plain twin's factor matrix, (rows, cols) or (1, cols) int64; row
    r takes the factors of row r mod `period` where given."""
    a, b, s = _geo_tables(geo.base % field.p, geo.size, field, torch.device(device))
    i = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    r = torch.arange(rows if geo.row_stride else 1, dtype=torch.int64, device=device)[:, None]
    if period is not None:
        r = r % period
    e = i * geo.col_stride + r * geo.row_stride
    return fp.mont_mul_w(field, fp.wide(a)[e >> s], fp.wide(b)[e & ((1 << s) - 1)])


def _check_rows_args(x, m, pre, post, uv, what="ntt_rows", shortest=2, longest=MAX_ROW,
                     period=None):
    """The checks of the row-transform contract (`ntt_rows`, `ntt_rows_pease`,
    and `limb_dft.limb_dft_rows` with its own bounds on the row length).
    `period` (a power of two dividing the batch) is the rows of one
    transform, whose factors every further period of rows repeats; by
    default, all rows."""
    _build.require(x, what, 2)
    batch, valid = x.shape
    m = valid if m is None else m
    if m < shortest or m > longest or m & (m - 1):
        raise ValueError(
            f"{what}: row length {m} is not a power of two in [{shortest}, {longest}]"
        )
    if valid < 1 or valid > m:
        raise ValueError(f"{what}: rows of {valid} words do not fit a length-{m} transform")
    if period is not None and (period < 1 or period & (period - 1) or batch % period):
        raise ValueError(f"{what}: a period of {period} rows does not divide {batch} rows")
    rows = batch if period is None else period
    for geo in (pre, post):
        if geo is None:
            continue
        size = geo.size
        last = (m - 1) * geo.col_stride + (rows - 1) * geo.row_stride
        if size < 1 or size & (size - 1) or size > 1 << 31 or (rows and last >= size):
            raise ValueError(f"{what}: {geo} does not cover a ({rows}, {m}) block")
    if uv is not None:
        ut, vt = uv
        for t in (ut, vt):
            _build.require(t, f"{what} twiddle", 2)
            if t.device != x.device or t.shape[1] != m:
                raise ValueError(f"{what}: twiddle tables must be (·, m) on the input's device")
        vblk = vt.shape[0]
        if vblk < 1 or vblk & (vblk - 1) or ut.shape[0] * vblk != rows:
            raise ValueError(
                f"{what}: twiddle tables {tuple(ut.shape)}, {tuple(vt.shape)} do not "
                f"cover {rows} rows"
            )
    return batch, valid, m


def _pmask(period: int | None) -> int:
    """The kernels' row mask: the factors of row r are those of r & mask."""
    return 0xFFFFFFFF if period is None else period - 1


def load_plain(x: torch.Tensor, m: int, pre: GeoScale | None, field: Field,
               period: int | None = None) -> torch.Tensor:
    """What a row kernel does on load, as whole-tensor ops: the pre-scale
    and the zero tail. x (batch, valid) uint32 → (batch, m) int64."""
    b, valid = x.shape
    v = fp.wide(x)
    if pre is not None:
        v = fp.mont_mul_w(field, v, _geo_factor_plain(pre, b, valid, field, x.device, period))
    if valid < m:
        v = torch.cat([v, torch.zeros((b, m - valid), dtype=torch.int64, device=x.device)], dim=1)
    return v


def _twiddle_plain(v: torch.Tensor, uv, field: Field) -> torch.Tensor:
    """v (batch, m) int64 times the four-step twiddle U.T[r' // vblk, i]·
    V.T[r' % vblk, i], r' the row within its period (U.T's rows times vblk)."""
    uw, vw = fp.wide(uv[0]), fp.wide(uv[1])
    v4 = v.reshape(-1, uw.shape[0], vw.shape[0], v.shape[1])
    v4 = fp.mont_mul_w(field, fp.mont_mul_w(field, v4, uw[None, :, None, :]), vw[None, None])
    return v4.reshape(v.shape)


def _scale_plain(v: torch.Tensor, post: GeoScale | None, scale, field: Field,
                 period: int | None = None) -> torch.Tensor:
    """v (batch, m) int64 times the post-scale and the scalar."""
    b, m = v.shape
    if post is not None:
        v = fp.mont_mul_w(field, v, _geo_factor_plain(post, b, m, field, v.device, period))
    if scale is not None:
        v = fp.mont_mul_w(field, v, scale)
    return v


def store_plain(v: torch.Tensor, post: GeoScale | None, uv, scale, field: Field,
                period: int | None = None) -> torch.Tensor:
    """What a row kernel does on store: the U·V twiddle, the post-scale and
    the scalar. v (batch, m) int64 → uint32."""
    if uv is not None:
        v = _twiddle_plain(v, uv, field)
    return fp.narrow(_scale_plain(v, post, scale, field, period))


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
    period: int | None = None,
) -> torch.Tensor:
    """Plain-torch twin of the kernel, same arguments: the scales and the
    zero tail as whole-tensor ops around a bit-reversal gather and the
    radix-2 DIT stages."""
    b, valid = x.shape
    m = valid if m is None else m
    v = load_plain(x, m, pre, field, period)
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
    return store_plain(v, post, uv, scale, field, period)


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
    period: int | None = None,
) -> torch.Tensor:
    """Length-m transform with root w (standard form, exact order m) of every
    row of x (batch, valid ≤ m) uint32, the tail of each row up to m (default:
    valid) taken as zero; natural order in and out, result (batch, m).
    `pre` scales on load, `uv` (the device tables U.T, V.T), `post` and
    `scale` (a Montgomery scalar) on store; with `period`, row r takes the
    factors of row r mod period. A CUDA tensor runs the kernel; a CPU tensor
    runs `ntt_rows_plain`."""
    global ntt_launches
    batch, valid, m = _check_rows_args(x, m, pre, post, uv, period=period)
    if x.device.type == "cpu":
        return ntt_rows_plain(x, w, field, m=m, pre=pre, post=post, uv=uv, scale=scale,
                              period=period)
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
            _pmask(period),
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, "ntt_rows")
    ntt_launches += 1
    return out


def transpose_plain(
    x: torch.Tensor, rows: int, cols: int, elem: int = 1, *, brev: bool = False
) -> torch.Tensor:
    """Plain-torch twin of `transpose`: zero-pad each matrix, view,
    ``.transpose(1, 2)``, and with `brev` a gather of the output rows."""
    batch = 1 if x.dim() == 1 else x.shape[0]
    flat = fp.as_i32(x).reshape(batch, x.shape[-1])
    per = rows * cols * elem
    if flat.shape[1] < per:
        pad = torch.zeros((batch, per - flat.shape[1]), dtype=torch.int32, device=x.device)
        flat = torch.cat([flat, pad], dim=1)
    out = flat.reshape(batch, rows, cols, elem).transpose(1, 2)
    if brev:
        out = out[:, torch.from_numpy(bit_reverse_indices(cols).astype(np.int64)).to(x.device)]
    return fp.as_u32(out.contiguous().reshape(batch * cols, rows * elem))


def transpose(
    x: torch.Tensor, rows: int, cols: int, elem: int = 1, *, brev: bool = False
) -> torch.Tensor:
    """The (cols, rows) transpose of the row-major (rows, cols) matrix whose
    first words are the flat uint32 vector x and whose missing tail is zero;
    for a (batch, valid) x, of each of its rows, stacked: (batch·cols, rows).
    With `elem` > 1 (a power of two, and rows one too) an element is a block
    of `elem` consecutive words: (rows, cols, elem) → (cols, rows, elem),
    returned as (batch·cols, rows·elem). With `brev` (elem 1, cols a power of
    two) output row c is input column brev(c). A CUDA tensor runs the kernel;
    a CPU tensor runs `transpose_plain`."""
    global transpose_launches
    if x.dim() not in (1, 2):
        raise ValueError(f"transpose: needs a flat vector or a batch of them, got {tuple(x.shape)}")
    _build.require(x, "transpose", x.dim())
    batch, valid = (1, x.shape[0]) if x.dim() == 1 else x.shape
    if rows < 1 or cols < 1 or valid > rows * cols * elem or rows > 65535 * 32:
        raise ValueError(f"transpose: {valid} words do not fit a ({rows}, {cols}) matrix")
    if elem < 1 or elem & (elem - 1) or (elem > 1 and rows & (rows - 1)):
        raise ValueError(f"transpose: blocks of {elem} words need powers of two (rows {rows})")
    if brev and (elem > 1 or cols & (cols - 1)):
        raise ValueError(f"transpose: bit-reversed rows need words and a power of two (cols {cols})")
    if elem == 1 and batch > 65535:
        raise ValueError(f"transpose: {batch} matrices in one launch, at most 65535")
    if x.device.type == "cpu":
        return transpose_plain(x, rows, cols, elem, brev=brev)
    out = torch.empty((batch * cols, rows * elem), dtype=torch.uint32, device=x.device)
    if batch == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_transpose(
            x.data_ptr(), out.data_ptr(), rows, cols, elem, valid, batch, int(brev),
            _build.stream(x),
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


def _pease_stages(v: torch.Tensor, w: int, field: Field) -> torch.Tensor:
    """The Pease transform of the rows of v (batch, m) int64: log2(m)
    identical stages a = T + B, b = W_t·(T − B), x' = interleave(a, b) (no
    multiply in the last stage, whose twiddles are all w^0); natural order
    in, bit-reversed order out."""
    b, m = v.shape
    h = m // 2
    stages = m.bit_length() - 1
    i = torch.arange(h, device=v.device)
    tw_w = torch.from_numpy(pease_twiddles(m, w, field).astype(np.int64)).to(v.device)
    for t in range(stages):
        top, bot = v[:, :h], v[:, h:]
        a = fp.add_w(field, top, bot)
        d = fp.sub_w(field, top, bot)
        if t < stages - 1:
            d = fp.mont_mul_w(field, d, tw_w[(i >> t) << t])
        v = torch.stack([a, d], dim=-1).reshape(b, m)
    return v


def ntt_rows_pease_plain(
    x: torch.Tensor,
    w: int,
    field: Field = FIELD101,
    *,
    m: int | None = None,
    pre: GeoScale | None = None,
    post: GeoScale | None = None,
    uv: tuple | None = None,
    scale: int | None = None,
    period: int | None = None,
    bitrev: bool = False,
) -> torch.Tensor:
    """Plain-torch twin of the Pease kernel, same arguments: the load of
    `ntt_rows_plain`, the Pease stages, then in natural order the post-scale
    (at the frequency) and the scalar; with `bitrev`, the columns permuted by
    bit reversal; last the U·V twiddle, by the column as stored."""
    b, valid = x.shape
    m = valid if m is None else m
    v = _pease_stages(load_plain(x, m, pre, field, period), w, field)
    br = torch.from_numpy(bit_reverse_indices(m).astype(np.int64)).to(x.device)
    v = _scale_plain(v[:, br], post, scale, field, period)  # natural order
    if bitrev:
        v = v[:, br]
    if uv is not None:
        v = _twiddle_plain(v, uv, field)
    return fp.narrow(v)


def ntt_rows_pease(
    x: torch.Tensor,
    w: int,
    field: Field = FIELD101,
    *,
    m: int | None = None,
    pre: GeoScale | None = None,
    post: GeoScale | None = None,
    uv: tuple | None = None,
    scale: int | None = None,
    period: int | None = None,
    bitrev: bool = False,
) -> torch.Tensor:
    """`ntt_rows` (same arguments, same result) on the Pease kernel; with
    `bitrev` the result's columns come in bit-reversed order (column i holds
    frequency brev(i), the order of the TPU kernel), the post-scale still
    taken at the frequency and the U·V tables read by the column as stored
    (hand them over with their columns permuted, `_device_uv`). A CUDA tensor
    runs the Pease kernel; a CPU tensor runs `ntt_rows_pease_plain`."""
    global pease_launches
    batch, valid, m = _check_rows_args(x, m, pre, post, uv, "ntt_rows_pease", period=period)
    if x.device.type == "cpu":
        return ntt_rows_pease_plain(x, w, field, m=m, pre=pre, post=post, uv=uv, scale=scale,
                                    period=period, bitrev=bitrev)
    out = torch.empty((batch, m), dtype=torch.uint32, device=x.device)
    if batch == 0:
        return out
    tw_d = _device_table(pease_twiddles, m, w, field, x.device)
    ut, vt = uv if uv is not None else (None, None)
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_ntt_rows_pease(
            x.data_ptr(),
            out.data_ptr(),
            tw_d.data_ptr(),
            m.bit_length() - 1,
            batch,
            valid,
            *_geo_args(pre, field, x.device),
            *_geo_args(post, field, x.device),
            None if ut is None else ut.data_ptr(),
            None if vt is None else vt.data_ptr(),
            0 if vt is None else vt.shape[0].bit_length() - 1,
            0 if scale is None else scale,
            0 if scale is None else 1,
            _pmask(period),
            int(bitrev),
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, "ntt_rows_pease")
    pease_launches += 1
    return out


class FourStepPlan(NamedTuple):
    """The constants of one (n, w, scale) four-step: its factors and the
    transposed twiddle tables (host numpy, contiguous). The row kernels take
    their stage roots from the root itself, so a plan holds no stage tables."""

    n1: int
    n2: int
    ut: np.ndarray  # U.T, (n2 / vblk, n1)
    vt: np.ndarray  # V.T, (vblk, n1)


@functools.lru_cache(maxsize=None)
def _fourstep_constants(
    n: int, w: int, inverse_scale: int | None, field: Field = FIELD101
) -> FourStepPlan:
    """n = n1·n2 (n1 ≥ n2) and the transposed twiddle factors U.T, V.T.

    The twiddle matrix T[k1, j2] = w^{k1·j2} is not built: with
    j2 = vblk·jh + jl it factors exactly as U[k1, jh]·V[k1, jl],
    U = (w^{vblk})^{k1·jh} (n1 × n2/vblk) and V = w^{k1·jl} (n1 × vblk),
    vblk = min(128, n2). An INTT's 1/n folds into U."""
    n1, n2 = split(n)
    u, v = _twiddle_uv_host(n1, n2, w, inverse_scale, field)
    return FourStepPlan(n1, n2, np.ascontiguousarray(u.T), np.ascontiguousarray(v.T))


def _twiddle_uv_host(
    n1: int, n2: int, w: int, inverse_scale: int | None, field: Field = FIELD101,
    vblk: int | None = None,
):
    """U, V as uint32 Montgomery numpy, V of width vblk (default
    min(128, n2)). inverse_scale (Montgomery form) is folded into U as a plain
    residue multiply before the final to_mont."""
    vblk = min(_VBLK, n2) if vblk is None else vblk
    rows = field.host_powers_pow2(w, n1)  # w^{k1} residues
    v = field.host_vandermonde(rows, vblk)  # (n1, vblk): w^{k1·jl}
    rows_blk = field.host_pow_vec(rows, vblk)  # (w^{vblk})^{k1}
    u = field.host_vandermonde(rows_blk, n2 // vblk).astype(np.uint64)
    if inverse_scale is not None:
        s = inverse_scale * pow(fp.R, field.p - 2, field.p) % field.p
        u = (u * np.uint64(s)) % np.uint64(field.p)
    return field.host_to_mont(u.astype(np.uint32)), field.host_to_mont(v)


@tables.device_table(64)
def _device_uv(
    n: int, w: int, inverse_scale: int | None, field: Field, device: torch.device,
    brev: bool = False,
):
    """(n1, n2, U.T, V.T) of `_fourstep_constants` with the tables on
    `device`, uploaded once; with `brev` their columns in bit-reversed order,
    the order in which ``ntt_rows_pease(bitrev=True)`` stores its columns."""
    n1, n2, ut, vt = _fourstep_constants(n, w, inverse_scale, field)
    if brev:
        br = bit_reverse_indices(n1)
        ut, vt = np.ascontiguousarray(ut[:, br]), np.ascontiguousarray(vt[:, br])
    return n1, n2, fp.from_host(ut, device), fp.from_host(vt, device)


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
    order in and out; or of each row of a (B, ≤ n) batch x, in the same five
    launches, giving (B, n). With inverse_scale (Montgomery n^{-1}) it is a
    complete INTT. Input j is first multiplied by pre_offset^j and output k
    last by post_offset^k (standard-form residues), where given.

    The route is read at each call, by the rule of the JAX package: both
    passes run `limb_dft.limb_dft_rows` when ``ZKSTARK_MXU=on`` or n1 exceeds
    `MAX_ROW` (n > 2^26), provided both factors are within its range; else
    `ntt_rows_pease` under ``ZKSTARK_PEASE=on``; else `ntt_rows`. The three
    share one contract, so the glue below is the same for all; the Pease
    rows stay in bit-reversed column order, which the transposes after them
    undo."""
    from zkstark_tpu_torch.ops import limb_dft

    if x.dim() not in (1, 2):
        raise ValueError(f"ntt_fourstep: needs a flat vector or a batch of them, got {tuple(x.shape)}")
    _build.require(x, "ntt_fourstep", x.dim())
    k = x.shape[-1]
    if k > n:
        raise ValueError(f"ntt_fourstep: {k} words do not fit a size-{n} transform")
    n1, n2 = split(n)
    limbs_fit = limb_dft.mxu_supported(n1) and limb_dft.mxu_supported(n2)
    if n1 > MAX_ROW and not limbs_fit:
        raise ValueError(
            f"ntt_fourstep: no route for a size-{n} transform (2^{n.bit_length() - 1}); "
            f"the largest supported size is 2^{MAX_FOURSTEP.bit_length() - 1}"
        )
    p = field.p
    limbs = (limb_dft.mxu_enabled() or n1 > MAX_ROW) and limbs_fit
    pease = pease_enabled() and not limbs
    rows = limb_dft.limb_dft_rows if limbs else ntt_rows_pease if pease else ntt_rows
    order = dict(bitrev=True) if pease else {}  # the Pease rows stay bit-reversed
    batch = 1 if x.dim() == 1 else x.shape[0]
    if batch == 0:
        return torch.empty((0, n), dtype=torch.uint32, device=x.device)
    n1, n2, ut, vt = _device_uv(n, w, inverse_scale, field, x.device, pease)
    # element (row j2, column j1) is input j1·n2 + j2
    pre = None if pre_offset is None else GeoScale(pre_offset, n, col_stride=n2, row_stride=1)
    # element (row k1, column k2) is output k1 + n1·k2
    post = None if post_offset is None else GeoScale(post_offset, n, col_stride=n1, row_stride=1)
    filled = -(-k // n2)  # rows of each (n1, n2) view that hold input
    at = transpose(x.reshape(batch, k), filled, n2)  # row j2: x[j1·n2 + j2] over j1 < filled
    at = rows(at, pow(w, n2, p), field, m=n1, pre=pre, uv=(ut, vt), period=n2,
              **order)  # [j2, k1]·ω^{k1·j2}
    b = transpose(at.reshape(batch, n), n2, n1, brev=pease)  # (n1, n2) each: [k1, j2]
    del at
    d = rows(b, pow(w, n1, p), field, post=post, period=n1, **order)  # [k1, k2]
    del b
    out = transpose(d.reshape(batch, n), n1, n2, brev=pease)  # X[k1 + n1·k2]
    return out.reshape(x.shape[:-1] + (n,))
