"""The limb-matrix DFT on Hopper (CUDA kernel H, ``csrc/limb_dft.cu``): the
row transform that carries the four-step NTT past 2^26 points.

`limb_dft_rows` is the counterpart of ``zkstark_tpu/ops/mxu_ntt.py``
(``dft_matmul`` + ``_recombine`` + ``col_transform_mxu``), for rows instead of
columns. A length-m transform, m = k1·k2 with both radices at most 128, is two
small DFTs around a pointwise twiddle,

    X[t + k1·s] = Σ_{j2} (w^{k1})^{j2·s} · w^{t·j2} · Σ_{j1} (w^{k2})^{t·j1} · x[j1·k2 + j2],

and each radix-k DFT y[i] = Σ_j W^{ij}·x[j] is an exact integer matrix product
over 8-bit limbs. With x̃[j] = Σ_a limb_a[j]·2^{8a} the Montgomery word and

    A[k·c + i, k·a + j] = byte_c( to_mont(W^{ij}) · 2^{8a} mod p )      (host, u8),

the four limb sums T_c[i] = Σ_{a,j} A[k·c+i, k·a+j]·limb_a[j] recombine to
V = Σ_c T_c·2^{8c} = Σ_{a,j} (to_mont(W^{ij})·2^{8a} mod p)·limb_a[j], which is
congruent to R·Σ_j W^{ij}·x̃[j]: one REDC of V is the output in Montgomery
form. No bit reversal anywhere: natural order in and out.

Exactness. A limb is at most 255 and a matrix entry's four bytes are those
of one residue below p, so V ≤ 4k·255·(p − 1) < 2^17·p for k ≤ 128, and each
T_c ≤ 255²·4k < 2^25 fits a signed 32-bit sum with no chunking of the
contraction. REDC (``csrc/fp.cuh`` `fp_reduce`, `fp.redc_w`) needs V < p·2^32
for its one conditional subtraction to land in [0, p), and that holds for
every odd prime below 2^32, small ones included: the bound scales with p
because the matrix is built modulo p. (The JAX package's ``_recombine`` was
suspected of failing below 2^25; the sum it feeds REDC is this same V, so no
field is refused here, and ``tests/test_torch_limb_dft.py`` holds primes down
to 257 against exact integers.) The inputs need not even be reduced below p.

The kernel keeps a row in shared memory; both stages are
``wgmma.mma_async.m64nNk32`` u8 × u8 → s32 tensor-core products with the limb
matrix as the A operand (streamed tile by tile through a ring in shared
memory, `_tile_words`) and the data words themselves as the B operand (a u32
word is its four limbs, packed), with the limb split, the recombination, the
REDC and the in-row twiddle inside the kernel: no limb tensor ever reaches
device memory. Its
contract is `ntt_kernel.ntt_rows`' (a short valid prefix, ``pre`` on load,
``uv``, ``post`` and ``scale`` on store), so the four-step glue does not
change with the route. On a CPU tensor `limb_dft_rows` runs
`limb_dft_rows_plain`, on a CUDA tensor only the kernel.

``ZKSTARK_MXU=on`` (the JAX package's switch, read at every call) sends every
four-step transform whose factors are supported through this route; above
2^26 it is the only route and is taken without the switch.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import FIELD101, Field
from zkstark_tpu_torch.ops import _build, ntt_kernel, tables
from zkstark_tpu_torch.ops.ntt_kernel import GeoScale

MIN_LIMB_ROW = 128
MAX_RADIX = 128
MAX_LIMB_ROW = MAX_RADIX * MAX_RADIX  # 16384: the four-step's n1 at 2^27 and 2^28

limb_launches = 0  # launches of limb_dft_rows_kernel, counted by limb_dft_rows


def mxu_enabled() -> bool:
    """``ZKSTARK_MXU=on`` takes the limb-matrix route wherever it is
    supported; read at every call, as the JAX package reads it."""
    return os.environ.get("ZKSTARK_MXU", "off") == "on"


def mxu_supported(m: int) -> bool:
    """Row length m = k1·k2 (`ntt_kernel.split`: k1 = 2^ceil(log2(m)/2) ≥ k2)
    with both radices at most 128 and m ≥ 128: up to 16384, so four-step
    sizes up to 2^28 (the JAX package's answers)."""
    return m >= MIN_LIMB_ROW and m & (m - 1) == 0 and ntt_kernel.split(m)[0] <= MAX_RADIX


@functools.lru_cache(maxsize=None)
def _limb_matrix(k: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(4k, 4k) uint8 limb matrix of the radix-k DFT with root w (order k):
    A[k·c+i, k·a+j] = byte_c( to_mont(w^{ij}) · 2^{8a} mod p ), the JAX
    package's fold of R and of the limb weight into the matrix."""
    p = np.uint64(field.p)
    rows = field.host_powers_pow2(w, k)  # w^i
    wm = field.host_to_mont(field.host_vandermonde(rows, k)).astype(np.uint64)  # to_mont(w^{ij})
    out = np.zeros((4 * k, 4 * k), dtype=np.uint8)
    for a in range(4):
        shifted = (wm << np.uint64(8 * a)) % p
        for c in range(4):
            out[c * k : (c + 1) * k, a * k : (a + 1) * k] = (shifted >> np.uint64(8 * c)) & np.uint64(0xFF)
    return out


@functools.lru_cache(maxsize=None)
def _col_twiddle(k1: int, k2: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """(k1, k2) Montgomery twiddle T[t, j2] = w^{t·j2} between the stages."""
    rows = field.host_powers_pow2(w, k1)
    return field.host_to_mont(field.host_vandermonde(rows, k2))


TILE_PAIR_ROWS = 32  # outputs i of one tile pair: 2 tiles x 64 rows (c, i)


@functools.lru_cache(maxsize=None)
def _tile_words(k: int, w: int, field: Field = FIELD101) -> np.ndarray:
    """`_limb_matrix` as the kernel reads it: flat uint32, tile by tile in the
    shared-memory layout of a ``wgmma`` A operand, so that a run of k-steps of
    a tile pair is one contiguous block for one bulk copy.

    The contraction index is reordered to 4·j + a, so that four neighbouring
    bytes of a matrix row pair with the four limbs of one data word:
    AW[c, i, j] = Σ_a A[k·c+i, k·a+j]·2^{8a}. The outputs i are padded with
    zero rows to a multiple of 32 (one tile pair). The words are laid out as
    [pair p][k-step ks][tile T][row group rg][K chunk kc][row r8][word jq]:

      * a k-step is 8 words j = 8·ks + 4·kc + jq (32 contraction bytes), two
        K chunks of 16 bytes;
      * a tile is 64 rows in 8 groups of 8; row 8·rg + r8 of tile T of pair p
        is (c, i) = (2·T + rg mod 2, 32·p + 8·(rg div 2) + r8): the thread
        that holds accumulator rows g and g + 8 of both tiles of a pair holds
        T_0..T_3 of output i = 32·p + 8·warp + g;
      * a core matrix (8 rows x 16 bytes, one (rg, kc)) is 128 contiguous
        bytes; the two K chunks of a row group lie 128 bytes apart, row groups
        256 bytes, tiles 2048, k-steps 4096."""
    a = _limb_matrix(k, w, field).astype(np.uint32).reshape(4, k, 4, k)  # [c, i, a, j]
    aw = (a << (8 * np.arange(4, dtype=np.uint32))[None, None, :, None]).sum(axis=2, dtype=np.uint32)
    pairs = -(-k // TILE_PAIR_ROWS)
    kp = pairs * TILE_PAIR_ROWS
    if kp > k:
        aw = np.concatenate([aw, np.zeros((4, kp - k, k), dtype=np.uint32)], axis=1)
    # c = 2·T + h, i = 32·p + 8·wq + r8, j = 8·ks + 4·kc + jq; rg = 2·wq + h
    # [T, h, p, wq, r8, ks, kc, jq] -> [p, ks, T, wq, h, kc, r8, jq]
    tiles = aw.reshape(2, 2, pairs, 4, 8, k // 8, 2, 4).transpose(2, 5, 0, 3, 1, 6, 4, 7)
    return np.ascontiguousarray(tiles).reshape(-1)


def _recombine(t: torch.Tensor, field: Field) -> torch.Tensor:
    """Limb sums t (…, 4, rows, cols) float64 (exact integers) → int64
    Montgomery words: V = Σ_c T_c·2^{8c}, one REDC."""
    ti = t.to(torch.int64)
    v = ti[..., 0, :, :] + (ti[..., 1, :, :] << 8) + (ti[..., 2, :, :] << 16) + (ti[..., 3, :, :] << 24)
    return fp.redc_w(field, v >> 32, v & 0xFFFFFFFF)


def _dft_plain(v: torch.Tensor, k: int, w: int, field: Field) -> torch.Tensor:
    """Radix-k DFT along dim 1 of v (b, k, cols) int64 words, as the limb
    matrix product in float64: every product is at most 255² and every sum
    below 2^26, so the arithmetic is exact on any device."""
    a = torch.from_numpy(_limb_matrix(k, w, field).astype(np.float64)).to(v.device)
    limbs = torch.cat([((v >> (8 * i)) & 0xFF).to(torch.float64) for i in range(4)], dim=1)
    t = torch.matmul(a, limbs)  # (b, 4k, cols): rows k·c + i
    return _recombine(t.reshape(v.shape[0], 4, k, v.shape[2]), field)


def limb_dft_rows_plain(
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
    """Plain-torch twin of the kernel, same arguments: the same limb
    matrices, recombination and twiddle as whole-tensor ops, a few rows at a
    time so that the float64 limb tensors stay small."""
    b, valid = x.shape
    m = valid if m is None else m
    k1, k2 = ntt_kernel.split(m)
    p = field.p
    w1, w2 = pow(w, k2, p), pow(w, k1, p)
    tw = fp.wide(fp.from_host(_col_twiddle(k1, k2, w, field), x.device))
    v = ntt_kernel.load_plain(x, m, pre, field, period)
    step = max(1, (1 << 22) // m)
    outs = []
    for r0 in range(0, b, step):
        x3 = v[r0 : r0 + step].reshape(-1, k1, k2)  # [j1, j2]
        a = fp.mont_mul_w(field, _dft_plain(x3, k1, w1, field), tw)  # [t, j2]·w^{t·j2}
        d = _dft_plain(a.transpose(1, 2), k2, w2, field)  # [s, t]: flat index t + k1·s
        outs.append(d.reshape(-1, m))
    out = torch.cat(outs) if outs else v
    return ntt_kernel.store_plain(out, post, uv, scale, field, period)


@tables.device_table(64)
def _device_constants(m: int, w: int, field: Field, device: torch.device):
    """The two tile-ordered limb matrices and the in-row twiddle of a
    length-m transform with root w, on `device`, uploaded once."""
    k1, k2 = ntt_kernel.split(m)
    p = field.p
    return (
        fp.from_host(_tile_words(k1, pow(w, k2, p), field), device),
        fp.from_host(_tile_words(k2, pow(w, k1, p), field), device),
        fp.from_host(_col_twiddle(k1, k2, w, field).reshape(-1), device),
    )


def limb_dft_rows(
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
    row of x (batch, valid ≤ m) uint32, 128 ≤ m ≤ 16384, the tail of each row
    up to m (default: valid) taken as zero; natural order in and out, result
    (batch, m), word for word that of `ntt_kernel.ntt_rows` (whose contract
    this is: `pre` scales on load, `uv`, `post` and `scale` on store, row r
    taking the factors of row r mod `period`). A CUDA tensor runs the kernel;
    a CPU tensor runs `limb_dft_rows_plain`."""
    global limb_launches
    batch, valid, m = ntt_kernel._check_rows_args(
        x, m, pre, post, uv, "limb_dft_rows", MIN_LIMB_ROW, MAX_LIMB_ROW, period
    )
    if x.device.type == "cpu":
        return limb_dft_rows_plain(x, w, field, m=m, pre=pre, post=post, uv=uv, scale=scale,
                                   period=period)
    out = torch.empty((batch, m), dtype=torch.uint32, device=x.device)
    if batch == 0:
        return out
    k1, k2 = ntt_kernel.split(m)
    af1, af2, tw = _device_constants(m, w, field, x.device)
    ut, vt = uv if uv is not None else (None, None)
    with torch.cuda.device(x.device):
        rc = _build.kernels().zk_limb_dft_rows(
            x.data_ptr(),
            out.data_ptr(),
            af1.data_ptr(),
            af2.data_ptr(),
            tw.data_ptr(),
            k1.bit_length() - 1,
            k2.bit_length() - 1,
            batch,
            valid,
            *ntt_kernel._geo_args(pre, field, x.device),
            *ntt_kernel._geo_args(post, field, x.device),
            None if ut is None else ut.data_ptr(),
            None if vt is None else vt.data_ptr(),
            0 if vt is None else vt.shape[0].bit_length() - 1,
            0 if scale is None else scale,
            0 if scale is None else 1,
            ntt_kernel._pmask(period),
            field.p,
            field.p_inv_neg,
            _build.stream(x),
        )
    _build.check(rc, "limb_dft_rows")
    limb_launches += 1
    return out
