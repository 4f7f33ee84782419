"""The CUDA kernels against their plain-torch twins, on the card.

Marked `cuda`: without a CUDA device every test here skips. The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes the prove path does not reach are covered here: ragged hash counts,
every row length 2..8192 for both row kernels (DIT and Pease, the Pease
kernel in both orders) at ragged batch sizes, each fused option of both
alone and all together, the batch period of the three row kernels, ragged
and batched transposes with a missing tail and bit-reversed rows, the second
prime, both four-step routes and batched LDEs on each, the
LDE entry points against the CPU, the Fiat-Shamir chain kernel at every entry
point and ragged chain counts, the FRI fold at every layer size from 2 words
up and ragged proof counts, the fused, batched and pipelined provers against
the host-synced one, the limb-matrix row transform at every row length
128..16384 with each fused option and the four-step on its route, the
composition kernel for the three AIRs and a program that reads x, the
wrappers' input checks, and `fp.cuh`'s arithmetic against exact integers.
`test_kernels_at_main_path_shapes` holds the kernels to their twins at the
calls the prove path makes, up to the 2^27-point LDE. Whole proofs are
`test_torch_cuda_proofs.py`'s.
"""

import math

import numpy as np
import pytest
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ntt import core as ntt_core
from zkstark_tpu_torch.ops import (
    composition,
    fri_fold,
    fs_chain,
    limb_dft,
    ntt_kernel,
    sha256_kernel,
)
from zkstark_tpu_torch.protocol import STARK101
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.air import AIRS
from zkstark_tpu_torch.protocol.config import StarkConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _eq(a, b):
    np.testing.assert_array_equal(fp.to_host(a), fp.to_host(b))


@pytest.mark.parametrize("n", [1, 3, 255, 257, 1000, 4096, 100_003])
def test_leaf_kernel_ragged(dev, n):
    vals = fp.from_host(_u32(n, n), dev)
    _eq(sha256_kernel.leaf_hash(vals), sha256_kernel.leaf_hash_plain(vals))


@pytest.mark.parametrize("k", [1, 3, 255, 257, 1000, 4096, 100_003])
def test_node_kernel_ragged(dev, k):
    children = fp.from_host(_u32((2 * k, 8), k), dev)
    _eq(sha256_kernel.node_hash_pairs(children), sha256_kernel.node_hash_pairs_plain(children))


FIELDS = pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])


def _rand_mont(field, shape, seed, dev):
    rng = np.random.default_rng(seed)
    return fp.from_host(field.host_to_mont(rng.integers(0, field.p, shape, dtype=np.uint64)), dev)


@FIELDS
@pytest.mark.parametrize("batch", [1, 3, 257])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_every_length(dev, field, log_m, batch):
    m = 1 << log_m
    x = _rand_mont(field, (batch, m), log_m, dev)
    w = ntt_core.forward_plan(m, field).root
    _eq(ntt_kernel.ntt_rows(x, w, field), ntt_kernel.ntt_rows_plain(x, w, field))


def _fused_options(field, batch, m, dev, seed):
    """Every fused option of `ntt_rows` for a (batch, m) block, by name."""
    geo = ntt_kernel.GeoScale
    vblk = 2 if batch % 2 == 0 else 1
    size = 1 << (2 * batch * m).bit_length()  # a power of two above every exponent
    return {
        "pre": dict(pre=geo(5, m)),
        "pre_rows": dict(pre=geo(7, size, col_stride=batch, row_stride=1)),
        "uv": dict(uv=(_rand_mont(field, (batch // vblk, m), seed + 1, dev),
                       _rand_mont(field, (vblk, m), seed + 2, dev))),
        "post": dict(post=geo(11, size, col_stride=batch, row_stride=1)),
        "scale": dict(scale=field.mont_scalar(pow(m, field.p - 2, field.p))),
    }


@FIELDS
@pytest.mark.parametrize("option", ["short", "pre", "pre_rows", "uv", "post", "scale", "all"])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_fused_options(dev, field, log_m, option):
    """Each fused option alone and all together, on a short valid prefix
    wherever a pre-scale is on, at an even and an odd batch."""
    m = 1 << log_m
    for batch in (3, 6):
        opts = _fused_options(field, batch, m, dev, 31 * log_m + batch)
        if option == "all":
            kw = {k: v for name in ("pre_rows", "uv", "post", "scale") for k, v in opts[name].items()}
        else:
            kw = opts.get(option, {})
        short = option in ("short", "pre", "pre_rows", "all")
        valid = max(1, m // 8 + (log_m % 2)) if short else m  # odd lengths take 4-byte loads
        x = _rand_mont(field, (batch, valid), log_m, dev)
        w = ntt_core.forward_plan(m, field).root
        got = ntt_kernel.ntt_rows(x, w, field, m=m, **kw)
        _eq(got, ntt_kernel.ntt_rows_plain(x, w, field, m=m, **kw))


def test_ntt_rows_unaligned_views(dev):
    """A row block that does not start on 16 bytes takes the 4-byte accesses."""
    field, m = fp.FIELD101, 64
    x = _rand_mont(field, 4 * m + 1, 5, dev)[1:].reshape(4, m)
    w = ntt_core.forward_plan(m, field).root
    _eq(ntt_kernel.ntt_rows(x, w, field), ntt_kernel.ntt_rows_plain(x, w, field))


@pytest.mark.parametrize(
    "rows,cols,missing",
    [(1, 1, 0), (32, 32, 0), (33, 65, 0), (7, 1000, 13), (1000, 7, 6999), (512, 4096, 4096 * 448),
     (257, 129, 1)],
)
def test_transpose_ragged(dev, rows, cols, missing):
    x = fp.from_host(_u32(rows * cols - missing, rows), dev)
    got = ntt_kernel.transpose(x, rows, cols)
    assert got.shape == (cols, rows)
    _eq(got, ntt_kernel.transpose_plain(x, rows, cols))


@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_pease_every_length(dev, field, log_m):
    """Both orders: natural (the `ntt_rows` contract) and bit-reversed (the
    TPU kernel's)."""
    m = 1 << log_m
    rng = np.random.default_rng(100 + log_m)
    x = fp.from_host(field.host_to_mont(rng.integers(0, field.p, (3, m), dtype=np.uint64)), dev)
    w = ntt_core.forward_plan(m, field).root
    for bitrev in (False, True):
        _eq(ntt_kernel.ntt_rows_pease(x, w, field, bitrev=bitrev),
            ntt_kernel.ntt_rows_pease_plain(x, w, field, bitrev=bitrev))
    _eq(ntt_kernel.ntt_rows_pease(x, w, field), ntt_kernel.ntt_rows(x, w, field))


@pytest.mark.parametrize("batch", [1, 2, 257])
@pytest.mark.parametrize("log_m", [1, 2, 3, 4, 5, 8, 11, 12, 13])
def test_ntt_rows_pease_ragged_batches(dev, log_m, batch):
    field, m = fp.FIELD101, 1 << log_m
    x = _rand_mont(field, (batch, m), 200 + log_m, dev)
    w = ntt_core.forward_plan(m, field).root
    for bitrev in (False, True):
        _eq(ntt_kernel.ntt_rows_pease(x, w, field, bitrev=bitrev),
            ntt_kernel.ntt_rows_pease_plain(x, w, field, bitrev=bitrev))


def test_ntt_rows_pease_edge_values(dev):
    """Rows of 0, 1 and p − 1 (standard and Montgomery) through every stage."""
    field, m = fp.FIELD101, 4096
    p = field.p
    rows = np.stack([np.full(m, v, dtype=np.uint32) for v in (0, 1, p - 1, field.r_mod_p)]
                    + [np.where(np.arange(m) % 2 == 0, p - 1, 0).astype(np.uint32)])
    x = fp.from_host(rows, dev)
    w = ntt_core.forward_plan(m, field).root
    for bitrev in (False, True):
        _eq(ntt_kernel.ntt_rows_pease(x, w, field, bitrev=bitrev),
            ntt_kernel.ntt_rows_pease_plain(x, w, field, bitrev=bitrev))


@FIELDS
@pytest.mark.parametrize("bitrev", [False, True], ids=["natural", "bitrev"])
@pytest.mark.parametrize("option", ["short", "pre", "pre_rows", "uv", "post", "scale", "all"])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_pease_fused_options(dev, field, log_m, option, bitrev):
    """The `ntt_rows` contract on the Pease kernel: each fused option alone
    and all together, a short valid prefix wherever a pre-scale is on, at an
    even and an odd batch, in both orders; in natural order equal to
    `ntt_rows` too."""
    m = 1 << log_m
    for batch in (3, 6):
        opts = _fused_options(field, batch, m, dev, 31 * log_m + batch)
        if option == "all":
            kw = {k: v for name in ("pre_rows", "uv", "post", "scale") for k, v in opts[name].items()}
        else:
            kw = opts.get(option, {})
        short = option in ("short", "pre", "pre_rows", "all")
        valid = max(1, m // 8 + (log_m % 2)) if short else m
        x = _rand_mont(field, (batch, valid), log_m, dev)
        w = ntt_core.forward_plan(m, field).root
        got = ntt_kernel.ntt_rows_pease(x, w, field, m=m, bitrev=bitrev, **kw)
        _eq(got, ntt_kernel.ntt_rows_pease_plain(x, w, field, m=m, bitrev=bitrev, **kw))
        if not bitrev:
            _eq(got, ntt_kernel.ntt_rows(x, w, field, m=m, **kw))


def _period_kernels():
    return {
        "ntt_rows": (ntt_kernel.ntt_rows, ntt_kernel.ntt_rows_plain, {}),
        "pease": (ntt_kernel.ntt_rows_pease, ntt_kernel.ntt_rows_pease_plain, {}),
        "pease_bitrev": (ntt_kernel.ntt_rows_pease, ntt_kernel.ntt_rows_pease_plain,
                         {"bitrev": True}),
        "limb": (limb_dft.limb_dft_rows, limb_dft.limb_dft_rows_plain, {}),
    }


PERIOD_CASES = [(k, log_m) for k in ("ntt_rows", "pease", "pease_bitrev")
                for log_m in (1, 2, 4, 10, 12, 13)] + [("limb", log_m) for log_m in (7, 10, 13, 14)]


@FIELDS
@pytest.mark.parametrize("kernel,log_m", PERIOD_CASES)
def test_row_kernels_period(dev, field, kernel, log_m):
    """``period=``: B transforms of `period` rows each in one launch take the
    factors of one transform (pre-scale, U·V twiddle, post-scale, scalar),
    equal to the plain twin and to B separate launches, distinct rows."""
    fn, plain, extra = _period_kernels()[kernel]
    m, period, copies = 1 << log_m, 4, 3
    geo = ntt_kernel.GeoScale
    size = 1 << (2 * period * m).bit_length()
    kw = dict(pre=geo(7, size, col_stride=period, row_stride=1),
              uv=(_rand_mont(field, (period // 2, m), 5, dev), _rand_mont(field, (2, m), 6, dev)),
              post=geo(11, size, col_stride=period, row_stride=1),
              scale=field.mont_scalar(3))
    valid = max(1, m // 4)
    x = _rand_mont(field, (copies * period, valid), log_m, dev)
    w = ntt_core.forward_plan(m, field).root
    got = fn(x, w, field, m=m, period=period, **kw, **extra)
    _eq(got, plain(x, w, field, m=m, period=period, **kw, **extra))
    for c in range(copies):
        one = fn(x[c * period : (c + 1) * period].contiguous(), w, field, m=m, **kw, **extra)
        _eq(got[c * period : (c + 1) * period], one)


@pytest.mark.parametrize(
    "batch,rows,cols,missing,brev",
    [(1, 32, 32, 0, True), (3, 33, 64, 0, True), (4, 7, 1024, 13, True), (5, 1000, 8, 6999, False),
     (2, 512, 4096, 4096 * 448, False), (16, 64, 128, 0, True), (2, 257, 2, 1, True),
     (3, 1, 1, 0, True)],
)
def test_transpose_batched(dev, batch, rows, cols, missing, brev):
    """B stacked matrices in one launch, each with a missing tail, output
    rows in bit-reversed order where asked, against the plain twin and one
    launch a matrix."""
    valid = rows * cols - missing
    x = fp.from_host(_u32((batch, valid), rows + batch), dev)
    moved = ntt_kernel.transpose_launches
    got = ntt_kernel.transpose(x, rows, cols, brev=brev)
    assert ntt_kernel.transpose_launches == moved + 1
    assert got.shape == (batch * cols, rows)
    _eq(got, ntt_kernel.transpose_plain(x, rows, cols, brev=brev))
    for b in range(batch):
        one = ntt_kernel.transpose(x[b].contiguous(), rows, cols, brev=brev)
        _eq(got[b * cols : (b + 1) * cols], one)


@pytest.mark.parametrize("batch,rows,cols,elem,missing", [(3, 16, 8, 8, 24), (2, 4, 3, 2, 5),
                                                          (4, 8, 2, 4, 64)])
def test_transpose_blocks_batched(dev, batch, rows, cols, elem, missing):
    x = fp.from_host(_u32((batch, rows * cols * elem - missing), rows + elem), dev)
    _eq(ntt_kernel.transpose(x, rows, cols, elem=elem),
        ntt_kernel.transpose_plain(x, rows, cols, elem=elem))


def _chain_inputs(lead, seed, dev):
    state = _u32(lead + (8,), seed)
    state[..., 0] |= 0x80000000  # the first draw of every chain is ≥ 2^31
    word = np.atleast_1d(_u32(lead, seed + 2) | np.uint32(0x80000000))
    return (fp.from_host(state, dev), fp.from_host(_u32(lead + (8,), seed + 1), dev),
            fp.from_host(word, dev).reshape(lead))


@FIELDS
@pytest.mark.parametrize("lead", [(), (1,), (5,), (64,), (257,), (3, 5)], ids=str)
def test_fs_chain_every_entry_point(dev, field, lead):
    state, digest, word = _chain_inputs(lead, 11 + len(lead), dev)
    cases = [
        dict(digest=digest),
        dict(word=word),
        dict(draws=1),
        dict(draws=4, query_range=8176),
        dict(digest=digest, draws=3),
        dict(digest=digest, word=word, draws=3, query_range=(1 << 32) - 1),
        dict(),
    ]
    for kw in cases:
        before = fs_chain.chain_launches
        got = fs_chain.chain_step(state, field=field, **kw)
        assert fs_chain.chain_launches == before + 1
        want = fs_chain.chain_step_plain(state, field=field, **kw)
        for g, w_ in zip(got, want):
            assert (g is None) == (w_ is None)
            if g is not None:
                assert g.shape == w_.shape
                _eq(g, w_)
    _eq(fs_chain.absorb_hash(state, digest), fs_chain.chain_step_plain(state, digest=digest)[0])
    _eq(fs_chain.absorb_u32_le(state, word), fs_chain.chain_step_plain(state, word=word)[0])
    for g, w_ in zip(fs_chain.draw(state, 2, field)[:3], fs_chain.chain_step_plain(state, draws=2, field=field)[:3]):
        _eq(g, w_)


def test_fs_chain_strided_digest(dev):
    """The roots of a batch of trees are rows of a (B, 1, 8) level."""
    state, _, _ = _chain_inputs((5,), 3, dev)
    level = fp.from_host(_u32((5, 4, 8), 9), dev)
    digest = level[:, 2]
    got = fs_chain.chain_step(state, digest=digest, draws=1)
    want = fs_chain.chain_step_plain(state.cpu(), digest=digest.cpu(), draws=1)
    for g, w_ in zip(got[:3], want[:3]):
        _eq(g, w_)


def test_fs_chain_strided_word_and_draws(dev):
    """The free term is read in place, word 0 of each row of the last
    layer, and the draws land in a column of the packed result's betas."""
    state, _, _ = _chain_inputs((5,), 4, dev)
    last = fp.from_host(_u32((5, 16), 10), dev)
    betas = fp.from_host(_u32((5, 3), 11), dev)
    want_betas = betas.cpu().clone()
    got = fs_chain.chain_step(state, word=last[:, 0], draws=1, draws_out=betas[:, 1:2])
    want = fs_chain.chain_step_plain(state.cpu(), word=last[:, 0].cpu(), draws=1,
                                     draws_out=want_betas[:, 1:2])
    for g, w_ in zip(got[:3], want[:3]):
        _eq(g, w_)
    _eq(betas, want_betas)


@FIELDS
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("log_m", [1, 2, 3, 4, 5, 9, 13, 16, 20])
def test_fri_fold_every_size(dev, field, log_m, batch):
    if batch == 64 and log_m > 13:
        pytest.skip("the batched prover folds small layers only")
    m = 1 << log_m
    p = field.p
    rng = np.random.default_rng(log_m * 7 + batch)
    vals = rng.integers(0, p, (batch, m), dtype=np.uint64).astype(np.uint32)
    vals[0, : min(m, 3)] = np.array([0, 1, p - 1], dtype=np.uint32)[: min(m, 3)]
    vals[-1, m // 2 :] = p - 1
    evals = fp.from_host(vals, dev)
    beta = fp.from_host(rng.integers(0, p, batch, dtype=np.uint64).astype(np.uint32), dev)
    base = field.subgroup_generator(m)
    inv_base, inv_off = pow(base, p - 2, p), pow(5, p - 2, p)
    before = fri_fold.fold_launches
    got = fri_fold.fri_fold(evals, beta, inv_base, inv_off, field)
    assert fri_fold.fold_launches == before + 1
    want = fri_fold.fri_fold_plain(evals, beta, inv_base, inv_off, field)
    for g, w_ in zip(got, want):
        assert g.shape == (batch, m // 2)
        _eq(g, w_)
    scalar = int(rng.integers(0, p))
    one = fp.as_u32(fp.as_i32(evals)[0].contiguous())
    for g, w_ in zip(fri_fold.fri_fold(one, scalar, inv_base, inv_off, field),
                     fri_fold.fri_fold_plain(one, scalar, inv_base, inv_off, field)):
        assert g.shape == (m // 2,)
        _eq(g, w_)


def test_fri_fold_unaligned_view(dev):
    """Rows that do not start on 16 bytes take the 4-byte accesses."""
    field, m = fp.FIELD101, 64
    x = _rand_mont(field, m + 1, 5, dev)[1:]
    base = field.subgroup_generator(m)
    args = (12345, pow(base, field.p - 2, field.p), 1, field)
    x = fp.as_u32(fp.as_i32(x))
    assert x.data_ptr() % 16
    for g, w_ in zip(fri_fold.fri_fold(x, *args), fri_fold.fri_fold_plain(x, *args)):
        _eq(g, w_)


def _small_cfg(trace_len=63, air_name="fibonacci-sq", secret=3141592, n_queries=1):
    air = AIRS[air_name]
    trace = air.trace(trace_len, secret)
    return StarkConfig(trace_len=trace_len, boundary_last=int(trace[-1]), air=air,
                       n_queries=n_queries)


@pytest.mark.parametrize("trace_len,n_queries", [(63, 1), (63, 3), (2047, 2)])
def test_fused_prove_on_card_equals_host_synced(dev, trace_len, n_queries):
    """The one-fetch path on the card gives the bytes of the host-synced path
    there and on the CPU; its core makes no call that waits once warm."""
    from zkstark_tpu_torch.protocol import fused, prove, verify

    cfg = _small_cfg(trace_len, n_queries=n_queries)
    want = prove(cfg, device="cpu", fused=False)
    assert prove(cfg, device=dev, fused=False) == want
    before = fs_chain.chain_launches, fri_fold.fold_launches
    assert prove(cfg, device=dev) == want
    assert fs_chain.chain_launches == before[0] + 2 + cfg.fri_rounds
    assert fri_fold.fold_launches == before[1] + cfg.fri_rounds
    verify(want, cfg)
    trace = pr.trace_to_device(cfg, 3141592, torch.device(dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = fused.PendingFetch(fused.fused_core_packed(cfg, trace))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pr.finish_fused(cfg, fused.unpack_out(cfg, pending.wait())) == want


def test_batch_and_pipelined_on_card(dev):
    from zkstark_tpu_torch.protocol import prove, prove_pipelined
    from zkstark_tpu_torch.protocol.batch import prove_batch, prove_batch_pipelined

    cfg = _small_cfg(255, "square-chain", secret=271828)
    want = prove(cfg, 271828, device="cpu", fused=False)
    assert prove_batch(cfg, [271828] * 5, device=dev) == [want] * 5
    assert prove_pipelined(cfg, [271828] * 4, depth=2, device=dev) == [want] * 4
    assert prove_batch_pipelined(cfg, [[271828] * 3] * 3, depth=1, device=dev) == [want] * 9
    with pytest.raises(ValueError):
        prove_batch(cfg, [271828, 5], device=dev)


def test_batched_fourstep_on_card(dev):
    """A batch at a four-step domain (2^14 points) of two distinct witnesses
    (s and p − s share the public output) equals the solo proofs; its LDE is
    one four-step, 5 launches, for the whole batch."""
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.protocol import prove
    from zkstark_tpu_torch.protocol.batch import prove_batch

    cfg = _small_cfg(2047, "square-chain", secret=271828)
    secrets = [271828, fp.P - 271828, 271828]
    want = [prove(cfg, s, device=dev, fused=False) for s in secrets]
    assert want[0] != want[1]
    ops.reset_launch_counts()
    assert prove_batch(cfg, secrets, device=dev) == want
    counts = ops.launch_counts()
    assert counts["transpose"] == 3


@FIELDS
@pytest.mark.parametrize("pease", ["off", "on"])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_batched_lde_on_card(dev, monkeypatch, field, pease, batch):
    """coset_ntt, intt and coset_intt of a batch of distinct rows at 2^14:
    one four-step (2 row launches, 3 transposes) each, equal to the CPU and
    to one transform a row."""
    monkeypatch.setenv("ZKSTARK_PEASE", pease)
    n = 1 << 14
    coeffs = _rand_mont(field, (batch, n // 8), batch, dev)
    rows = "pease_launches" if pease == "on" else "ntt_launches"
    before = getattr(ntt_kernel, rows), ntt_kernel.transpose_launches
    evals = ntt_core.coset_ntt(coeffs, n, 5, field)
    assert (getattr(ntt_kernel, rows), ntt_kernel.transpose_launches) == (before[0] + 2,
                                                                          before[1] + 3)
    _eq(evals, ntt_core.coset_ntt(coeffs.cpu(), n, 5, field))
    for b in range(batch):
        _eq(evals[b], ntt_core.coset_ntt(coeffs[b].contiguous(), n, 5, field))
    plan = ntt_core.inverse_plan(n, field)
    _eq(ntt_core.intt(evals, plan), ntt_core.intt(evals.cpu(), plan))
    back = ntt_core.coset_intt(evals, 5, field)
    _eq(back[:, : n // 8], coeffs)
    assert not fp.to_host(back)[:, n // 8 :].any()


@pytest.mark.parametrize("pease", ["off", "on"])
def test_fourstep_on_card_equals_cpu(dev, monkeypatch, pease):
    monkeypatch.setenv("ZKSTARK_PEASE", pease)
    n = 1 << 16
    x = fp.FIELD101.host_to_mont(_u32(n, 7) % fp.P)
    plan = ntt_core.forward_plan(n)
    counter = "pease_launches" if pease == "on" else "ntt_launches"
    before = getattr(ntt_kernel, counter)
    moved = ntt_kernel.transpose_launches
    _eq(ntt_core.ntt(fp.from_host(x, dev), plan), ntt_core.ntt(fp.from_host(x, "cpu"), plan))
    assert getattr(ntt_kernel, counter) == before + 2
    assert ntt_kernel.transpose_launches == moved + 3


@FIELDS
@pytest.mark.parametrize("pease", ["off", "on"])
@pytest.mark.parametrize("log_n", [10, 13, 14, 17])
def test_lde_entry_points_on_card_equal_cpu(dev, monkeypatch, field, pease, log_n):
    """coset_ntt of a short coefficient vector, intt and coset_intt."""
    monkeypatch.setenv("ZKSTARK_PEASE", pease)
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    coeffs = field.host_to_mont(rng.integers(0, field.p, n // 8, dtype=np.uint64))
    evals = ntt_core.coset_ntt(fp.from_host(coeffs, dev), n, 5, field)
    _eq(evals, ntt_core.coset_ntt(fp.from_host(coeffs, "cpu"), n, 5, field))
    back = ntt_core.coset_intt(evals, 5, field)
    np.testing.assert_array_equal(fp.to_host(back)[: n // 8], coeffs)
    assert not fp.to_host(back)[n // 8 :].any()
    plan = ntt_core.inverse_plan(n, field)
    _eq(ntt_core.intt(evals, plan), ntt_core.intt(evals.cpu(), plan))


def test_device_tables_upload_once(dev):
    """A second transform of the same size uploads no table."""
    n = 1 << 14
    x = _rand_mont(fp.FIELD101, n // 4, 3, dev)
    ntt_core.coset_ntt(x, n, 5)
    uv, geo = ntt_kernel._device_uv.cache_info(), ntt_kernel._geo_tables.cache_info()
    ntt_core.coset_ntt(x, n, 5)
    assert ntt_kernel._device_uv.cache_info().misses == uv.misses
    assert ntt_kernel._geo_tables.cache_info().misses == geo.misses
    assert ntt_kernel._device_uv.cache_info().hits == uv.hits + 1


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        sha256_kernel.leaf_hash(torch.zeros(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        sha256_kernel.node_hash_pairs(fp.from_host(_u32((3, 8), 1), dev))
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(fp.from_host(_u32((4, 8), 2), dev).t(), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(fp.from_host(_u32((1, 16384), 3), dev), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows(fp.from_host(_u32((2, 16), 3), dev), 1, m=8)
    with pytest.raises(ValueError):
        ntt_kernel.transpose(fp.from_host(_u32(65, 3), dev), 8, 8)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows_pease(fp.from_host(_u32((4, 8), 2), dev).t(), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows_pease(fp.from_host(_u32((1, 16384), 3), dev), 1)
    state = fp.from_host(_u32((4, 8), 1), dev)
    with pytest.raises(ValueError):
        fs_chain.chain_step(state, digest=fp.from_host(_u32((3, 8), 1), dev))
    with pytest.raises(ValueError):
        fs_chain.chain_step(state, word=fp.from_host(_u32(4, 1), "cpu"))
    with pytest.raises(ValueError):
        fs_chain.chain_step(state, draws=1, query_range=0)
    with pytest.raises(ValueError):
        fs_chain.chain_step(fp.from_host(_u32((4, 7), 1), dev))
    with pytest.raises(ValueError):
        fri_fold.fri_fold(fp.from_host(_u32((2, 12), 1), dev), 1, 1, 1)
    with pytest.raises(ValueError):
        fri_fold.fri_fold(fp.from_host(_u32((2, 16), 1), dev), fp.from_host(_u32(3, 1), dev), 1, 1)


@FIELDS
@pytest.mark.parametrize("batch", [1, 3, 130, 300])
@pytest.mark.parametrize("log_m", range(7, 15))
def test_limb_dft_rows_every_length(dev, field, log_m, batch):
    """Equal to its plain version and, up to 8192, to `ntt_rows`; 300 rows
    are more than the card has SMs, so a block takes several rows."""
    m = 1 << log_m
    x = _rand_mont(field, (batch, m), log_m, dev)
    w = ntt_core.forward_plan(m, field).root
    got = limb_dft.limb_dft_rows(x, w, field)
    _eq(got, limb_dft.limb_dft_rows_plain(x, w, field))
    if m <= ntt_kernel.MAX_ROW:
        _eq(got, ntt_kernel.ntt_rows(x, w, field))


@FIELDS
@pytest.mark.parametrize("option", ["short", "pre", "pre_rows", "uv", "post", "scale", "all"])
@pytest.mark.parametrize("log_m", range(7, 15))
def test_limb_dft_rows_fused_options(dev, field, log_m, option):
    """The `ntt_rows` contract on the limb route: each fused option alone and
    all together, on a short valid prefix wherever a pre-scale is on."""
    m = 1 << log_m
    for batch in (3, 6):
        opts = _fused_options(field, batch, m, dev, 31 * log_m + batch)
        if option == "all":
            kw = {k: v for name in ("pre_rows", "uv", "post", "scale") for k, v in opts[name].items()}
        else:
            kw = opts.get(option, {})
        short = option in ("short", "pre", "pre_rows", "all")
        valid = max(1, m // 8 + (log_m % 2)) if short else m  # odd lengths take 4-byte loads
        x = _rand_mont(field, (batch, valid), log_m, dev)
        w = ntt_core.forward_plan(m, field).root
        got = limb_dft.limb_dft_rows(x, w, field, m=m, **kw)
        _eq(got, limb_dft.limb_dft_rows_plain(x, w, field, m=m, **kw))


def test_limb_dft_rows_edge_words_and_views(dev):
    """Rows of p − 1 (the largest limb sums), words that are not reduced
    below p, a small prime, and a block that does not start on 16 bytes."""
    field, m = fp.FIELD101, 16384
    w = ntt_core.forward_plan(m, field).root
    x = fp.from_host(np.full((2, m), field.p - 1, dtype=np.uint32), dev)
    _eq(limb_dft.limb_dft_rows(x, w, field), limb_dft.limb_dft_rows_plain(x, w, field))
    raw = fp.from_host(_u32((3, m), 4) | np.uint32(0xFF0000FF), dev)
    _eq(limb_dft.limb_dft_rows(raw, w, field), limb_dft.limb_dft_rows_plain(raw, w, field))
    small = fp.field_for(786433)
    xs = _rand_mont(small, (5, 256), 6, dev)
    ws = small.subgroup_generator(256)
    _eq(limb_dft.limb_dft_rows(xs, ws, small), limb_dft.limb_dft_rows_plain(xs.cpu(), ws, small))
    view = _rand_mont(field, 4 * 1024 + 1, 5, dev)[1:].reshape(4, 1024)
    assert view.data_ptr() % 16
    w1k = ntt_core.forward_plan(1024, field).root
    _eq(limb_dft.limb_dft_rows(view, w1k, field), ntt_kernel.ntt_rows(view, w1k, field))


@pytest.mark.parametrize("log_n", [14, 15, 20])
def test_fourstep_limb_route_on_card(dev, monkeypatch, log_n):
    """ZKSTARK_MXU=on: both passes launch `limb_dft_rows` (and the three
    transposes), `ntt_rows` none; coset_ntt, intt and coset_intt equal the
    default route; ZKSTARK_PEASE=on beside it changes nothing."""
    field, n = fp.FIELD101, 1 << log_n
    coeffs = _rand_mont(field, n // 8, log_n, dev)
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    want = ntt_core.coset_ntt(coeffs, n, 5, field)
    want_back = ntt_core.coset_intt(want, 5, field)
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    before = limb_dft.limb_launches, ntt_kernel.ntt_launches, ntt_kernel.pease_launches
    got = ntt_core.coset_ntt(coeffs, n, 5, field)
    assert limb_dft.limb_launches == before[0] + 2
    assert (ntt_kernel.ntt_launches, ntt_kernel.pease_launches) == before[1:]
    _eq(got, want)
    _eq(ntt_core.coset_intt(got, 5, field), want_back)
    plan = ntt_core.inverse_plan(n, field)
    monkeypatch.delenv("ZKSTARK_MXU")
    monkeypatch.delenv("ZKSTARK_PEASE")
    want_intt = ntt_core.intt(want, plan)
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    _eq(ntt_core.intt(got, plan), want_intt)


def _composition_case(field, air_name, blowup, bsz, seed, dev):
    cfg = StarkConfig(field=field, air=AIRS[air_name], trace_len=1023, blowup=blowup,
                      boundary_first=1, boundary_last=1,
                      coset_offset=5 if field is fp.FIELD101 else 31)
    f = _rand_mont(field, (bsz, cfg.eval_domain), seed, dev)
    alphas = _rand_mont(field, (bsz, cfg.n_constraints), seed + 1, dev)
    return cfg, f, alphas


@FIELDS
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("blowup", [2, 4, 8, 16])
@pytest.mark.parametrize("air_name", ["fibonacci-sq", "fibonacci", "square-chain"])
def test_composition_kernel(dev, field, air_name, blowup, bsz):
    """One launch a batch; both outputs equal the AIR's own closures
    (`composition_eval_plain`) and the program's plain interpreter. Blowup 2
    takes the kernel's one-point-a-thread instance."""

    cfg, f, alphas = _composition_case(field, air_name, blowup, bsz, blowup + bsz, dev)
    before = composition.composition_launches
    cp, res = pr.composition_eval_res(cfg, f, alphas)
    assert composition.composition_launches == before + 1
    want = pr.composition_eval_plain(cfg, f, alphas)
    _eq(cp, want)
    _eq(res, fp.from_mont_f(field, want))
    plain = composition.composition_plain(
        f, pr.composition_constants(cfg, f.device), alphas, pr.composition_program(cfg), field)
    _eq(cp, plain[0])
    _eq(res, plain[1])
    # the host-synced prover's call: one proof, the alphas as Python ints
    ints = [int(a) for a in fp.to_host(alphas)[0]]
    cp0, res0 = pr.composition_eval_res(cfg, fp.as_u32(fp.as_i32(f)[0].contiguous()), ints)
    np.testing.assert_array_equal(fp.to_host(cp0), fp.to_host(cp)[0])
    np.testing.assert_array_equal(fp.to_host(res0), fp.to_host(res)[0])


def test_composition_kernel_reads_x_and_unaligned_views(dev):
    """A program with OP_X and OP_CONST against the plain interpreter, and an
    evaluation vector that does not start on 16 bytes."""

    field = fp.FIELD101
    cfg, f, alphas = _composition_case(field, "square-chain", 8, 2, 3, dev)
    base = pr.composition_program(cfg)
    ops = [(composition.OP_X, 0), (composition.OP_F, 0), (composition.OP_MUL, 0),
           (composition.OP_X, 0), (composition.OP_CONST, 7), (composition.OP_ADD, 0),
           (composition.OP_MUL, 0), (composition.OP_F, 1), (composition.OP_SUB, 0)]
    prog = composition.encode([("transition", ops), ("boundary", 11)], cfg.air.shifts, cfg.blowup,
                              cfg.eval_domain, base.generator, base.offset, field)
    inv = pr.composition_constants(cfg, f.device)
    got = composition.composition(f, inv, alphas, prog, field)
    want = composition.composition_plain(f, inv, alphas, prog, field)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    d = cfg.eval_domain
    view = _rand_mont(field, d + 1, 8, dev)[1:]
    assert view.data_ptr() % 16
    got = composition.composition(view, inv, alphas[:1], base, field)
    want = composition.composition_plain(view, inv, alphas[:1], base, field)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_composition_is_one_launch_a_proof(dev):
    """A fused prove launches the composition kernel once and a batch of
    five once; under ZKSTARK_MXU=on the proof at a four-step domain keeps its
    bytes."""
    from zkstark_tpu_torch.protocol import prove
    from zkstark_tpu_torch.protocol.batch import prove_batch

    cfg = _small_cfg(2047, "square-chain", secret=271828)
    want = prove(cfg, 271828, device="cpu", fused=False)
    before = composition.composition_launches
    assert prove(cfg, 271828, device=dev) == want
    assert composition.composition_launches == before + 1
    assert prove(cfg, 271828, device=dev, fused=False) == want
    assert composition.composition_launches == before + 2
    assert prove_batch(cfg, [271828] * 5, device=dev) == [want] * 5
    assert composition.composition_launches == before + 3


def test_limb_route_proof_on_card(dev, monkeypatch):
    from zkstark_tpu_torch.protocol import prove

    cfg = _small_cfg(2047, "square-chain", secret=271828)
    want = prove(cfg, 271828, device="cpu", fused=False)
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    before = limb_dft.limb_launches
    assert prove(cfg, 271828, device=dev) == want
    assert limb_dft.limb_launches == before + 2  # the 2^14 LDE's two passes


def test_new_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        limb_dft.limb_dft_rows(fp.from_host(_u32((1, 64), 3), dev), 1)
    with pytest.raises(ValueError):
        limb_dft.limb_dft_rows(fp.from_host(_u32((1, 32768), 3), dev), 1)
    with pytest.raises(ValueError):
        limb_dft.limb_dft_rows(fp.from_host(_u32((4, 128), 2), dev).t(), 1)
    with pytest.raises(ValueError, match="2\\^28"):
        ntt_kernel.ntt_fourstep(fp.from_host(_u32(8, 1), dev), 1 << 29, 1)

    cfg, f, alphas = _composition_case(fp.FIELD101, "square-chain", 8, 1, 3, dev)
    inv, prog = pr.composition_constants(cfg, f.device), pr.composition_program(cfg)
    with pytest.raises(ValueError):
        composition.composition(f, inv.cpu(), alphas, prog)
    with pytest.raises(ValueError):
        composition.composition(f, inv, alphas.cpu(), prog)
    with pytest.raises(TypeError):
        composition.composition(fp.as_i32(f), inv, alphas, prog)


@pytest.mark.parametrize("from_values", [False, True])
@pytest.mark.parametrize(
    "trees,t", [(1, 1), (5, 1), (1, 2), (3, 16), (2, 512), (1, 1024), (32, 1024), (64, 256)]
)
def test_tree_tail_kernel(dev, trees, t, from_values):
    """Every level of the tail equals `tree_tail_plain`'s, and the levels are
    contiguous, 16-byte aligned views of one buffer."""
    shape = trees * 2 * t if from_values else (trees * 2 * t, 8)
    level = fp.from_host(_u32(shape, t + trees), dev)
    got = sha256_kernel.tree_tail(level, trees, from_values)
    want = sha256_kernel.tree_tail_plain(level, trees, from_values)
    assert len(got) == len(want) == t.bit_length() + from_values
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous() and g.data_ptr() % 16 == 0
        _eq(g, w)


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 64, 2048, 4096, 8192, 1 << 15])
def test_merkle_levels_on_card_equal_cpu(dev, n, bsz):
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.hash import merkle

    vals = _u32((bsz, n), n)
    ops.reset_launch_counts()
    got = merkle.build_levels_batch(fp.from_host(vals, dev))
    counts = ops.launch_counts()
    want = merkle.build_levels_batch(fp.from_host(vals, "cpu"))
    assert len(got) == len(want) == n.bit_length()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous() and g.data_ptr() % 16 == 0
        _eq(g, w)
    # one launch a wide level, one for all the narrow ones, whatever the batch
    top = 2 * sha256_kernel.TAIL_PARENTS
    wide = max(0, n.bit_length() - top.bit_length())
    assert counts["sha256_node"] == wide
    assert counts["sha256_tree_tail"] == (1 if n > 1 else 0)
    assert counts["sha256_leaf"] == (1 if n > top or n == 1 else 0)


def test_tree_tail_rejects_bad_input(dev):
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        sha256_kernel.tree_tail(fp.from_host(_u32((6, 8), 1), dev), 1)
    with pytest.raises(ValueError, match="sha256_tree_tail"):
        sha256_kernel.tree_tail(fp.from_host(_u32((4096, 8), 1), dev), 1)
    with pytest.raises(ValueError, match="aligned"):
        sha256_kernel.tree_tail(fp.from_host(_u32(5, 1), dev)[1:], 1, from_values=True)


def test_stark101_tree_launches_on_card(dev):
    """A stark-101 prove builds its 12 Merkle trees in at most 20 node and
    tail launches (3 a tree of 8192 values, 2 at 4096, 1 below)."""
    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ops, prove

    for fused in (True, False):
        ops.reset_launch_counts()
        proof = prove(STARK101, STARK101_SECRET, device=dev, fused=fused)
        counts = ops.launch_counts()
        assert len(proof.data) == 7836
        assert counts["sha256_node"] + counts["sha256_tree_tail"] <= 20
        assert counts["sha256_tree_tail"] == 12


@pytest.mark.parametrize("rows,cols,elem,missing", [(16, 8, 8, 0), (16, 8, 8, 24), (4, 3, 2, 5),
                                                    (512, 8, 512, 7), (2, 5, 1, 3), (8, 2, 4, 64)])
def test_transpose_blocks(dev, rows, cols, elem, missing):
    """Block elements (the sharded six-step's send re-layout), a missing tail
    and an empty input included, against the plain twin."""
    x = fp.from_host(_u32(rows * cols * elem - missing, rows + elem), dev)
    _eq(ntt_kernel.transpose(x, rows, cols, elem=elem),
        ntt_kernel.transpose_plain(x, rows, cols, elem=elem))


@pytest.mark.parametrize("air_name", ["fibonacci-sq", "fibonacci", "square-chain"])
@pytest.mark.parametrize("shards", [2, 8])
def test_composition_kernel_on_a_shard(dev, air_name, shards):
    """One shard's block with its start and the next shard's halo: equal to
    the plain twin and to the slice of the whole domain's launch."""

    field = fp.FIELD101
    cfg, f, alphas = _composition_case(field, air_name, 8, 1, 41, dev)
    d = cfg.eval_domain
    points = d // shards
    reach = max(cfg.air.shifts) * cfg.blowup
    inv, prog = pr.composition_constants(cfg, f.device), pr.composition_program(cfg)
    row = fp.as_u32(fp.as_i32(f)[0].contiguous())
    whole = composition.composition(row, inv, alphas, prog, field)
    for t in range(shards):
        blk = row[t * points : (t + 1) * points].clone()
        halo = row[((t + 1) % shards) * points :][:reach].clone()
        got = composition.composition(blk, inv, alphas, prog, field, halo=halo, start=t * points)
        want = composition.composition_plain(blk, inv, alphas, prog, field, halo=halo,
                                             start=t * points)
        for g, w, full in zip(got, want, whole):
            _eq(g, w)
            _eq(g, full[t * points : (t + 1) * points])


def test_sharded_prove_on_card(dev):
    """The sharded prover on a local mesh of the card equals the solo proof
    at S = 1, 2 and 8 and on a 2 × 4 host-chip mesh."""
    from zkstark_tpu_torch.parallel import make_host_chip_mesh, make_mesh
    from zkstark_tpu_torch.protocol import prove

    cfg = _small_cfg(2047, "square-chain", secret=271828)
    want = prove(cfg, 271828, device=dev)
    for mesh in (make_mesh(1, device=dev), make_mesh(2, device=dev), make_mesh(8, device=dev),
                 make_host_chip_mesh(2, 4, device=dev)):
        assert prove(cfg, 271828, mesh=mesh) == want


@FIELDS
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 1 << 20])
def test_from_mont_kernel(dev, field, n):
    from zkstark_tpu_torch.ops import elementwise

    x = fp.from_host(_u32(n, n), dev)
    before = elementwise.from_mont_launches
    _eq(elementwise.from_mont(x, field), elementwise.from_mont_plain(x, field))
    assert elementwise.from_mont_launches == before + 1
    if n > 1:  # a view at an odd word: the one-word route
        _eq(elementwise.from_mont(x[1:], field), elementwise.from_mont_plain(x[1:], field))


@FIELDS
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", [1, 2, 4, 10, 14, 21])
def test_endpoint_fix_kernel(dev, field, log_n, batch):
    from zkstark_tpu_torch.ops import elementwise

    c0 = _rand_mont(field, (batch, 1 << log_n), log_n, dev)
    _eq(elementwise.endpoint_fix(c0, field), elementwise.endpoint_fix_plain(c0, field))


@FIELDS
@pytest.mark.parametrize("log_trace", [6, 10, 14])
def test_interpolate_trace_on_card_equals_cpu(dev, field, log_trace):
    from zkstark_tpu_torch.protocol import air

    n = 1 << log_trace
    trace = _rand_mont(field, (2, n - 1), log_trace, dev)
    _eq(air.interpolate_trace(trace, n, field), air.interpolate_trace(trace.cpu(), n, field))


@pytest.mark.parametrize("air_name", ["fibonacci-sq", "fibonacci", "square-chain"])
@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("blowup,trace_len", [(4, 63), (8, 1023), (16, 255), (8, (1 << 17) - 1)])
def test_constants_kernel(dev, air_name, field, blowup, trace_len):
    from zkstark_tpu_torch.ops import constants

    cfg = StarkConfig(field=field, air=AIRS[air_name], trace_len=trace_len, blowup=blowup,
                      boundary_first=1, boundary_last=1, coset_offset=5 if field is fp.FIELD101 else 31)
    system = pr.constants_system(cfg)
    got = constants.inverse_denominators(system, field, dev)
    _eq(got, constants.inverse_denominators_plain(system, field, dev))
    if cfg.eval_domain <= 1 << 20:
        _eq(got, pr.composition_constants(cfg, "cpu"))


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("bsz", [0, 1, 3], ids=["solo", "B1", "B3"])
def test_openings_kernel(dev, q, bsz):
    from zkstark_tpu_torch.hash import merkle
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.parallel.merkle_sharded import shard_tree
    from zkstark_tpu_torch.protocol import openings

    cfg = StarkConfig(trace_len=1023, boundary_first=1, boundary_last=1, n_queries=q)
    lead = (bsz,) if bsz else ()
    seed = iter(range(1000))

    def tree(n):
        vals = fp.from_host(_u32(lead + (n,), next(seed)), dev)
        return vals, merkle.levels_from_host(
            [_u32(lead + (n >> k, 8), next(seed)) for k in range(n.bit_length())], dev)

    def cpu(x):
        if isinstance(x, merkle.Levels):
            return merkle.levels_from_host([fp.to_host(lv) for lv in x], "cpu")
        return [cpu(t) for t in x] if isinstance(x, list) else x.cpu()

    f_res, f_levels = tree(cfg.eval_domain)
    layers = [tree(cfg.eval_domain >> k) for k in range(cfg.fri_rounds + 1)]
    layer_res, layer_levels = [v for v, _ in layers], [lv for _, lv in layers]
    rng = np.random.default_rng(q + bsz)
    idx = fp.from_host(rng.integers(0, cfg.query_range, lead + (q,), dtype=np.uint64)
                       .astype(np.uint32), dev)
    args = (cfg, f_res, f_levels, layer_res, layer_levels)
    cpu_args = (cfg, cpu(f_res), cpu(f_levels), cpu(layer_res), [cpu(lv) for lv in layer_levels])
    before = open_op.openings_launches
    got = openings.sparse_openings_packed(*args, idx)
    assert open_op.openings_launches == before + 1
    _eq(got, openings.sparse_openings_packed(*cpu_args, idx.cpu()))
    if not bsz:  # the packed result has the batch axis of the fused core
        return
    # the whole packed result: the draws, the free term and the roots too
    head = fp.from_host(_u32((bsz, cfg.n_constraints + cfg.fri_rounds), 1), dev)  # alphas, betas
    draws = fp.as_u32(torch.cat([fp.as_i32(head), fp.as_i32(idx)], dim=1))
    packed = openings.packed_result(*args, draws)
    _eq(packed, openings.packed_result(*cpu_args, draws.cpu()))
    if bsz == 1:  # four shards of a mesh, owner-masked, OR to the solo vector
        trees = [shard_tree(f_res, f_levels, 4)] + [
            shard_tree(v, lv, 4) for v, lv in zip(layer_res, layer_levels)]
        sharded = [trees[0][0], trees[0][1], [t[0] for t in trees[1:]], [t[1] for t in trees[1:]]]
        for fn, want, arg in ((openings.sparse_openings_packed, got, idx),
                              (openings.packed_result, packed, draws)):
            merged = None
            for s in range(4):
                part = fn(cfg, *sharded, arg, shard=s, block=s)
                merged = part.view(torch.int32).clone() if merged is None else merged | part.view(torch.int32)
            _eq(fp.as_u32(merged), want)


def test_fused_core_packed_on_card(dev):
    """The one vector the openings kernel writes for a fused stark-101 prove
    (B = 1 and a batch of 3) is the CPU's, word for word."""
    from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, fused

    trace = pr.trace_to_device(STARK101, STARK101_SECRET, dev)
    _eq(fused.fused_core_packed(STARK101, trace), fused.fused_core_packed(STARK101, trace.cpu()))
    traces = fp.as_u32(fp.as_i32(trace)[None].repeat(3, 1))
    _eq(fused.fused_core_batch_packed(STARK101, traces),
        fused.fused_core_batch_packed(STARK101, traces.cpu()))


@pytest.mark.parametrize("n", [1, 3, 255, 257, 4096, 100_003])
def test_leaf_planes_kernel_ragged(dev, n):
    vals = fp.from_host(_u32(n, n), dev)
    _eq(sha256_kernel.leaf_planes(vals), sha256_kernel.leaf_planes_plain(vals))


@pytest.mark.parametrize("k", [1, 2, 255, 257, 4096, 50_001])
def test_node_planes_kernels_ragged(dev, k):
    planes = fp.from_host(_u32((8, 2 * k), k), dev)
    _eq(sha256_kernel.node_planes(planes), sha256_kernel.node_planes_plain(planes))
    _eq(sha256_kernel.node_planes_folded(planes), sha256_kernel.node_planes_folded_plain(planes))
    rows = sha256_kernel.planes_to_rowmajor(planes)
    _eq(rows, fp.as_u32(fp.as_i32(planes).t().contiguous()))
    _eq(sha256_kernel.planes_to_rowmajor(sha256_kernel.node_planes(planes)),
        sha256_kernel.node_hash_pairs(rows))


@pytest.mark.parametrize("log_n", [1, 5, 11, 16])
@pytest.mark.parametrize("stop", [1, 1024, 1 << 15])
def test_planar_chain_on_card(dev, log_n, stop):
    from zkstark_tpu_torch.hash import merkle

    vals = fp.from_host(_u32(1 << log_n, log_n), dev)
    want = merkle.build_levels(vals.cpu())
    got = merkle.build_levels(vals, planar_stop=stop)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n", [1, 16, 1 << 16])
def test_field_device_powers_on_card(dev, n):
    base = fp.subgroup_generator(1 << 16)
    _eq(fp.device_powers(base, n), fp.device_powers(base, n, device="cpu"))
    _eq(fp.powers_iota(base, n, 7), fp.powers_iota(base, n, 7, device="cpu"))
    assert fp.device_powers(base, n).device.type == "cuda"


@pytest.mark.parametrize("n", [1, 2, 32, 256, 2048, 4096, 1 << 20])
@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])
def test_powers_kernel(dev, n, field):
    from zkstark_tpu_torch.ops import powers

    base = field.subgroup_generator(1 << 20)
    before = powers.powers_launches
    got = powers.powers(field, base, n, 11, dev)
    assert powers.powers_launches == before + 1
    _eq(got, powers.powers_plain(field, base, n, 11, "cpu"))
    _eq(field.powers_iota(base, n, 11), field.powers_iota(base, n, 11, device="cpu"))
    _eq(field.device_powers(base, n), field.device_powers(base, n, device="cpu"))


@FIELDS
def test_fp_check_against_exact_integers(dev, field):
    """`fp.cuh`'s mul, add, sub and reduce through `csrc/check.cu`'s
    `fp_check` kernel, on the edge values next to p and 2^16 random pairs:
    bit for bit with the plain-torch ops on every u32 pair, and the exact
    field values where both words are reduced."""
    from zkstark_tpu_torch.ops import _build

    p, rng = field.p, np.random.default_rng(2)
    edges = np.array([0, 1, p - 2, p - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint64)
    ea, eb = np.meshgrid(edges, edges)
    a = np.concatenate([ea.ravel(), rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)])
    b = np.concatenate([eb.ravel(), rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)])
    a, b = a.astype(np.uint32), b.astype(np.uint32)
    n = a.shape[0]
    da, db = fp.from_host(a, dev), fp.from_host(b, dev)
    out = torch.empty((6, n), dtype=torch.uint32, device=dev)
    _build.check(_build.kernels().zk_fp_check(da.data_ptr(), db.data_ptr(), out.data_ptr(), n, p,
                                              field.p_inv_neg, _build.stream(da)), "fp_check")
    got = fp.to_host(out)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plain = [fp.mont_mul_f(field, ta, tb), fp.add_f(field, ta, tb), fp.sub_f(field, ta, tb),
             fp.from_mont_f(field, ta)]
    for row, want in enumerate(plain):
        np.testing.assert_array_equal(got[row], want.numpy(), err_msg=f"row {row}")
    # rows: mont_mul, add, sub, from_mont, and the reduced-input mont_mul, add
    r_inv = pow(1 << 32, p - 2, p)
    x, y = a.astype(object), b.astype(object)
    reduced = (a < p) & (b < p)
    exact = [x * y * r_inv % p, (x + y) % p, (x - y) % p, x * r_inv % p, x * y * r_inv % p,
             (x + y) % p]
    for row, want in enumerate(exact):
        assert (got[row][reduced].astype(object) == want[reduced]).all(), f"row {row}"


@FIELDS
def test_field_methods_on_card_equal_cpu(dev, field):
    rng = np.random.default_rng(17)
    a, b = (field.host_to_mont(rng.integers(0, field.p, 1 << 16, dtype=np.uint64)) for _ in range(2))

    def methods(device):
        ta, tb = fp.from_host(a, device), fp.from_host(b, device)
        return [field.mont_mul(ta, tb), field.add(ta, tb), field.sub(ta, tb), field.neg(ta),
                field.to_mont(ta), field.from_mont(ta), field.pow_static(ta, 5), field.inv(ta)]

    for got, want in zip(methods(dev), methods("cpu")):
        assert got.device.type == "cuda"
        _eq(got, want)


def test_defaults_are_the_card(dev):
    """The entry points whose device defaults to the card."""
    from zkstark_tpu_torch.transcript import device_channel

    assert device_channel.zero_state((2,)).device.type == "cuda"
    assert fp.powers_iota_f(fp.FIELD101, 3, 8).device.type == "cuda"




# The kernels at the main path's own shapes: each case yields (label, a
# kernel's output, its plain twin's) at the calls the prove path makes, from
# stark-101 to the 2^27-point LDE, both NTT routes, batches, shard 3 of 8.

F101, GEO = fp.FIELD101, ntt_kernel.GeoScale
INV5 = pow(5, F101.p - 2, F101.p)
BIG = StarkConfig(trace_len=(1 << 21) - 1, boundary_last=1, air=AIRS["square-chain"])  # 2^24
NTT = (ntt_kernel.ntt_rows, ntt_kernel.ntt_rows_plain)
PEASE = (ntt_kernel.ntt_rows_pease, ntt_kernel.ntt_rows_pease_plain)
LIMB = (limb_dft.limb_dft_rows, limb_dft.limb_dft_rows_plain)
TRANSPOSE = (ntt_kernel.transpose, ntt_kernel.transpose_plain)


def _twin(kernel, plain, *args, **kw):
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    return f"{kernel.__name__} {shapes} {sorted(kw)}", kernel(*args, **kw), plain(*args, **kw)


def _same(label, got, want):
    """Tolerance 0, compared on the card: the outputs reach 2^27 words."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _same(f"{label} output {i}", g, w)
    elif got is None or want is None:
        assert got is None and want is None, f"{label}: an output is missing on one side"
    else:
        assert got.shape == want.shape, (label, got.shape, want.shape)
        differ = int((fp.as_i32(got) != fp.as_i32(want)).sum())
        assert differ == 0, f"{label}: {differ} of {got.numel()} words differ from the twin"


def _passes(kernel, plain, log_n, dev, bsz=1, **kw):
    """Both passes of `bsz` LDEs of 2^log_n points as the four-step launches
    them: pass 1 on the coefficient prefix with the coset pre-scale and the
    U·V twiddle, pass 2 with a coset INTT's post-scale."""
    n, brev = 1 << log_n, kw.get("bitrev", False)
    w = ntt_core.forward_plan(n).root
    n1, n2, ut, vt = ntt_kernel._device_uv(n, w, None, F101, torch.device("cuda", 0), brev)
    x = _rand_mont(F101, (bsz * n2, n1 // 8), log_n, dev)
    yield _twin(kernel, plain, x, pow(w, n2, F101.p), F101, m=n1, uv=(ut, vt),
                pre=GEO(5, n, col_stride=n2, row_stride=1), **kw, **({"period": n2} if bsz > 1 else {}))
    x = _rand_mont(F101, (bsz * n1, n2), log_n + 1, dev)
    yield _twin(kernel, plain, x, pow(w, n1, F101.p), F101, **kw, **({"period": n1} if bsz > 1 else {}),
                post=GEO(INV5, n, col_stride=n1, row_stride=1))


def _hashes(dev):
    vals, kids = fp.from_host(_u32(1 << 20, 3), dev), fp.from_host(_u32((1 << 20, 8), 4), dev)
    yield _twin(sha256_kernel.leaf_hash, sha256_kernel.leaf_hash_plain, vals)
    yield _twin(sha256_kernel.node_hash_pairs, sha256_kernel.node_hash_pairs_plain, kids)


def _rows(dev):
    # (batch, m) of the stark-101 INTT and LDE, the 2^21 and 2^22 INTTs, the
    # 2^24 and 2^25 LDEs; the Pease kernel bit-reversed out, its TPU function
    for batch, m in ((1, 1024), (1, 8192), (1024, 2048), (2048, 1024), (2048, 2048),
                     (4096, 4096), (4096, 8192), (8192, 4096)):
        x, w = _rand_mont(F101, (batch, m), m + batch, dev), ntt_core.forward_plan(m).root
        yield _twin(*NTT, x, w)
        if batch >= 2048 and m >= 2048:
            label, got, want = _twin(*PEASE, x, w, bitrev=False)
            yield label, got, want
            yield f"{label} == ntt_rows", got, ntt_kernel.ntt_rows(x, w)
            yield _twin(*PEASE, x, w, bitrev=True)
    # the stark-101 LDE (pre-scale) and INTT (1/n), the 2^22 INTT (1/n in U)
    x, plan = _rand_mont(F101, (1, 1024), 13, dev), ntt_core.inverse_plan(1024)
    yield _twin(*NTT, x, ntt_core.forward_plan(8192).root, F101, m=8192, pre=GEO(5, 8192))
    yield _twin(*NTT, x, ntt_core._effective_root(plan), F101, scale=plan.scale_mont)
    plan = ntt_core.inverse_plan(1 << 22)
    w = ntt_core._effective_root(plan)
    _, _, ut, vt = ntt_kernel._device_uv(1 << 22, w, plan.scale_mont, F101, torch.device("cuda", 0))
    yield _twin(*NTT, _rand_mont(F101, (2048, 2048), 22, dev), pow(w, 2048, F101.p), F101, uv=(ut, vt))


def _lde_passes(dev):
    # the 2^24 and 2^25 LDEs on both routes (Pease in both orders), the 2^27
    # LDE on the limb route, 16 LDEs of 2^20 on each row kernel (`period=`)
    for log_n in (24, 25):
        yield from _passes(*NTT, log_n, dev)
        yield from _passes(*PEASE, log_n, dev, bitrev=True)
        yield from _passes(*PEASE, log_n, dev, bitrev=False)
    yield from _passes(*LIMB, 27, dev)
    for kernels, kw in ((NTT, {}), (PEASE, {"bitrev": True}), (LIMB, {})):
        yield from _passes(*kernels, 20, dev, bsz=16, **kw)


def _limb(dev):
    # the 2^27 LDE's rows and 4096^2, both primes, equal to `ntt_rows` where
    # it takes the rows
    for field in (F101, fp.FIELD_ALT):
        for batch, m in ((8192, 16384), (16384, 8192), (4096, 4096)):
            x, w = _rand_mont(field, (batch, m), m, dev), ntt_core.forward_plan(m, field).root
            label, got, want = _twin(*LIMB, x, w, field)
            yield label, got, want
            if m <= ntt_kernel.MAX_ROW:
                yield f"{label} == ntt_rows", got, ntt_kernel.ntt_rows(x, w, field)
            del x, got, want


def _shard(dev):
    # shard 3 of 8 in the 2^24 LDE's first pass: its 512 rows with the
    # coefficient prefix, its slice of the U table, base^{t·b} on store
    from zkstark_tpu_torch.parallel import ntt_sharded

    n, t, root = 1 << 24, 3, F101.subgroup_generator(1 << 24)
    n1, n2, w, _, _ = ntt_sharded.sixstep_constants(n, root, False, F101, 8)
    ut, vt = ntt_sharded._device_tables(n, root, False, F101, 8, torch.device("cuda", 0))
    b, vblk = n2 // 8, vt.shape[0]
    x = fp.as_u32(torch.cat([fp.as_i32(_rand_mont(F101, (b, n1 // 8), 37, dev)),
                             torch.zeros((b, n1 - n1 // 8), dtype=torch.int32, device=dev)], 1))
    scale = ntt_sharded._shard_scale(F101, STARK101.coset_offset, t * b)
    assert scale is not None and STARK101.coset_offset == 5 and b % vblk == 0
    yield _twin(*NTT, x, pow(w, n2, F101.p), F101, m=n1, scale=scale,
                pre=GEO(5, n, col_stride=n2, row_stride=1),
                uv=(ut[t * b // vblk : (t + 1) * b // vblk], vt))


def _transposes(dev):
    # the four-step's at 2^22, 2^24 and 2^25 (the first on the short
    # coefficients); 16 at 2^20, bit-reversed rows too; a shard's send
    # re-layout at stark-101 and 2^24 on a mesh of 8
    for r, c, words in ((4096, 4096, 1 << 24), (512, 4096, 1 << 21), (1024, 4096, 1 << 22),
                        (4096, 8192, 1 << 25), (8192, 4096, 1 << 25), (2048, 2048, 1 << 22),
                        (2048, 2048, (1 << 22) - 1)):
        yield _twin(*TRANSPOSE, _rand_mont(F101, words, r + c, dev), r, c)
    for bsz, r, c, words, brev in ((16, 128, 1024, 1 << 17, False), (16, 1024, 1024, 1 << 20, True),
                                   (16, 1024, 1024, 1 << 20, False)):
        yield _twin(*TRANSPOSE, _rand_mont(F101, (bsz, words), r, dev), r, c, brev=brev)
    for r, c, e, words in ((512, 8, 512, 1 << 21), (16, 8, 8, 1024), (16, 8, 8, 1000),
                           (512, 8, 512, (1 << 21) - 5), (512, 8, 512, 0)):
        yield _twin(*TRANSPOSE, _rand_mont(F101, words, e, dev), r, c, elem=e)


def _fri_fold(dev):
    # the 2^24 statement's first fold, solo and on one shard of 8, and 2^24
    # on the second prime; B = 1 and 3, edge values in the first and last rows
    for field, log_m in ((F101, 21), (F101, 24), (fp.FIELD_ALT, 24)):
        p, m = field.p, 1 << log_m
        for bsz in (1, 3):
            rng = np.random.default_rng(log_m + bsz)
            vals = rng.integers(0, p, (bsz, m), dtype=np.uint64).astype(np.uint32)
            vals[0, :3], vals[-1, m // 2 :] = [0, 1, p - 1], p - 1
            beta = fp.from_host(rng.integers(0, p, bsz, dtype=np.uint64).astype(np.uint32), dev)
            yield _twin(fri_fold.fri_fold, fri_fold.fri_fold_plain, fp.from_host(vals, dev), beta,
                        pow(field.subgroup_generator(m), p - 2, p), pow(5, p - 2, p), field)


def _composition(dev):
    # d = 2^24, B = 3 and 1; shards 0, 3 and 7 of 8 at d = 2^24 with halo and
    # start, also against the whole domain's launch
    for bsz in (3, 1):
        f = _rand_mont(F101, (bsz, BIG.eval_domain), bsz, dev)
        alphas = _rand_mont(F101, (bsz, BIG.n_constraints), bsz + 1, dev)
        want = pr.composition_eval_plain(BIG, f, alphas)
        yield (f"d=2^24 B={bsz}", pr.composition_eval_res(BIG, f, alphas),
               (want, fp.from_mont_f(F101, want)))
        del f, want
    points, reach = BIG.eval_domain // 8, max(BIG.air.shifts) * BIG.blowup
    f, alphas = _rand_mont(F101, BIG.eval_domain, 5, dev), _rand_mont(F101, BIG.n_constraints, 6, dev)
    inv, prog = pr.composition_constants(BIG, f.device), pr.composition_program(BIG)
    whole = pr.composition_eval_res(BIG, f, alphas)
    for t in (0, 3, 7):
        label, got, want = _twin(composition.composition, composition.composition_plain,
                                 f[t * points : (t + 1) * points].clone(), inv, alphas, prog, F101,
                                 halo=f[(t + 1) % 8 * points :][:reach].clone(), start=t * points)
        yield f"{label} shard {t}", got, want
        yield f"{label} shard {t} vs whole", got, [w[t * points : (t + 1) * points] for w in whole]


def _glue(dev):
    # from_mont at 2^24, stark-101 and 2^25; endpoint_fix at the INTTs of
    # 2^24, stark-101 and 2^28 and of 32 stark-101 proofs; constants of
    # square-chain and fibonacci-sq at 2^24 and of stark-101
    from zkstark_tpu_torch.ops import constants, elementwise

    for n in (1 << 24, 8192, 1 << 25):
        yield _twin(elementwise.from_mont, elementwise.from_mont_plain, fp.from_host(_u32(n, n), dev))
    for bsz, log_n in ((1, 21), (1, 10), (1, 25), (32, 10)):
        yield _twin(elementwise.endpoint_fix, elementwise.endpoint_fix_plain,
                    _rand_mont(F101, (bsz, 1 << log_n), log_n, dev))
    for cfg in (BIG, STARK101, StarkConfig(trace_len=(1 << 21) - 1, boundary_first=1,
                                           boundary_last=1, air=AIRS["fibonacci-sq"])):
        label, got, want = _twin(constants.inverse_denominators, constants.inverse_denominators_plain,
                                 pr.constants_system(cfg), cfg.field, dev)
        yield f"{label} {cfg.air.name} d={cfg.eval_domain}", got, want


def _openings(dev):
    # the packed result and the openings alone: stark-101 at B = 1 and 32,
    # 2^24 solo and on shard 3 of 8 (there also the solo words it owns); each
    # tree random, in one allocation as the prover's
    from zkstark_tpu_torch.hash import merkle
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.parallel.merkle_sharded import shard_tree
    from zkstark_tpu_torch.protocol import openings

    gen, rng = torch.Generator(device=dev).manual_seed(39), np.random.default_rng(39)

    def u32(shape):
        return fp.narrow(torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64,
                                       device=dev))

    for cfg, bsz, shards in ((STARK101, 1, 0), (STARK101, 32, 0), (BIG, 1, 0), (BIG, 1, 8)):
        values, levels = [], []
        for n in [cfg.eval_domain] + [cfg.eval_domain >> k for k in range(cfg.fri_rounds + 1)]:
            values.append(u32((bsz, n)))
            buf = u32((merkle.level_offset(n, n.bit_length(), bsz),))
            levels.append(merkle.Levels([v.view((bsz, *v.shape[1:]))
                                         for v in merkle._level_views(buf, bsz, n)], buf))
        idx = fp.from_host(rng.integers(0, cfg.query_range, (bsz, cfg.n_queries), dtype=np.uint64)
                           .astype(np.uint32), dev)
        # the chain's draws: alphas, betas, then the queries (openings.draw_columns)
        head = rng.integers(0, 1 << 32, (bsz, cfg.n_constraints + cfg.fri_rounds), dtype=np.uint64)
        draws = fp.from_host(np.concatenate([head.astype(np.uint32), fp.to_host(idx)], axis=1), dev)
        args = solo = [values[0], levels[0], values[1:], levels[1:]]
        kw, shard = {}, None
        if shards:
            sh = [shard_tree(v, lv, shards) for v, lv in zip(values, levels)]
            args = [sh[0][0], sh[0][1], [t[0] for t in sh[1:]], [t[1] for t in sh[1:]]]
            kw, shard = dict(shard=3, block=3), 3
        trees, qcol = openings.trees(*args, block=shard), openings.draw_columns(cfg)[2][0]
        for fn, arg, segs, qs, srcs in (
                (openings.packed_result, draws, openings.packed_segments(cfg), draws[:, qcol:], (draws,)),
                (openings.sparse_openings_packed, idx, openings.segments(cfg), idx, ())):
            label = f"{fn.__name__} {cfg.air.name} d={cfg.eval_domain} B={bsz} shard={shard}"
            got = fn(cfg, *args, arg, **kw)
            yield label, got, open_op.openings_plain(qs, trees, segs, shard, srcs)
            if shards:
                mine = fp.as_i32(got) != 0
                yield f"{label} vs solo", fp.as_i32(got)[mine], fp.as_i32(fn(cfg, *solo, arg))[mine]
        del values, levels, args, solo, trees, draws


MAIN_PATH = {f.__name__[1:]: f for f in (_hashes, _rows, _lde_passes, _limb, _shard, _transposes,
                                         _fri_fold, _composition, _glue, _openings)}


@pytest.mark.parametrize("case", list(MAIN_PATH))
def test_kernels_at_main_path_shapes(dev, case):
    for label, got, want in MAIN_PATH[case](dev):
        _same(f"{case}: {label}", got, want)
        del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("bsz", [1, 32])
def test_openings_on_the_fused_cores_arguments(dev, monkeypatch, bsz):
    """`openings` on what a fused stark-101 core passes it, for one proof and
    for 32 different rows (the batch32 cell's shape), equal to its twin."""
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.protocol import STARK101_SECRET, fused

    seen, wrapper = [], open_op.openings
    monkeypatch.setattr(open_op, "openings", lambda *a: seen.append((a, wrapper(*a))) or seen[-1][1])
    if bsz == 1:
        traces = fp.as_u32(fp.as_i32(pr.trace_to_device(STARK101, STARK101_SECRET, dev))[None])
    else:
        traces = _rand_mont(F101, (bsz, STARK101.trace_len), 32, dev)
    fused._core(STARK101, traces, None)  # eager: a graph's replay makes no Python call
    (args, got), = seen
    _same("fused core", got, open_op.openings_plain(*args))
