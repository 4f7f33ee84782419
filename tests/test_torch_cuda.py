"""The CUDA kernels against their plain-torch twins, on the card.

Marked `cuda`: without a CUDA device every test here skips. The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes the prove path does not reach are covered here: ragged hash counts,
every row length 2..8192 for both row kernels (DIT and Pease), the second
prime, both four-step routes, and the wrappers' input checks.
"""

import numpy as np
import pytest
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ntt import core as ntt_core
from zkstark_tpu_torch.ops import ntt_kernel, sha256_kernel

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


@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_every_length(dev, field, log_m):
    m = 1 << log_m
    rng = np.random.default_rng(log_m)
    x = fp.from_host(field.host_to_mont(rng.integers(0, field.p, (3, m), dtype=np.uint64)), dev)
    w = ntt_core.forward_plan(m, field).root
    _eq(ntt_kernel.ntt_rows(x, w, field), ntt_kernel.ntt_rows_plain(x, ntt_kernel.stage_twiddles(m, w, field), field))


@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("log_m", range(1, 14))
def test_ntt_rows_pease_every_length(dev, field, log_m):
    m = 1 << log_m
    rng = np.random.default_rng(100 + log_m)
    x = fp.from_host(field.host_to_mont(rng.integers(0, field.p, (3, m), dtype=np.uint64)), dev)
    w = ntt_core.forward_plan(m, field).root
    tw = ntt_kernel.pease_twiddles(m, w, field)
    _eq(ntt_kernel.ntt_rows_pease(x, w, field), ntt_kernel.ntt_rows_pease_plain(x, tw, field))


@pytest.mark.parametrize("pease", ["off", "on"])
def test_fourstep_on_card_equals_cpu(dev, monkeypatch, pease):
    monkeypatch.setenv("ZKSTARK_PEASE", pease)
    n = 1 << 16
    x = fp.FIELD101.host_to_mont(_u32(n, 7) % fp.P)
    plan = ntt_core.forward_plan(n)
    counter = "pease_launches" if pease == "on" else "ntt_launches"
    before = getattr(ntt_kernel, counter)
    _eq(ntt_core.ntt(fp.from_host(x, dev), plan), ntt_core.ntt(fp.from_host(x, "cpu"), plan))
    assert getattr(ntt_kernel, counter) == before + 2


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
        ntt_kernel.ntt_rows_pease(fp.from_host(_u32((4, 8), 2), dev).t(), 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_rows_pease(fp.from_host(_u32((1, 16384), 3), dev), 1)
