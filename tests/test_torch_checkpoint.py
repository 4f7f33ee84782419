"""Kill-and-resume in the port — the cases of tests/test_checkpoint.py but
the mesh case (sharding is not ported yet): a proof stopped at any barrier
resumes from its checkpoint to the bytes of the port's uninterrupted
`prove()` and of the JAX proof. Also: the format version and a missing
entry each raise their own error."""

import os

import numpy as np
import pytest

from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu.protocol.prover import prove as jax_prove
from zkstark_tpu_torch import prove
from zkstark_tpu_torch.protocol import checkpoint
from zkstark_tpu_torch.protocol.air import fibonacci_sq_trace
from zkstark_tpu_torch.protocol.config import STARK101, STARK101_SECRET, StarkConfig

SECRET = 3141592
GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"


@pytest.fixture(scope="module")
def small_cfg():
    # trace 63, domain 512: fast on the CPU, the full protocol shape
    trace = fibonacci_sq_trace(63, SECRET)
    return StarkConfig(trace_len=63, blowup=8, boundary_last=int(trace[-1]))


@pytest.fixture(scope="module")
def golden_proof(small_cfg):
    """The port's uninterrupted proof, checked once against the JAX one."""
    got = prove(small_cfg, SECRET, device="cpu")
    want = jax_prove(
        JaxConfig(trace_len=63, blowup=8, boundary_last=small_cfg.boundary_last),
        SECRET,
        fused=False,
    )
    assert (got.state, got.data) == (want.state, want.data)
    return got


def _ckpt(tmp_path):
    return str(tmp_path / "ckpt.npz")


@pytest.mark.parametrize("stop_after", ["phase1", "phase2", "fri"])
def test_resume_matches_uninterrupted(tmp_path, small_cfg, golden_proof, stop_after):
    path = _ckpt(tmp_path)
    rp = checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu")
    assert rp.run(stop_after=stop_after) is None  # "crash"
    resumed = checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run()
    assert resumed.data == golden_proof.data
    assert resumed.state == golden_proof.state


def test_uninterrupted_resumable_matches(tmp_path, small_cfg, golden_proof):
    proof = checkpoint.ResumableProver(small_cfg, SECRET, _ckpt(tmp_path), device="cpu").run()
    assert proof == golden_proof


def test_checkpoint_removed_after_success(tmp_path, small_cfg):
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase2")
    assert os.path.exists(path)
    assert checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run() is not None
    assert not os.path.exists(path)


def test_checkpoint_bound_to_statement(tmp_path, small_cfg):
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase1")
    with pytest.raises(checkpoint.CheckpointError, match="DIFFERENT statement"):
        checkpoint.ResumableProver(small_cfg, 2718281, path, device="cpu").run()
    trace = fibonacci_sq_trace(127, SECRET)
    other = StarkConfig(trace_len=127, blowup=8, boundary_last=int(trace[-1]))
    with pytest.raises(checkpoint.CheckpointError, match="DIFFERENT statement"):
        checkpoint.ResumableProver(other, SECRET, path, device="cpu").run()
    assert checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run() is not None


def _rewrite(path, edit):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    edit(flat)
    np.savez(path, **flat)


@pytest.mark.parametrize("key", ["__data__", "f_eval", "f_res"])
def test_corrupt_checkpoint_rejected(tmp_path, small_cfg, key):
    """One flipped byte in the transcript or in a bulk array fails the
    integrity digest."""
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase1")

    def flip(flat):
        arr = flat[key].copy()
        arr.reshape(-1).view(np.uint8)[0] ^= 1
        flat[key] = arr

    _rewrite(path, flip)
    with pytest.raises(checkpoint.CheckpointError, match="integrity"):
        checkpoint.load(path)


def test_truncated_checkpoint_rejected(tmp_path, small_cfg):
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase1")
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(checkpoint.CheckpointError, match="unreadable"):
        checkpoint.load(path)


@pytest.mark.parametrize("version", [None, checkpoint.FORMAT_VERSION + 1])
def test_version_mismatch_has_its_own_error(tmp_path, small_cfg, version):
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase1")

    def set_version(flat):
        if version is None:
            del flat["__version__"]
        else:
            flat["__version__"] = np.int64(version)

    _rewrite(path, set_version)
    with pytest.raises(checkpoint.CheckpointVersionError):
        checkpoint.load(path)


@pytest.mark.parametrize("key", ["__fp__", "f_eval", "__len__f_levels"])
def test_missing_key_has_its_own_error(tmp_path, small_cfg, key):
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase1")
    _rewrite(path, lambda flat: flat.pop(key))
    with pytest.raises(checkpoint.CheckpointKeyError, match="no entry"):
        checkpoint.load(path)


# The barrier after all device work ("fused"), the one the CLI writes.


def test_fused_resume_small(tmp_path, small_cfg, golden_proof):
    path = _ckpt(tmp_path)
    rp = checkpoint.ResumableProver(small_cfg, SECRET, path, fused=True, device="cpu")
    assert rp.run(stop_after="fused") is None
    resumed = checkpoint.ResumableProver(small_cfg, SECRET, path, fused=True, device="cpu").run()
    assert resumed == golden_proof


def test_fused_resume_stark101_golden(tmp_path):
    path = _ckpt(tmp_path)
    rp = checkpoint.ResumableProver(STARK101, STARK101_SECRET, path, fused=True, device="cpu")
    assert rp.run(stop_after="fused") is None
    resumed = checkpoint.ResumableProver(STARK101, STARK101_SECRET, path, fused=True, device="cpu").run()
    assert len(resumed.data) == 7836
    assert resumed.state.hex() == GOLDEN_STATE


def test_any_barrier_resumes_whatever_fused_says(tmp_path, small_cfg, golden_proof):
    """A legacy checkpoint resumes under fused=True and a fused one under
    fused=False: the checkpoint's phase decides."""
    path = _ckpt(tmp_path)
    checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run(stop_after="phase2")
    assert checkpoint.ResumableProver(small_cfg, SECRET, path, fused=True, device="cpu").run() == golden_proof
    checkpoint.ResumableProver(small_cfg, SECRET, path, fused=True, device="cpu").run(stop_after="fused")
    assert checkpoint.ResumableProver(small_cfg, SECRET, path, device="cpu").run() == golden_proof
