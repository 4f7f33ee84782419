"""Whole proofs on the card: the port's statements, NTT routes, batches,
pipelines, meshes and entry points, each held to its bytes, to both
verifiers and to the kernels it must launch.

Marked `cuda`: without a CUDA device every test here skips. The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda_proofs.py --noconftest -q

The statements run from stark-101 (2^13 points) to square-chain at 2^27
points (≈ 30 GB of the card). The kernels against their plain twins, at
the main path's shapes too, are `test_torch_cuda.py`'s. Nothing here
asserts a time:
``python -m proofbench.run`` measures the port.
"""

import json
import math
import os
import subprocess
import sys
from collections import Counter
from functools import cache
from pathlib import Path

import numpy as np
import pytest
import torch

from proofbench.reference import prover as reference
from proofbench.yardstick import statement
from zkstark_tpu_torch import ops
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.native import verify_native
from zkstark_tpu_torch.ntt import core as ntt_core
from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, fused, graph, prove, verify
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN, WINTERFELL_WORK
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.proof import expected_proof_len

from test_torch_cuda import _eq, _rand_mont, dev  # noqa: F401 (a fixture)
from test_torch_group_of_one import run_worker

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
GOLDEN_LEN = 7836
SECRET = 271828  # the square-chain statements' secret, `tools.prove_big`'s
# proof bytes of square-chain by trace bits (2^(bits + 3) points at blowup 8)
PROOF_LEN = {13: 10752, 18: 17612, 21: 22496, 22: 24252, 24: 27956}
# every proof launches these (below the four-step size: no transpose)
ROW_KERNELS = ("sha256_leaf", "sha256_node", "sha256_tree_tail", "ntt_rows", "composition")
FUSED_KERNELS = ("fs_chain", "fri_fold")  # the one-fetch path's own
# the kernels of the fused core's former plain-torch glue
GLUE_KERNELS = ("openings", "endpoint_fix", "from_mont", "constants")
SHARDED_KERNELS = ("ntt_rows", "transpose", "composition", "fri_fold", "fs_chain", "openings",
                   "endpoint_fix", "from_mont")
# the port's kernels as torch.profiler names them
OWN_KERNELS = ("ntt_rows_kernel", "transpose_kernel", "transpose_blocks_kernel",
               "ntt_rows_pease_kernel", "sha256_leaf", "sha256_node", "sha256_tree_tail",
               "fs_chain_kernel", "fri_fold_kernel", "limb_dft_rows_kernel", "composition_kernel",
               "openings_kernel", "endpoint_fix_kernel", "from_mont_kernel", "constants_kernel",
               "powers_kernel")
# the most device spans of one profiled stark-101 fused prove: 48 kernels and
# the four copies of `COPY_SPANS`
MAX_STARK101_SPANS = 52
# the device spans of a fused prove that are not the port's kernels, at most
# one each: the witness's upload and the packed result's fetch, and around a
# replay of the core's CUDA graph the copies into its input and out of its
# result (by the trace's and the packed vector's bytes)
COPY_SPANS = (("Memcpy HtoD", "trace"), ("Memcpy DtoH", "packed"), ("Memcpy DtoD", "trace"),
              ("Memcpy DtoD", "packed"))


@pytest.fixture(autouse=True)
def default_route(monkeypatch):
    """Every test starts on the default NTT route (DIT, no limb matrix)."""
    monkeypatch.delenv("ZKSTARK_PEASE", raising=False)
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)


@cache
def square_chain(bits: int) -> StarkConfig:
    trace_len = (1 << bits) - 1
    return StarkConfig(trace_len=trace_len, air=SQUARE_CHAIN,
                       boundary_last=int(SQUARE_CHAIN.trace(trace_len, SECRET)[-1]))


@pytest.fixture(scope="module")
def golden(dev):
    """The host-synced stark-101 proof on the card."""
    return prove(STARK101, STARK101_SECRET, device=dev, fused=False)


@pytest.fixture(scope="module")
def proof16(dev):
    """The 2^16-point square-chain proof on the CPU."""
    return prove(square_chain(13), SECRET, device="cpu")


@pytest.fixture(scope="module")
def proof24(dev):
    """The host-synced 2^24-point square-chain proof on the card."""
    return prove(square_chain(21), SECRET, device=dev, fused=False)


def _require(counts: dict, names) -> None:
    assert not [n for n in names if counts[n] <= 0], f"not launched: {counts}"


def _stark101_launches(counts: dict) -> None:
    """A stark-101 prove, or one batch of them: composition once, the Merkle
    trees in at most 20 node and tail launches (one a level or tail)."""
    assert counts["composition"] == 1, counts
    assert counts["sha256_node"] + counts["sha256_tree_tail"] <= 20, counts


def _guarded_core(cfg, secret, dev, mesh=None):
    """One fused prove whose core runs under the sync debug mode "error": a
    call that waits for the device raises. The caches must be warm."""
    trace = pr.trace_to_device(cfg, secret, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = fused.PendingFetch(fused.fused_core_packed(cfg, trace, mesh))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return pr.finish_fused(cfg, fused.unpack_out(cfg, pending.wait()))


def _profile(fn, calls: int = 1):
    """`calls` calls of `fn` under torch.profiler: (profile, device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert events, "torch.profiler recorded no device activity"
    return prof, events


def _own(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)


def _only_own_kernels(fn, own: str) -> None:
    """One call of `fn` launches none but the port's kernels (and memsets
    and copies), `own` among them."""
    names = Counter(e.name for e in _profile(fn)[1])
    foreign = [k for k in names if not _own(k) and not k.lower().startswith(("memset", "memcpy"))]
    assert not foreign, f"foreign kernels {foreign}: {dict(names)}"
    assert any(own in k for k in names), dict(names)


@pytest.mark.parametrize("log_n,bsz", [(24, 1), (25, 1), (20, 16), (27, 1)],
                         ids=["2^24", "2^25", "16x2^20", "2^27"])
def test_lde_is_one_fourstep_of_own_kernels(dev, monkeypatch, log_n, bsz):
    """`coset_ntt` on the DIT and the Pease route: 2 row launches and 3
    transposes whatever the batch, only the port's kernels under
    torch.profiler, the same words on both routes. Past 2^26 points the limb
    route."""
    n = 1 << log_n
    coeffs = _rand_mont(fp.FIELD101, (bsz, n // 8), log_n, dev).squeeze(0)
    routes = ({"off": "limb_dft_rows"} if log_n > 26
              else {"off": "ntt_rows", "on": "ntt_rows_pease"})
    rows_kernels = ("ntt_rows", "ntt_rows_pease", "limb_dft_rows")
    got = {}
    for route, rows in routes.items():
        monkeypatch.setenv("ZKSTARK_PEASE", route)
        ops.reset_launch_counts()
        got[route] = ntt_core.coset_ntt(coeffs, n, 5)
        counts = ops.launch_counts()
        assert {k: counts[k] for k in (*rows_kernels, "transpose")} == \
            {**{k: 0 for k in rows_kernels}, rows: 2, "transpose": 3}
        _only_own_kernels(lambda: ntt_core.coset_ntt(coeffs, n, 5), f"{rows}_kernel")
    if "on" in got:
        _eq(got["on"], got["off"])


def test_stark101_on_card(dev, golden):
    """Host-synced and fused: the golden bytes and state, both verifiers,
    each path's kernels; the fused path's prove with its composition
    constants built cold launches the glue kernels; its core waits for
    nothing."""
    ops.reset_launch_counts()
    assert prove(STARK101, STARK101_SECRET, device=dev, fused=False) == golden
    counts = ops.launch_counts()
    assert len(golden.data) == GOLDEN_LEN and golden.state.hex() == GOLDEN_STATE
    verify(golden, STARK101)
    verify_native(golden, STARK101)
    _require(counts, (*ROW_KERNELS, "fri_fold"))
    _stark101_launches(counts)
    pr.composition_constants.cache_clear()
    ops.reset_launch_counts()
    proof = prove(STARK101, STARK101_SECRET, device=dev)
    counts = ops.launch_counts()
    assert proof == golden
    _require(counts, (*ROW_KERNELS, *FUSED_KERNELS, *GLUE_KERNELS))
    _stark101_launches(counts)
    assert _guarded_core(STARK101, STARK101_SECRET, dev) == golden


def _copies(prof, tmp_path) -> list:
    """[name, bytes] of every device copy of a profile, read from its
    exported trace (the profiler's events carry no sizes)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [[e["name"], int(e.get("args", {}).get("bytes", -1))] for e in events
            if e.get("cat") == "gpu_memcpy"]


@pytest.mark.parametrize("calls_before", [0, 2], ids=["eager", "replayed"])
def test_stark101_fused_prove_device_spans(dev, monkeypatch, tmp_path, calls_before):
    """A warm fused stark-101 prove, eager or a graph's replay, makes at most
    `MAX_STARK101_SPANS` device spans: the port's kernels and at most one
    copy of each of `COPY_SPANS`, no plain torch."""
    prove(STARK101, STARK101_SECRET, device=dev)  # the caches warm
    monkeypatch.setattr(fused, "_GRAPHS", graph.CoreGraphs(fused._core))
    for _ in range(calls_before):
        prove(STARK101, STARK101_SECRET, device=dev)
    prof, events = _profile(lambda: prove(STARK101, STARK101_SECRET, device=dev))
    assert len(events) <= MAX_STARK101_SPANS, Counter(e.name for e in events)
    size = {"trace": 4 * pr.trace_to_device(STARK101, STARK101_SECRET, dev).numel(),
            "packed": 4 * sum(math.prod(s) for shape in fused.out_shapes(STARK101).values()
                              for s in (shape if isinstance(shape, list) else [shape]))}
    allowed = [(kind, size[which]) for kind, which in COPY_SPANS]
    copies = _copies(prof, tmp_path)
    assert sum(not _own(e.name) for e in events) == len(copies), Counter(e.name for e in events)
    for kind, n in allowed:
        assert sum(c[0].startswith(kind) and c[1] == n for c in copies) <= 1, copies
    assert all(any(c[0].startswith(k) and c[1] == n for k, n in allowed) for c in copies), \
        (copies, allowed)


@pytest.mark.parametrize("bits", [None, 21], ids=["stark101", "2^24"])
def test_glue_launches_no_plain_torch(dev, bits):
    """The three groups that were plain-torch loops on the prove path (the
    trace's interpolation, `from_mont` of f_eval, the openings' gathers),
    each alone under torch.profiler on the statement's own tensors, launch
    only the port's kernels: no plain-torch kernel and no copy."""
    from zkstark_tpu_torch import ntt
    from zkstark_tpu_torch.ops import elementwise
    from zkstark_tpu_torch.protocol import air, openings

    cfg, secret = (STARK101, STARK101_SECRET) if bits is None else (square_chain(bits), SECRET)
    art = pr.ProverArtifacts()
    pr.prove(cfg, secret, device=dev, artifacts=art, fused=False)
    trace = pr.trace_to_device(cfg, secret, dev)
    coeffs = air.interpolate_trace(trace, cfg.trace_domain, cfg.field)
    f_eval = ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field)
    idx = fp.from_host(np.asarray(art.query_indices, dtype=np.uint32), dev)
    levels = [t.levels for t in art.layer_trees]
    groups = {
        "interpolation": lambda: air.interpolate_trace(trace, cfg.trace_domain, cfg.field),
        "from_mont": lambda: elementwise.from_mont(f_eval, cfg.field),
        "openings": lambda: openings.sparse_openings_device(
            cfg, art.f_res, art.f_tree.levels, art.layer_res, levels, idx),
    }
    for name, fn in groups.items():
        fn()
        # ten calls a window: the profiler may drop the spans of one short call
        names = Counter(e.name for e in _profile(fn, 10)[1])
        assert all(_own(k) for k in names), (name, dict(names))


@pytest.mark.parametrize("bits", [13, 21, 24], ids=["2^16", "2^24", "2^27"])
def test_square_chain_proof_on_card(dev, proof16, bits):
    """`tools.prove_big` (the host-synced proof twice, both verifiers, the
    proof layout's length): its route's kernels launched with its
    composition constants built cold; then the fused `prove()`: the same
    bytes, its core waiting for nothing. At 2^16 points the CPU's proof,
    past 2^26 the limb route."""
    from zkstark_tpu_torch.ops import ntt_kernel
    from zkstark_tpu_torch.tools import prove_big

    # the twiddle tables and constants of earlier statements leave the card
    ntt_kernel._device_uv.cache_clear()
    pr.composition_constants.cache_clear()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    proof, cfg, _ = prove_big.run(bits, repeats=1, device=dev, emit=lambda r: None)
    counts = ops.launch_counts()
    assert cfg == square_chain(bits)
    assert len(proof.data) == expected_proof_len(cfg) == PROOF_LEN[bits]
    rows = "limb_dft_rows" if cfg.eval_domain > 1 << 26 else "ntt_rows"
    _require(counts, ("sha256_leaf", "sha256_node", "sha256_tree_tail", rows, "transpose",
                      "fri_fold", "composition", *GLUE_KERNELS))
    assert counts["composition"] == 2, counts  # the cold prove and the warm one
    ops.reset_launch_counts()
    got = prove(cfg, SECRET, device=dev)
    counts = ops.launch_counts()
    assert got == proof
    _require(counts, (rows, "composition", "sha256_tree_tail", *FUSED_KERNELS))
    assert counts["composition"] == 1, counts
    assert _guarded_core(cfg, SECRET, dev) == proof
    if bits == 13:
        assert proof == proof16


def _cli(args: list, env: dict) -> dict:
    """``python -m zkstark_tpu_torch --json ARGS`` from the repository root:
    its last output line, parsed."""
    cmd = [sys.executable, "-m", "zkstark_tpu_torch", "--json", *args]
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, (cmd, run.stdout[-2000:], run.stderr[-4000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_cli_on_the_pease_route_equals_prove_big(dev, monkeypatch, tmp_path):
    """The 2^25-point statement: the CLI's prove and verify in subprocesses on
    the Pease route, two four-steps of 2 `ntt_rows_pease` and 3 `transpose`
    launches each and no `ntt_rows`; `tools.prove_big` in this process on
    the DIT route, no `ntt_rows_pease` (both verifiers); 24,252 bytes, the
    same from both routes."""
    from zkstark_tpu_torch.tools import prove_big

    out = tmp_path / "proof.bin"
    statement = ["--air", "square-chain", "--trace-len", str((1 << 22) - 1)]
    env = dict(os.environ, ZKSTARK_PEASE="on")
    torch.cuda.empty_cache()  # the card's memory to the subprocess
    cli = _cli(statement + ["prove", "--secret", str(SECRET), "--out", str(out)], env)
    launches = cli["kernel_launches"]
    _require(launches, ("sha256_leaf", "sha256_node", "sha256_tree_tail", "ntt_rows_pease",
                        *FUSED_KERNELS))
    assert [launches[k] for k in ("ntt_rows_pease", "transpose", "ntt_rows")] == [4, 6, 0]
    checked = _cli(statement + ["--boundary-last", str(cli["boundary_last"]), "verify", str(out)],
                   env)
    assert checked["verified"], checked
    ops.reset_launch_counts()
    proof, cfg, _ = prove_big.run(22, repeats=1, device=dev, emit=lambda r: None)
    counts = ops.launch_counts()
    assert cfg.boundary_last == cli["boundary_last"]
    _require(counts, ("ntt_rows", "transpose", "fri_fold"))
    assert counts["ntt_rows_pease"] == 0
    assert len(proof.data) == PROOF_LEN[22] and proof.to_bytes() == out.read_bytes()
    monkeypatch.setenv("ZKSTARK_PEASE", "on")
    assert prove(cfg, SECRET, device=dev, fused=False) == proof


@pytest.mark.parametrize("fused_path,barrier", [(True, "fused"), (False, "phase2")])
def test_checkpoint_from_card_resumes_on_cpu(dev, proof16, tmp_path, fused_path, barrier):
    from zkstark_tpu_torch.protocol.checkpoint import ResumableProver

    cfg, path = square_chain(13), tmp_path / f"{barrier}.npz"
    stopped = ResumableProver(cfg, SECRET, str(path), fused=fused_path, device=dev).run(
        stop_after=barrier)
    assert stopped is None and path.exists()
    assert ResumableProver(cfg, SECRET, str(path), fused=fused_path, device="cpu").run() == proof16


def test_stark101_batches_are_golden(dev, golden):
    """`prove_batch` of 32 and of 64, each one launch a level or tail and
    one composition for the whole batch; `prove_batch_pipelined` of 4 × 32."""
    from zkstark_tpu_torch.protocol.batch import prove_batch, prove_batch_pipelined

    for bsz in (32, 64):
        ops.reset_launch_counts()
        assert prove_batch(STARK101, [STARK101_SECRET] * bsz, device=dev) == [golden] * bsz
        counts = ops.launch_counts()
        _require(counts, (*ROW_KERNELS, *FUSED_KERNELS))
        _stark101_launches(counts)
    assert prove_batch_pipelined(STARK101, [[STARK101_SECRET] * 32] * 4, depth=2,
                                 device=dev) == [golden] * 128


@pytest.mark.parametrize("bits,bsz,launches", [(13, 4, (3, 3)), (17, 16, (4, 6))],
                         ids=["2^16xB4", "2^20xB16"])
def test_square_chain_batch_equals_solo(dev, proof16, bits, bsz, launches):
    """A batch on the four-step route whose secrets s and p − s alternate
    (their witnesses differ and share the public output): each proof its
    solo proof, both verifiers; one four-step a transform for the whole
    batch, (`ntt_rows`, `transpose`) launches as given."""
    from zkstark_tpu_torch.protocol.batch import prove_batch

    cfg = square_chain(bits)
    secrets = [SECRET if i % 2 == 0 else cfg.field.p - SECRET for i in range(bsz)]
    solo = {s: prove(cfg, s, device=dev) for s in set(secrets)}
    assert solo[SECRET] != solo[cfg.field.p - SECRET]
    if bits == 13:
        assert solo[SECRET] == proof16
    ops.reset_launch_counts()
    got = prove_batch(cfg, secrets, device=dev)
    counts = ops.launch_counts()
    assert got == [solo[s] for s in secrets]
    verify(got[1], cfg)
    verify_native(got[1], cfg)
    _require(counts, (*ROW_KERNELS, "transpose", *FUSED_KERNELS))
    assert (counts["ntt_rows"], counts["transpose"]) == launches


def test_batched_lde_within_b_times_one(dev):
    """16 LDEs of 2^20 points in one batch take at most 16 times the memory
    of one."""
    n, bsz = 1 << 20, 16
    coeffs = _rand_mont(fp.FIELD101, (bsz, n // 8), 10, dev)
    used = {}
    for b in (1, bsz):
        one = coeffs[:b].contiguous()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ntt_core.coset_ntt(one, n, 5)
        torch.cuda.synchronize()
        used[b] = torch.cuda.max_memory_allocated() - base
    assert used[bsz] <= bsz * used[1], used


def test_prove_pipelined_equals_solo(dev, golden, proof24):
    """`prove_pipelined` at depth 2: 8 stark-101 proofs, and 3 of the 2^24
    statement with the one-fetch path's kernels."""
    from zkstark_tpu_torch.protocol import prove_pipelined

    assert prove_pipelined(STARK101, [STARK101_SECRET] * 8, depth=2, device=dev) == [golden] * 8
    cfg = square_chain(21)
    ops.reset_launch_counts()
    proofs = prove_pipelined(cfg, [SECRET] * 3, depth=2, device=dev)
    counts = ops.launch_counts()
    assert proofs == [proof24] * 3 and len(proof24.data) == PROOF_LEN[21]
    verify(proofs[-1], cfg)
    verify_native(proofs[-1], cfg)
    _require(counts, (*ROW_KERNELS, "transpose", *FUSED_KERNELS, "openings", "endpoint_fix",
                      "from_mont"))


def _reference(cfg: StarkConfig, secret: int, dev) -> tuple:
    """(state, data) of the benchmark's plain reference (``proofbench/
    reference``: int64 torch and hashlib, none of the port's code) for the
    port config's statement and `secret`, computed on `dev`."""
    st = statement.Statement(
        name=cfg.air.name, air=cfg.air.name, trace_len=cfg.trace_len, blowup=cfg.blowup,
        coset_offset=cfg.coset_offset, n_queries=cfg.n_queries, p=cfg.field.p, generator=5,
        boundary_first=cfg.boundary_first, boundary_last=cfg.boundary_last, secret=secret)
    return reference.prove(st, secret, device=dev)


def test_decommit_byte_map_equals_the_reference(dev):
    """The decommit's byte map (`prover.decommit_layout`) on the card's
    fetched openings: a `winterfell_work`-shaped proof (32 queries, degree-3
    FRI rounds, 2^20 points, eager) and a `prove_batch` of four stark-101
    witnesses (s and p − s), each equal to the plain reference's bytes."""
    from zkstark_tpu_torch.protocol.batch import prove_batch

    p, rows, start = STARK101.field.p, (1 << 17) - 1, 2**31 + 23
    cfg = StarkConfig(trace_len=rows, n_queries=32, boundary_first=start, air=WINTERFELL_WORK,
                      boundary_last=int(WINTERFELL_WORK.trace(rows, start, p)[-1]))
    got = prove(cfg, start, device=dev)
    assert (got.state, got.data) == _reference(cfg, start, dev)
    assert len(got.data) == expected_proof_len(cfg)
    secrets = [STARK101_SECRET, p - STARK101_SECRET] * 2
    proofs = prove_batch(STARK101, secrets, device=dev)
    for proof, s in zip(proofs, secrets):
        assert (proof.state, proof.data) == _reference(STARK101, s, dev)
    assert proofs[0] == proofs[2] != proofs[1] == proofs[3]


def sharded_bytes(cfg, shards: int) -> dict:
    """The bytes a sharded prove moves between shards, by collective, as the
    design counts them (each shard its own rank): the six-step's three
    all_to_alls of the LDE; one gather of the S subtree roots a sharded tree;
    the layer gathered where a fold falls back to one device (m/2 < S), or
    else the last layer for the free term; the composition's halo and one
    exchange of the layer a sharded fold; the packed result replicated."""
    d, word, s = cfg.eval_domain, 4, shards
    reach = max(cfg.air.shifts) * cfg.blowup
    out = {"all_to_all": 3 * d * word * (s - 1) // s, "all_gather": 0,
           "exchange": s * reach * word if reach and 1 < s <= d // reach else 0,
           "replicate": 0}
    trees, m, sharded = 2, d, True
    for _ in range(cfg.fri_rounds):
        if sharded and m // 2 >= s:
            out["exchange"] += word * m * (s - 1) // s
            trees += 1
        elif sharded:
            out["all_gather"] += word * m * (s - 1)
            sharded = False
        m //= 2
    if sharded:
        out["all_gather"] += word * m * (s - 1)
    out["all_gather"] += trees * 32 * s * (s - 1)
    packed = sum(math.prod(v) for leaf in fused.out_shapes(cfg).values()
                 for v in (leaf if isinstance(leaf, list) else [leaf]))
    out["replicate"] = word * packed * s * (s - 1)
    return out


@pytest.mark.parametrize("bits,shards", [(None, 2), (None, 8), (18, 8), (21, 8)],
                         ids=["stark101-S2", "stark101-S8", "2^21-S8", "2^24-S8"])
def test_sharded_prove_equals_solo(dev, bits, shards):
    """A local mesh of the card: the solo proof's bytes, both verifiers, its
    core waiting for nothing, the bytes between shards the design's count,
    the sharded path's kernels."""
    from zkstark_tpu_torch.parallel import make_mesh

    cfg, secret = (STARK101, STARK101_SECRET) if bits is None else (square_chain(bits), SECRET)
    want = prove(cfg, secret, device=dev)
    if bits is None:
        assert len(want.data) == GOLDEN_LEN and want.state.hex() == GOLDEN_STATE
    else:
        assert len(want.data) == expected_proof_len(cfg) == PROOF_LEN[bits]
    mesh = make_mesh(shards, device=dev)
    first = prove(cfg, secret, mesh=mesh)
    assert first == want
    verify(first, cfg)
    verify_native(first, cfg)
    assert _guarded_core(cfg, secret, dev, mesh) == want
    ops.reset_launch_counts()
    mesh.reset_bytes()
    assert prove(cfg, secret, mesh=mesh) == want
    counts = ops.launch_counts()
    assert dict(mesh.bytes_moved) == sharded_bytes(cfg, shards)
    _require(counts, SHARDED_KERNELS)
    assert counts["sha256_leaf"] + counts["sha256_tree_tail"] > 0, counts


def test_sharded_batch_of_two_witnesses(dev, golden):
    """32 stark-101 witnesses over 8 shards, each group of 4 its own order of
    the two secrets of one public output: proof i is secret i's solo proof."""
    from zkstark_tpu_torch.parallel import make_mesh
    from zkstark_tpu_torch.protocol.batch import prove_batch

    other = STARK101.field.p - STARK101_SECRET
    want = {STARK101_SECRET: golden, other: prove(STARK101, other, device=dev)}
    assert want[other] != golden
    # proof j of group g is STARK101_SECRET where bit j of 2g + 1 is set
    secrets = [STARK101_SECRET if (2 * (i // 4) + 1) >> (i % 4) & 1 else other for i in range(32)]
    got = prove_batch(STARK101, secrets, mesh=make_mesh(8, device=dev))
    assert got == [want[s] for s in secrets]


def test_sharded_lde_only_own_kernels(dev):
    """The six-step LDE of 2^24 points over 8 shards equals `coset_ntt` and
    launches none but the port's kernels."""
    from zkstark_tpu_torch.parallel import coset_ntt_sixstep, make_mesh

    cfg, mesh = square_chain(21), make_mesh(8, device=dev)
    n = cfg.eval_domain
    coeffs = _rand_mont(fp.FIELD101, n // 8, 38, dev)
    blocks = coset_ntt_sixstep(coeffs, n, cfg.coset_offset, mesh)
    _eq(fp.as_u32(torch.cat([fp.as_i32(b) for b in blocks])),
        ntt_core.coset_ntt(coeffs, n, cfg.coset_offset))
    _only_own_kernels(lambda: coset_ntt_sixstep(coeffs, n, cfg.coset_offset, mesh),
                      "ntt_rows_kernel")


def test_scaling_bench_same_roots_at_every_mesh(dev):
    """`tools.scaling_bench` at 2^24 points over 1, 2, 4 and 8 shards of the
    card: it raises unless every mesh gives the same roots, free term and
    final layer."""
    from zkstark_tpu_torch.tools import scaling_bench

    torch.cuda.empty_cache()
    records = scaling_bench.run(24, devices=(1, 2, 4, 8), repeats=1, device=dev,
                                emit=lambda r: None)
    assert [r["devices"] for r in records] == [1, 2, 4, 8]


def _nccl_worker(port: int) -> dict:
    """A process group of one on the card (NCCL for CUDA tensors): stark-101
    on a mesh of one shard and the 2^21 statement on two shards in this
    process, the collectives through the group."""
    import torch.distributed as dist

    from zkstark_tpu_torch.parallel import initialize_distributed, make_mesh

    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    assert initialize_distributed() == 1
    res = dict(backend=dist.get_backend_config())
    for label, cfg, secret, shards in (("stark101", STARK101, STARK101_SECRET, 1),
                                       ("2^21", square_chain(18), SECRET, 2)):
        solo = prove(cfg, secret, device="cuda")
        mesh = make_mesh(shards, device="cuda")
        assert not mesh.is_local and mesh.n_processes == 1
        got = prove(cfg, secret, mesh=mesh)
        res[label] = dict(bytes=len(got.data), state=got.state.hex(),
                          equal_solo=(got.state, got.data) == (solo.state, solo.data),
                          equal_again=prove(cfg, secret, mesh=mesh) == got,
                          moved=sum(mesh.bytes_moved.values()))
    dist.destroy_process_group()
    return res


def test_nccl_group_of_one(dev):
    """A spawned process starts a group of one on NCCL and proves through it:
    the solo proofs, golden at stark-101, 17,612 bytes at 2^21."""
    res = run_worker("test_torch_cuda_proofs", "_nccl_worker", 600)
    assert "cuda:nccl" in res["backend"], res
    a, b = res["stark101"], res["2^21"]
    assert a["equal_solo"] and a["bytes"] == GOLDEN_LEN and a["state"] == GOLDEN_STATE, res
    assert b["equal_solo"] and b["bytes"] == PROOF_LEN[18] and b["moved"] > 0, res
    assert a["equal_again"] and b["equal_again"], res
