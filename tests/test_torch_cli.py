"""The port's CLI, ``python -m zkstark_tpu_torch``: one case for each case of
tests/test_cli.py (on ``--device cpu``), the proof file byte-equal to the
JAX CLI's over two flag sets that together cover --air (the default
fibonacci-sq proof is held against JAX in test_torch_prove_vs_jax.py),
--blowup 4 and 16, the second prime and three queries, and the device and
profiler flags."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkstark_tpu.__main__ import main as jax_main
from zkstark_tpu_torch.__main__ import main
from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN, fibonacci_sq_trace

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_prove_then_verify_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "proof.bin")
    assert main(CPU + ["--json", "--trace-len", "63", "prove", "--secret", "31415", "--out", out]) == 0
    rec = _last_json(capsys)
    assert rec["proof_size_bytes"] > 0
    assert rec["device"] == "cpu"
    boundary = rec["boundary_last"]
    assert boundary == int(fibonacci_sq_trace(63, 31415)[-1])

    rc = main(CPU + ["--json", "--trace-len", "63", "--boundary-last", str(boundary), "verify", out])
    assert rc == 0
    rec = _last_json(capsys)
    assert rec["verified"] is True
    assert rec["checks_passed"] == 5


def test_verify_wrong_statement_fails(tmp_path, capsys):
    out = str(tmp_path / "proof.bin")
    assert main(CPU + ["--json", "--trace-len", "63", "prove", "--secret", "31415", "--out", out]) == 0
    capsys.readouterr()
    rc = main(CPU + ["--json", "--trace-len", "63", "--boundary-last", "12345", "verify", out])
    assert rc == 1
    rec = _last_json(capsys)
    assert rec["verified"] is False and rec["error"]


def test_run_reports_timings(capsys):
    assert main(CPU + ["--json", "--trace-len", "63", "run", "--secret", "7"]) == 0
    rec = _last_json(capsys)
    assert rec["prover_runtime_seconds"] >= 0
    assert rec["verifier_runtime_seconds"] >= 0
    assert rec["checks_passed"] == 5


def test_bad_witness_reports_error(capsys):
    rc = main(CPU + ["--json", "--trace-len", "63", "--boundary-last", "999", "prove", "--secret", "123"])
    assert rc == 1
    assert "boundary" in _last_json(capsys)["error"]


def test_square_chain_air_flag(tmp_path, capsys):
    out = str(tmp_path / "proof.bin")
    rc = main(CPU + ["--json", "--trace-len", "63", "--air", "square-chain",
                     "prove", "--secret", "271828", "--out", out])
    assert rc == 0
    assert _last_json(capsys)["boundary_last"] == int(SQUARE_CHAIN.trace(63, 271828)[-1])


def test_prove_with_checkpoint_resumes(tmp_path, capsys):
    """--checkpoint spends its file on success; a second identical run
    proves from scratch to the same bytes; a run that finds a checkpoint
    left at the post-device barrier resumes it to the same bytes too."""
    from zkstark_tpu_torch.protocol.checkpoint import ResumableProver
    from zkstark_tpu_torch.protocol.config import StarkConfig

    out1, out2, out3 = (str(tmp_path / f"p{i}.bin") for i in (1, 2, 3))
    ck = str(tmp_path / "ck.npz")
    args = CPU + ["--json", "--trace-len", "63"]
    assert main(args + ["prove", "--secret", "31415", "--out", out1, "--checkpoint", ck]) == 0
    assert not os.path.exists(ck)
    assert main(args + ["prove", "--secret", "31415", "--out", out2, "--checkpoint", ck]) == 0
    cfg = StarkConfig(trace_len=63, boundary_last=int(fibonacci_sq_trace(63, 31415)[-1]))
    assert ResumableProver(cfg, 31415, ck, fused=True, device="cpu").run(stop_after="fused") is None
    assert main(args + ["prove", "--secret", "31415", "--out", out3, "--checkpoint", ck]) == 0
    assert not os.path.exists(ck)
    blobs = {open(p, "rb").read() for p in (out1, out2, out3)}
    assert len(blobs) == 1


def test_verify_unreadable_proof_file(tmp_path, capsys):
    bad = str(tmp_path / "garbage.bin")
    open(bad, "wb").write(b"nonsense")
    rc = main(CPU + ["--json", "--trace-len", "63", "--boundary-last", "1", "verify", bad])
    assert rc == 1
    rec = _last_json(capsys)
    assert rec["verified"] is False and "unreadable" in rec["error"]
    assert main(CPU + ["--json", "verify", str(tmp_path / "missing.bin")]) == 1


FLAG_SETS = {
    "fib-blowup4-alt-prime-q3": [
        "--air", "fibonacci", "--blowup", "4", "--prime", "2013265921", "--queries", "3",
    ],
    "square-chain-blowup16": ["--air", "square-chain", "--blowup", "16"],
}


@pytest.mark.parametrize("name", FLAG_SETS)
def test_proof_file_equals_jax_cli(tmp_path, capsys, name):
    flags = ["--json", "--trace-len", "63", *FLAG_SETS[name]]
    ours, theirs = str(tmp_path / "torch.bin"), str(tmp_path / "jax.bin")
    assert main(CPU + flags + ["prove", "--secret", "31415", "--out", ours]) == 0
    rec = _last_json(capsys)
    assert jax_main(flags + ["prove", "--secret", "31415", "--out", theirs]) == 0
    assert _last_json(capsys)["boundary_last"] == rec["boundary_last"]
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    verify = ["--boundary-last", str(rec["boundary_last"]), "verify", ours]
    assert main(CPU + flags + verify) == 0


def test_run_profile_writes_chrome_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert main(CPU + ["--json", "--trace-len", "15", "--blowup", "4", "run", "--profile", str(prof)]) == 0
    rec = _last_json(capsys)
    assert rec["checks_passed"] == 5
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert events
    # the profiled prove's spans over its kernels (tracing.annotate()): the
    # fused core and, inside it, its trees, one a commit
    spans = [e for e in events if e.get("ph") == "X" and e["name"] in ("enqueue", "merkle")]
    enqueue = [e for e in spans if e["name"] == "enqueue"]
    merkle = [e for e in spans if e["name"] == "merkle"]
    assert len(enqueue) == 1 and len(merkle) == 2 + 4  # f, cp and 4 FRI layers at 64 points
    assert all(enqueue[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= enqueue[0]["ts"] + enqueue[0]["dur"]
               for e in merkle)
    # `run` reports the tracer's totals of the process: here at least the
    # warm-up prove and the profiled one
    assert rec["spans"]["spans"]["prove"]["count"] >= 2
    assert rec["spans"]["spans"]["merkle"]["count"] >= 2 * (2 + 4)


def test_device_cuda_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, "-m", "zkstark_tpu_torch", "--device", "cuda", "--json",
         "prove", "--out", str(tmp_path / "p.bin")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not (tmp_path / "p.bin").exists()


def test_sass_counts_parses_kernels_and_loops():
    """tools.sass_counts on a cuobjdump-style listing: opcodes by family,
    predicated lines, and a loop as a backward branch with its target."""
    from zkstark_tpu_torch.tools import sass_counts

    listing = """
        Function : _ZN3foo15ntt_rows_kernelILi12EEEvNS_8RowsArgsE
    .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;
        /*0030*/                   STS [R3], R2 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
        Function : other
        /*0000*/                   EXIT ;
    """
    parsed = sass_counts.parse(listing)
    assert [len(v) for v in parsed.values()] == [6, 1]
    got = sass_counts.summarize(next(iter(parsed.values())))
    assert got["ops"] == 6 and got["top"]["IMAD"] == 1
    assert got["loops"] == [
        {"from": "0x10", "to": "0x40", "ops": 4, "LDS": 1, "STS": 1,
         "top": {"LDS": 1, "IMAD": 1, "STS": 1, "BRA": 1}}
    ]
