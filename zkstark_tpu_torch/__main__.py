"""Command-line entry point — counterpart of ``zkstark_tpu/__main__.py`` (the reference's
main(), main.rs:15-36, plus its config surface):

    python -m zkstark_tpu_torch [--device cuda|cpu] prove  [--out proof.bin] [--secret N]
                                [--checkpoint FILE]
    python -m zkstark_tpu_torch [--device ...] verify proof.bin
    python -m zkstark_tpu_torch [--device ...] run [--secret N] [--profile DIR]

with the global statement flags --trace-len, --blowup, --queries, --air,
--prime, --boundary-last and --json before the command. ``--device``
(default ``cuda``) is where the prover runs; without a card, ``cuda`` exits
with an error. Started by torchrun, the processes join one group
(`parallel.initialize_distributed`, before anything else) and prove sharded
over it, one shard a process; process 0 writes the proof file. A proof file
holds the same bytes as the JAX CLI's for the same flags, whatever the
sharding.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch


def _build_cfg(args, secret: int | None = None):
    """(StarkConfig, seconds spent deriving boundary_last from the witness)."""
    from zkstark_tpu_torch.field.fp import field_for
    from zkstark_tpu_torch.protocol.air import AIRS
    from zkstark_tpu_torch.protocol.config import StarkConfig

    kw = {}
    if args.trace_len is not None:
        kw["trace_len"] = args.trace_len
    if args.blowup is not None:
        kw["blowup"] = args.blowup
    if args.queries is not None:
        kw["n_queries"] = args.queries
    if args.prime is not None:
        kw["field"] = field_for(args.prime)
    if args.air is not None:
        kw["air"] = AIRS[args.air]
    witness_s = 0.0
    if args.boundary_last is not None:
        kw["boundary_last"] = args.boundary_last
    elif secret is not None and (kw or secret != 3141592):
        # Proving side: the public output is the endpoint of the witness the
        # prover knows (zkstark_tpu/__main__.py:42-51); prove() runs the
        # witness again. Verifiers of a non-default statement pass
        # --boundary-last (prove prints it).
        t0 = time.perf_counter()
        air = kw.get("air", StarkConfig.air)
        p = kw["field"].p if "field" in kw else StarkConfig.field.p
        trace = air.trace(kw.get("trace_len", StarkConfig.trace_len), secret, p)
        kw["boundary_last"] = int(trace[-1])
        witness_s = time.perf_counter() - t0
    return StarkConfig(**kw), witness_s


def _emit(args, payload: dict):
    if args.json:
        print(json.dumps(payload), flush=True)
    else:
        for k, v in payload.items():
            print(f"{k}: {v}", flush=True)


def _device_report(dev: torch.device) -> dict:
    """Where the proof ran, which CUDA kernels it launched, and the tracer's
    spans and counters of the process (``tracing.totals()``)."""
    from zkstark_tpu_torch import ops, tracing

    rec = {"device": str(dev), "kernel_launches": ops.launch_counts(),
           "spans": tracing.totals()}
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return rec


def cmd_prove(args, dev) -> int:
    from zkstark_tpu_torch.protocol.prover import prove

    cfg, witness_s = _build_cfg(args, secret=args.secret)
    t0 = time.perf_counter()
    try:
        if args.checkpoint:
            # a checkpoint is written after all device work; re-running the
            # same command after a crash resumes from it
            from zkstark_tpu_torch.protocol.checkpoint import ResumableProver

            proof = ResumableProver(cfg, args.secret, args.checkpoint, fused=True, device=dev,
                                    mesh=args.mesh).run()
        else:
            proof = prove(cfg, secret=args.secret, device=dev, mesh=args.mesh)
    except ValueError as e:
        _emit(args, {"error": str(e)})
        return 1
    dt = time.perf_counter() - t0
    if args.mesh is None or args.mesh.process == 0:
        with open(args.out, "wb") as f:
            f.write(proof.to_bytes())
    _emit(
        args,
        {
            "prover_runtime_seconds": round(dt, 4),
            "proof_size_bytes": proof.size(),
            "boundary_last": cfg.boundary_last,
            "out": args.out,
            "witness_seconds": round(witness_s, 4),
            **_device_report(dev),
        },
    )
    return 0


def cmd_verify(args, dev) -> int:
    from zkstark_tpu_torch.protocol.proof import Proof
    from zkstark_tpu_torch.protocol.verifier import VerificationError, verify

    cfg, _ = _build_cfg(args)
    try:
        with open(args.proof, "rb") as f:
            proof = Proof.from_bytes(f.read())
    except (OSError, ValueError) as e:
        _emit(args, {"verified": False, "error": f"unreadable proof: {e}"})
        return 1
    t0 = time.perf_counter()
    try:
        report = verify(proof, cfg)
    except VerificationError as e:
        _emit(args, {"verified": False, "error": str(e)})
        return 1
    dt = time.perf_counter() - t0
    _emit(
        args,
        {
            "verified": True,
            "verifier_runtime_seconds": round(dt, 6),
            "checks_passed": len(report.checks_passed),
        },
    )
    return 0


def _profiler(out_dir: str, dev: torch.device):
    """torch.profiler over the block, the tracer's spans annotated on its
    timeline (``tracing.annotate()``); a Chrome trace lands in out_dir."""
    from torch.profiler import ProfilerActivity, profile

    from zkstark_tpu_torch import tracing

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)

    def save(prof):
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))

    stack = contextlib.ExitStack()
    stack.enter_context(profile(activities=acts, on_trace_ready=save))
    stack.enter_context(tracing.annotate())
    return stack


def cmd_run(args, dev) -> int:
    """prove + verify + size print — the reference main()'s behavior."""
    from zkstark_tpu_torch.protocol.prover import prove
    from zkstark_tpu_torch.protocol.verifier import verify

    cfg, witness_s = _build_cfg(args, secret=args.secret)
    try:
        if args.profile:
            # trace the steady state, not the first call: one warm-up prove
            prove(cfg, secret=args.secret, device=dev, mesh=args.mesh)
        ctx = _profiler(args.profile, dev) if args.profile else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            proof = prove(cfg, secret=args.secret, device=dev, mesh=args.mesh)
    except ValueError as e:
        _emit(args, {"error": str(e)})
        return 1
    t1 = time.perf_counter()
    report = verify(proof, cfg)
    t2 = time.perf_counter()
    _emit(
        args,
        {
            "prover_runtime_seconds": round(t1 - t0, 4),
            "verifier_runtime_seconds": round(t2 - t1, 6),
            "proof_size_bytes": proof.size(),
            "checks_passed": len(report.checks_passed),
            "witness_seconds": round(witness_s, 4),
            **_device_report(dev),
        },
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkstark_tpu_torch")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the prover runs (default cuda; exits with an error if there "
        "is no CUDA device); cpu runs the kernels' plain-torch twins",
    )
    ap.add_argument("--trace-len", type=int, default=None)
    ap.add_argument("--blowup", type=int, default=None)
    ap.add_argument(
        "--queries",
        type=int,
        default=None,
        help="FRI query count (default 1, the reference's single query, prover.rs:263)",
    )
    ap.add_argument(
        "--air",
        choices=["fibonacci-sq", "fibonacci", "square-chain"],
        default=None,
        help="constraint system / witness generator (default fibonacci-sq, the "
        "reference's statement; square-chain = iterated squaring with the "
        "secret as the chain seed)",
    )
    ap.add_argument(
        "--prime",
        type=int,
        default=None,
        help="protocol field prime (default 3221225473 = 3*2^30+1; any odd prime "
        "< 2^32 with enough 2-adicity for the domain, e.g. 2013265921 = 15*2^27+1)",
    )
    ap.add_argument(
        "--boundary-last",
        type=int,
        default=None,
        help="public output a[trace_len-1]; derived from the witness when "
        "proving, required when verifying a non-default statement",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove", help="generate a proof and write it to a file")
    p.add_argument("--out", default="proof.bin")
    p.add_argument("--secret", type=int, default=3141592)
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="FILE",
        help="write a resumable checkpoint after all device work; re-running "
        "after a crash resumes from it (protocol/checkpoint.py)",
    )
    p.set_defaults(fn=cmd_prove)

    v = sub.add_parser("verify", help="verify a proof file")
    v.add_argument("proof")
    v.set_defaults(fn=cmd_verify)

    r = sub.add_parser("run", help="prove + verify in one process (main.rs:15-36)")
    r.add_argument("--secret", type=int, default=3141592)
    r.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a torch.profiler Chrome trace (DIR/trace.json) of one "
        "warm prove, the prover's spans over its kernels",
    )
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    from zkstark_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    # the process group first (a no-op in a single process), as the JAX CLI
    # joins its cluster before any other call
    processes = initialize_distributed()
    from zkstark_tpu_torch.protocol.prover import resolve_device

    try:
        dev = resolve_device(args.device)
        args.mesh = make_mesh(device=dev) if processes > 1 else None
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"zkstark_tpu_torch: {e}") from e
    if args.mesh is not None:
        dev = args.mesh.device
    return args.fn(args, dev)


if __name__ == "__main__":
    sys.exit(main())
