"""End-to-end proof at production scale — counterpart of ``tools/prove_big.py``:
the full Fiat-Shamir transcript and decommitment of the square-chain
statement at --trace-bits (evaluation domain 2^(trace_bits + 3) at blowup 8),
then its verification.

    python -m zkstark_tpu_torch.tools.prove_big --trace-bits 22   # 2^25 points
    python -m zkstark_tpu_torch.tools.prove_big --trace-bits 24   # 2^27 points

Trace bits up to 25 (2^28 points, the largest four-step size) have an NTT
route; past 2^26 points it is the limb-matrix transform of
``ops/limb_dft.py``. Prints one JSON line per step: the witness, the cold
prove (with its phase spans and the peak device memory so far, so that a run
that later dies of memory has left its peak), then the metric ``prove_latency_2e<bits+3>``, the best of --repeats
warm proves, with the results of both verifiers (the port's and the C++ one
of ``native/``) and of the check of the proof's length against the proof
layout. Each prove ends when its proof bytes are on the host, so the
host clock needs no extra device synchronisation. ``--device cpu`` runs the
kernels' plain-torch twins.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

SECRET = 271828


def _print(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def run(trace_bits: int = 21, blowup: int = 8, queries: int = 1, repeats: int = 2,
        device="cuda", emit=_print):
    """Prove the statement and check the proof three ways (the port's
    verifier, the C++ verifier, its length against the proof layout); returns
    (proof, cfg, metric record). A check that fails raises, the layout check
    after the record that shows it has been emitted."""
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol import prove, verify
    from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN
    from zkstark_tpu_torch.protocol.config import StarkConfig
    from zkstark_tpu_torch.protocol.proof import expected_proof_len
    from zkstark_tpu_torch.protocol.prover import resolve_device

    dev = resolve_device(device)
    trace_len = (1 << trace_bits) - 1
    t0 = time.perf_counter()
    # square-chain: one sequential modular square per step, the cheapest
    # host witness of the three AIRs
    trace = SQUARE_CHAIN.trace(trace_len, SECRET)
    cfg = StarkConfig(
        trace_len=trace_len,
        blowup=blowup,
        boundary_last=int(trace[-1]),
        n_queries=queries,
        air=SQUARE_CHAIN,
    )
    emit({"step": "witness", "seconds": round(time.perf_counter() - t0, 4),
          "trace_len": trace_len, "eval_domain": cfg.eval_domain,
          "fri_rounds": cfg.fri_rounds})

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {}
    t0 = time.perf_counter()
    proof = prove(cfg, SECRET, device=dev, timings=phases, fused=False)
    cold = time.perf_counter() - t0
    rec = {"step": "cold_prove", "seconds": round(cold, 4), "proof_bytes": len(proof.data),
           "phases": {k: round(v, 4) for k, v in phases.items()}}
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    emit(rec)

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        again = prove(cfg, SECRET, device=dev, fused=False)
        best = min(best, time.perf_counter() - t0)
        if again != proof:
            raise AssertionError("the proof changed between runs")
    t0 = time.perf_counter()
    verify(proof, cfg)
    vs = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_native(proof, cfg)
    native_vs = time.perf_counter() - t0
    layout_bytes = expected_proof_len(cfg)
    rec = {
        "metric": f"prove_latency_2e{trace_bits + 3}",
        "value": round(best, 4),
        "unit": "seconds",
        "points_per_sec": round(cfg.eval_domain / best),
        "verified": True,
        "verify_seconds": round(vs, 4),
        "verified_native": True,
        "verify_native_seconds": round(native_vs, 4),
        "proof_bytes": len(proof.data),
        "layout_bytes": layout_bytes,
        "layout_ok": len(proof.data) == layout_bytes,
        "trace_bits": trace_bits,
        "queries": queries,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    emit(rec)
    if not rec["layout_ok"]:
        raise AssertionError(f"the proof has {len(proof.data)} bytes, its layout gives {layout_bytes}")
    return proof, cfg, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkstark_tpu_torch.tools.prove_big")
    ap.add_argument("--trace-bits", type=int, default=21)
    ap.add_argument("--blowup", type=int, default=8)
    ap.add_argument("--queries", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.trace_bits, args.blowup, args.queries, args.repeats, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
