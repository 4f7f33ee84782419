"""Domain-scaling bench — counterpart of ``tools/scaling_bench.py``: the
device side of a proof (LDE, commits and the FRI schedule, with the
challenges as inputs: `parallel.pipeline.proof_core`) at one evaluation
domain over meshes of S shards, with points per second and the scaling
efficiency eff(S) = t(1)/(S·t(S)).

    python -m zkstark_tpu_torch.tools.scaling_bench --bits 24 --devices 1 2 4 8
    python -m zkstark_tpu_torch.tools.scaling_bench --bits 12 --devices 1 2 4 --repeats 1 \\
        --device cpu

The witness and the challenges are the JAX tool's: random residues from
``numpy.random.default_rng(0)`` (the device program does not check the
boundary). As in the JAX tool, the baseline is a mesh of one shard, not
``mesh=None``, so every S runs the same sharded algorithm (the six-step LDE,
subtree commits, sharded folds). One JSON line per S, with the JAX tool's
keys; its ``compile_seconds`` is here ``first_call_seconds``: the first call
at that S, which builds the kernels (the first S only) and the constant
tables. Every S must give the same roots, free term and final layer, word for
word; the tool raises if one differs.

A mesh is local here (``parallel.make_mesh`` in one process): its S shards
are S allocations on the one device, and their collectives are device
copies. On one card `scaling_efficiency` therefore measures what S-fold
launches of 1/S-size work cost, not scaling across cards. ``--device``
defaults to cuda and exits 1 without a card; ``--device cpu`` runs the
kernels' plain-torch twins.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _print(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _inputs(bits: int, blowup: int, device):
    """(cfg, trace, alphas, betas): the JAX tool's synthetic witness and
    challenges, Montgomery form on `device`."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.protocol.config import StarkConfig

    fld = fp.FIELD101
    trace_len = (1 << bits) // blowup - 1
    rng = np.random.default_rng(0)
    trace = rng.integers(0, fld.p, trace_len, dtype=np.uint64).astype(np.uint32)
    cfg = StarkConfig(trace_len=trace_len, blowup=blowup, boundary_first=int(trace[0]),
                      boundary_last=int(trace[-1]))
    alphas = rng.integers(0, fld.p, 3, dtype=np.uint64).astype(np.uint32)
    betas = rng.integers(0, fld.p, cfg.fri_rounds, dtype=np.uint64).astype(np.uint32)
    return cfg, *(fp.from_host(fld.host_to_mont(a), device) for a in (trace, alphas, betas))


def run(bits: int = 24, blowup: int = 8, devices=(1, 2, 4, 8), repeats: int = 3,
        device="cuda", emit=_print) -> list:
    """The bench; returns the records it emitted."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.parallel import make_mesh
    from zkstark_tpu_torch.parallel.pipeline import proof_core
    from zkstark_tpu_torch.protocol.prover import resolve_device

    dev = resolve_device(device)
    cfg, trace, alphas, betas = _inputs(bits, blowup, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def finish():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results, records, want = {}, [], None
    for s in devices:
        fn = proof_core(cfg, make_mesh(s, device=dev))
        t0 = time.perf_counter()
        out = fn(trace, alphas, betas)
        finish()
        first = time.perf_counter() - t0
        got = {k: fp.to_host(v) for k, v in out.items()}
        if want is None:
            want = got
        elif any(not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"scaling_bench: the outputs at S = {s} differ from those at "
                                 f"S = {devices[0]}")
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(trace, alphas, betas)
            finish()
            best = min(best, time.perf_counter() - t0)
        results[s] = best
        s0 = min(results)  # the smallest measured mesh is the efficiency baseline
        rec = {
            "devices": s,
            "bits": bits,
            "seconds": best,
            "first_call_seconds": first,
            "points_per_sec": cfg.eval_domain / best,
            "scaling_efficiency": results[s0] * s0 / (best * s),
            "mesh": "local",
            "device": name,
        }
        emit(rec)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkstark_tpu_torch.tools.scaling_bench")
    ap.add_argument("--bits", type=int, default=24, help="log2(eval domain)")
    ap.add_argument("--blowup", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="shard counts of the local meshes")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fri-rounds", type=int, default=None,
                    help="accepted and ignored, as by the JAX tool: the full schedule runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.bits, args.blowup, args.devices, args.repeats, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
