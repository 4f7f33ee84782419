"""Benchmark harness — counterpart of the repository's ``bench.py``: the same
metrics under the same names, measured on the card.

    python -m zkstark_tpu_torch.tools.bench               # the default run
    python -m zkstark_tpu_torch.tools.bench --repeats 5 --all
    python -m zkstark_tpu_torch.tools.bench --quick       # stark-101 only

As ``bench.py`` does, it streams cumulative JSON lines: after every
measurement the whole record so far is printed again as one stdout line, so
a run cut short still leaves its last line parseable. A ``status: "warming"``
line comes before any device work, a ``provisional`` headline after the
first timed prove, and the last line carries the headline,
``stark101_prove_latency``: the least of ``--repeats`` warm proves of the
stark-101 statement (7,836 proof bytes, checked on every proof), from the
call to the bytes on the host. ``vs_baseline`` is 9.1 s (a host Python
replay of the reference prover on one core, BASELINE.md) over it. Each
kernel and batch section is gated by the elapsed-time budget (``--budget``,
or ``ZKSTARK_BENCH_BUDGET``, default 1200 s); a section it cuts is listed
under ``skipped``. Diagnostics go to stderr as JSON lines.

Metrics, cheapest first, as in ``bench.py``: ``warmup_prove_seconds``,
``verify_seconds``, ``phases`` (the spans of one prove on the default fused
path), ``stark101_prove_pipelined_latency`` (`prove_pipelined` of 12, per
proof), ``merkle_hashes_per_sec_2e20`` (8 trees of 2^20 leaves back to back,
each tree's leaves the last ones plus the first word of its root),
``ntt_points_per_sec_2e24`` (8 forward NTTs back to back, each output the
next input) with ``ntt_sol_ratio_2e24`` and ``ntt_ops_ratio_2e24``,
``proofs_per_sec_b32`` (`prove_batch` of ``--batch``), ``proofs_per_sec_b64``
(`prove_batch_pipelined` of 4 batches of 64, only when ``--batch`` is 32),
``ntt_points_per_sec_2e27`` and, with ``--all``, ``ntt_points_per_sec_2e16``,
``_2e20`` and ``_2e22``. Device work is timed on the host clock around work
that ends with the device synchronised (a prove ends with its bytes on the
host).

Where it differs from ``bench.py``:

* The ratios are the card's. ``ntt_sol_ratio_2e24`` is the time of one
  transform over six passes of its u32 array at the card's memory rate;
  ``ntt_ops_ratio_2e24`` (``bench.py``'s ``ntt_vpu_ratio_2e24``: the card has
  no VPU) is that time over the integer ops of the four-step's two row
  passes at the card's integer rate (``tools.roofline``). On the CPU both are
  null: the peaks are not the CPU's.
* In place of the compilation cache the kernels are built once
  (``ops._build.kernels``) before the warm-up prove, with ``build_seconds`` on
  stderr (``nvcc_seconds``: the tracer's ``library.build`` span), so that ``warmup_prove_seconds`` holds no nvcc.
* Every record carries ``device`` (the card's name, or ``"cpu"``) and
  ``power_limit`` (nvidia-smi's, or null); the numbers are not rounded; the
  kernel launches of the run go to stderr (``ops.launch_counts``).

``--device`` defaults to cuda and exits 1 without a card; ``--device cpu``
runs the kernels' plain-torch twins, for tests. The sizes of each section
are keyword arguments of `run`, with ``bench.py``'s values as defaults; a
record of a run with other sizes lists them under ``reduced`` and keeps
``bench.py``'s metric names.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_REPLAY_SECONDS = 9.1  # BASELINE.md: a host Python replay of the reference, 1 core
GOLDEN_LEN = 7836  # the stark-101 proof's bytes
NTT_BEST_OF = 3


def eprint(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


class Record:
    """Cumulative benchmark record, printed again to stdout after every
    update, so that the last stdout line always carries everything measured
    so far."""

    def __init__(self, device: str, power_limit: str | None, reduced: dict | None = None):
        self.start = time.perf_counter()
        self.extra = {}
        self.best = None
        self.provisional = True
        self.skipped = []
        self.device = device
        self.power_limit = power_limit
        self.reduced = reduced
        self.last = None

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def emit(self) -> None:
        line = {
            "metric": "stark101_prove_latency",
            "value": self.best,
            "unit": "seconds",
            "vs_baseline": BASELINE_REPLAY_SECONDS / self.best if self.best else None,
            "device": self.device,
            "power_limit": self.power_limit,
            **self.extra,
        }
        if self.provisional:
            line["provisional"] = True
        if self.skipped:
            line["skipped"] = self.skipped
        if self.reduced:
            line["reduced"] = self.reduced
        print(json.dumps(line), flush=True)
        self.last = line

    def update(self, **kw) -> None:
        self.extra.update(kw)
        self.emit()


def over_budget(budget: float, section: str, rec: Record, reserve: float = 0.0) -> bool:
    """True (and the skip recorded) if running `section` would bust the budget."""
    if rec.elapsed() + reserve > budget:
        rec.skipped.append(section)
        eprint({"phase": "skipped", "section": section, "elapsed": rec.elapsed()})
        rec.emit()
        return True
    return False


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _golden(proofs, what: str) -> None:
    lengths = [len(p.data) for p in proofs]
    if any(n != GOLDEN_LEN for n in lengths):
        raise AssertionError(f"{what}: proof lengths {lengths}, want {GOLDEN_LEN} bytes each")


def _device_info(dev: torch.device) -> tuple:
    """(name, power limit, nvidia-smi's line) of `dev`; the CPU has neither."""
    if dev.type != "cuda":
        return "cpu", None, None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev), line.rsplit(",", 1)[1].strip(), line


def bench_stark101(repeats: int, rec: Record, dev: torch.device, pipelined_proofs: int = 12) -> None:
    from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, prove, prove_pipelined, verify

    # warm-up: the constant tables and the allocator's pools, once
    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET, device=dev)
    warmup = time.perf_counter() - t0
    eprint({"phase": "warmup_prove_seconds", "value": warmup})
    _golden([proof], "warm-up prove")
    rec.extra.pop("status", None)  # warming is over
    rec.update(warmup_prove_seconds=warmup)

    # the first timed repeat gives a provisional headline
    t0 = time.perf_counter()
    proofs = [prove(STARK101, STARK101_SECRET, device=dev)]
    times = [time.perf_counter() - t0]
    _golden(proofs, "timed prove")
    rec.best = times[0]
    rec.emit()

    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        proofs.append(prove(STARK101, STARK101_SECRET, device=dev))
        times.append(time.perf_counter() - t0)
    _golden(proofs, "timed proves")
    rec.best = min(times)
    rec.provisional = False
    rec.emit()
    eprint({"phase": "prove_seconds_all", "value": times})

    t0 = time.perf_counter()
    verify(proofs[-1], STARK101)
    rec.update(verify_seconds=time.perf_counter() - t0)

    # one prove with its spans
    timings = {}
    _golden([prove(STARK101, STARK101_SECRET, device=dev, timings=timings)], "spanned prove")
    rec.update(phases=timings)

    # the per-proof time of a stream: the next witnesses and the fetch,
    # replay and serialization of earlier proofs overlap the device programs
    proofs = prove_pipelined(STARK101, [STARK101_SECRET] * 2, device=dev)  # warm-up
    _golden(proofs, "prove_pipelined warm-up")
    t0 = time.perf_counter()
    proofs = prove_pipelined(STARK101, [STARK101_SECRET] * pipelined_proofs, device=dev)
    per = (time.perf_counter() - t0) / pipelined_proofs
    _golden(proofs, "prove_pipelined")
    rec.update(stark101_prove_pipelined_latency=per)
    eprint({"metric": "stark101_prove_pipelined_latency", "value": per})


def ntt_input(n: int, dev) -> torch.Tensor:
    """``bench.py``'s NTT input: n residues of ``default_rng(0)``, Montgomery form."""
    from zkstark_tpu_torch.field import fp

    rng = np.random.default_rng(0)
    return fp.from_host(fp.host_to_mont(rng.integers(0, fp.P, n, dtype=np.uint64).astype(np.uint32)),
                        dev)


def ntt_chain(x: torch.Tensor, plan, reps: int) -> torch.Tensor:
    """The timed NTT work: `reps` forward transforms, each output the next
    input (``bench.py``'s scan)."""
    from zkstark_tpu_torch import ntt

    for _ in range(reps):
        x = ntt.ntt(x, plan)
    return x


def bench_ntt(log_n: int, dev: torch.device, reps: int = 8) -> float:
    """Points per second of a size-2^log_n forward NTT: the best of 3 runs of
    `ntt_chain`, per transform."""
    from zkstark_tpu_torch import ntt

    n = 1 << log_n
    plan = ntt.forward_plan(n)
    x = ntt_input(n, dev)
    ntt_chain(x, plan, reps)
    _sync(dev)
    best = float("inf")
    for _ in range(NTT_BEST_OF):
        t0 = time.perf_counter()
        ntt_chain(x, plan, reps)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    return n / best


def ntt_sol_seconds(log_n: int) -> float:
    """The memory bound of one transform as ``bench.py`` counts it: six
    passes of the u32 array (the four-step's two row passes and its
    transposes, each a read and a write), at the card's memory rate."""
    from zkstark_tpu_torch.tools import roofline

    return 6 * (1 << log_n) * 4 / roofline.HBM_BYTES_PER_S


def ntt_ops_seconds(log_n: int) -> float:
    """The operations bound of one transform: the integer ops of the
    four-step's two `ntt_rows` passes at the card's integer rate."""
    from zkstark_tpu_torch.tools import roofline

    return roofline.fourstep_ops(1 << log_n) / roofline.INT32_INSTR_PER_S


def merkle_input(n: int, dev) -> torch.Tensor:
    """``bench.py``'s Merkle leaves: n u32 words of ``default_rng(0)``."""
    from zkstark_tpu_torch.field import fp

    rng = np.random.default_rng(0)
    return fp.from_host(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32), dev)


def merkle_chain(values: torch.Tensor, reps: int) -> torch.Tensor:
    """The timed Merkle work: `reps` trees back to back, each tree's leaves
    the previous ones plus the first word of its root mod 2^32 (``bench.py``'s
    scan); returns the (reps, 8) roots. The add runs on int32 views, whose
    two's-complement wrap is the add mod 2^32."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.hash import merkle

    roots = torch.empty((reps, 8), dtype=torch.int32, device=values.device)
    c = fp.as_i32(values)
    for i in range(reps):
        root = fp.as_i32(merkle.build_levels(fp.as_u32(c))[-1][0])
        roots[i] = root
        c = c + root[0]
    return fp.as_u32(roots)


def bench_merkle(log_n: int, dev: torch.device, repeats: int = 5, reps: int = 8) -> float:
    """SHA-256 hashes per second of a whole 2^log_n-leaf commitment (2n − 1
    hashes): the best of `repeats` runs of `merkle_chain`, per tree."""
    n = 1 << log_n
    x = merkle_input(n, dev)
    merkle_chain(x, reps)
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        merkle_chain(x, reps)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    return (2 * n - 1) / best


def bench_proofs_per_sec(batch: int, dev: torch.device, repeats: int = 2) -> float:
    """Batched proving throughput: B witnesses through one `prove_batch`."""
    from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET
    from zkstark_tpu_torch.protocol.batch import prove_batch

    secrets = [STARK101_SECRET] * batch
    _golden(prove_batch(STARK101, secrets, device=dev), "prove_batch warm-up")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        proofs = prove_batch(STARK101, secrets, device=dev)
        best = min(best, time.perf_counter() - t0)
        _golden(proofs, "prove_batch")
    return batch / best


def bench_proofs_per_sec_pipelined(batch: int, dev: torch.device, n_batches: int = 4) -> float:
    """Batched throughput with the host work of one batch overlapping the
    next batch's device program (`prove_batch_pipelined`)."""
    from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET
    from zkstark_tpu_torch.protocol.batch import prove_batch_pipelined

    batches = [[STARK101_SECRET] * batch] * n_batches
    _golden(prove_batch_pipelined(STARK101, batches[:2], device=dev), "prove_batch_pipelined warm-up")
    t0 = time.perf_counter()
    proofs = prove_batch_pipelined(STARK101, batches, device=dev)
    dt = time.perf_counter() - t0
    _golden(proofs, "prove_batch_pipelined")
    return batch * n_batches / dt


def run(
    repeats: int = 3,
    all_sizes: bool = False,
    quick: bool = False,
    batch: int = 32,
    budget: float = 1200.0,
    device="cuda",
    *,
    pipelined_proofs: int = 12,
    merkle_bits: int = 20,
    ntt_bits: int = 24,
    big_ntt_bits: int = 27,
    sweep_bits: tuple = (16, 20, 22),
    batch_proofs: int | None = None,
    pipelined_batch: int = 64,
    pipelined_batches: int = 4,
) -> dict:
    """The bench (``bench.py``'s `main` past its flags); returns the last
    record it printed. The keyword-only sizes default to ``bench.py``'s
    (`batch_proofs` None: `batch`); the metric names stay ``bench.py``'s
    whatever the sizes."""
    from zkstark_tpu_torch import ops, tracing
    from zkstark_tpu_torch.ops import _build, ntt_kernel
    from zkstark_tpu_torch.parallel.mesh import initialize_distributed
    from zkstark_tpu_torch.protocol.prover import resolve_device

    sizes = inspect.signature(run).parameters
    given = dict(pipelined_proofs=pipelined_proofs, merkle_bits=merkle_bits, ntt_bits=ntt_bits,
                 big_ntt_bits=big_ntt_bits, sweep_bits=tuple(sweep_bits),
                 batch_proofs=batch_proofs, pipelined_batch=pipelined_batch,
                 pipelined_batches=pipelined_batches)
    reduced = {k: v for k, v in given.items() if v != sizes[k].default}

    n_procs = initialize_distributed()  # a no-op in one process
    dev = resolve_device(device)
    name, power_limit, smi = _device_info(dev)
    eprint({"phase": "devices", "value": name,
            "count": torch.cuda.device_count() if dev.type == "cuda" else 0,
            "nvidia_smi": smi, "processes": n_procs})

    rec = Record(name, power_limit, reduced)
    # one line before any device work: a run cut during the warm-up still
    # shows that it was alive and warming
    rec.update(status="warming")
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.kernels()
        eprint({"phase": "build_seconds", "value": time.perf_counter() - t0,
                "nvcc_seconds": tracing.totals()["spans"].get("library.build", {}).get(
                    "total_ns", 0) * 1e-9})
    ops.reset_launch_counts()
    bench_stark101(repeats, rec, dev, pipelined_proofs)

    def ratio(seconds_per_point, bound_seconds):
        return seconds_per_point / bound_seconds if dev.type == "cuda" else None

    if not quick:
        # kernel and batch metrics, cheapest first, each gated by the budget
        if not over_budget(budget, "merkle_2e20", rec):
            hps = bench_merkle(merkle_bits, dev)
            rec.update(merkle_hashes_per_sec_2e20=hps)
            eprint({"metric": "merkle_hashes_per_sec_2e20", "value": hps})
        if not over_budget(budget, "ntt_2e24", rec):
            pps = bench_ntt(ntt_bits, dev)
            n = 1 << ntt_bits
            rec.update(
                ntt_points_per_sec_2e24=pps,
                ntt_sol_ratio_2e24=ratio(n / pps, ntt_sol_seconds(ntt_bits)),
                ntt_ops_ratio_2e24=ratio(n / pps, ntt_ops_seconds(ntt_bits)),
            )
            eprint({"metric": "ntt_points_per_sec_2e24", "value": pps,
                    "sol_ratio": rec.extra["ntt_sol_ratio_2e24"],
                    "ops_ratio": rec.extra["ntt_ops_ratio_2e24"]})
        if not over_budget(budget, f"proofs_per_sec_b{batch}", rec):
            pfs = bench_proofs_per_sec(batch if batch_proofs is None else batch_proofs, dev)
            rec.update(**{f"proofs_per_sec_b{batch}": pfs})
            eprint({"metric": f"proofs_per_sec_b{batch}", "value": pfs})
        if batch == 32 and not over_budget(budget, "proofs_per_sec_b64", rec, reserve=120):
            pfs64 = bench_proofs_per_sec_pipelined(pipelined_batch, dev, pipelined_batches)
            rec.update(proofs_per_sec_b64=pfs64)
            eprint({"metric": "proofs_per_sec_b64", "value": pfs64,
                    "note": "pipelined (host work overlapped across batches)"})
        if ntt_kernel.fourstep_supported(1 << big_ntt_bits) and not over_budget(
            budget, "ntt_2e27", rec, reserve=120
        ):
            pps27 = bench_ntt(big_ntt_bits, dev, reps=4)
            rec.update(ntt_points_per_sec_2e27=pps27)
            eprint({"metric": "ntt_points_per_sec_2e27", "value": pps27})

    if all_sizes:
        for named, log_n in zip((16, 20, 22), sweep_bits):
            if over_budget(budget, f"ntt_2e{named}", rec):
                continue
            pps = bench_ntt(log_n, dev)
            rec.update(**{f"ntt_points_per_sec_2e{named}": pps})
            eprint({"metric": f"ntt_points_per_sec_2e{named}", "value": pps, "unit": "points/s",
                    "sol_ratio": ratio((1 << log_n) / pps, ntt_sol_seconds(log_n))})

    _sync(dev)
    eprint({"phase": "kernel_launches", "value": ops.launch_counts()})
    rec.update(total_bench_seconds=rec.elapsed())
    return rec.last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkstark_tpu_torch.tools.bench")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--all", action="store_true", help="also run the NTT sweep")
    ap.add_argument("--quick", action="store_true", help="skip the kernel and batch metrics")
    ap.add_argument("--batch", type=int, default=32, help="batch size of the proofs/sec metric")
    ap.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("ZKSTARK_BENCH_BUDGET", 1200)),
        help="soft wall-clock budget (s); kernel and batch metrics are skipped past it",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.repeats, args.all, args.quick, args.batch, args.budget, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
