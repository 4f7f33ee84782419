"""The port's benchmark: one cell of ``BENCHMARK.json`` for a fixed time.

    python3 -m proofbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a statement
(``configs/<config>.json``) and a traffic mix (``mixes/<traffic>.json``);
each metric is read by its own file, ``metrics/<name>.py``; the kernels of
each layer are listed in ``kernels/*.json``. Adding a cell, a statement, a
mix, a metric or a kernel is adding files.

A run: set-up (torch, the CUDA context, the kernel library, built by the
program on a checkout's first run; the statement from the seed; the mix's
warm-up calls), then a closed loop of calls for `--seconds`: one caller,
each call started when the last returned, the last call finished. With
`--trace 0` it prints the cell's end-to-end metrics, on the host clock; with
`--trace 1` each `prove` call also fills its spans (each waits for the
device), the launch counters are read around the window, and a stretch of
calls after it runs under torch.profiler (``devtrace.py``): the per-layer
metrics. Then the peak of device memory is read, the program's tensors are
freed, and the plain reference (``reference/``) proves each distinct witness
of the statement's cycle again: every proof of the window is compared with
its witness's, byte for byte. The last stdout line is one JSON object; the
numbers compared, each beside its limit, are the last lines of stderr and
the line's last key.

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result. It exits 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zkstark_tpu"}
PROFILE_SECONDS = 0.5  # device time the profiled stretch aims at
PROFILE_MAX_CALLS = 64


def log(msg: str) -> None:
    print(f"proofbench: {msg}", file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    cell: dict
    statement: object
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # (start, end, proofs returned)
    proofs: int = 0
    peak_bytes: int | None = None
    spans: list = field(default_factory=list)  # one dict a traced `prove`
    launches: dict = field(default_factory=dict)  # over the traced window
    stretch: object = None  # devtrace.Stretch
    layers: dict = field(default_factory=dict)  # layer → kernel names

    @property
    def latencies_s(self) -> list:
        """Each proof's time from its call to its bytes on the host."""
        return [e - s for s, e, n in self.calls for _ in range(n)]


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def kernel_layers() -> dict:
    """{layer: [kernel names]} from every ``kernels/*.json``."""
    out = {}
    for f in sorted((HERE / "kernels").glob("*.json")):
        spec = load_json(f)
        out.setdefault(spec["layer"], []).extend(spec["kernels"])
    return out


def reader(name: str):
    """The `read` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"proofbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports in a run of this kind."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


class Traffic:
    """The mix's calls: call c proves the witnesses c, c + 1, …, c + batch − 1
    of the statement's cycle (``statement.Witness``: a secret and its public
    values), so each call differs from the one before it."""

    def __init__(self, st, mix: dict):
        self.st, self.batch = st, int(mix["batch"])

    def witnesses(self, c: int) -> list:
        return [self.st.witness(c + i) for i in range(self.batch)]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(prog, traffic: Traffic, first: int, seconds: float, traced: bool, rec: Run, device):
    """The closed loop: calls until `seconds` have passed, the last one
    finished. Returns [(witness, state, data)] of every proof returned, and
    the failed proofs' count."""
    out, failed = [], 0
    c = first
    before = prog.launch_counts() if traced else None
    _sync(device)
    t0 = now = time.perf_counter()
    while now - t0 < seconds or not rec.calls:
        witnesses = traffic.witnesses(c)
        start = now
        try:
            proofs = prog.call(witnesses, rec.spans if traced else None)
        except Exception as e:  # a failed call is counted, the loop goes on
            log(f"call {c} failed: {type(e).__name__}: {e}")
            proofs = []
        now = time.perf_counter()
        got = min(len(proofs), len(witnesses))
        failed += len(witnesses) - got
        rec.calls.append((start, now, got))
        out += [(w, st, data) for w, (st, data) in zip(witnesses, proofs)]
        c += 1
    rec.window_s = now - t0
    rec.proofs = len(out)
    if traced:
        after = prog.launch_counts()
        rec.launches = {k: after[k] - before.get(k, 0) for k in after}
    return out, failed, c


def check(out: list, failed: int, st, device) -> dict:
    """Every proof of the window against the reference's proof of its
    witness, keyed by (secret, publics), byte for byte: the numbers compared,
    each with its limit. Each distinct witness of the cycle is proved once."""
    from proofbench.reference import prover as reference

    t = time.perf_counter()
    distinct = {w.key: w for w in st.cycle}
    refs = {k: reference.prove(st, w, device=device) for k, w in distinct.items()}
    wrong = sum(1 for w, state, data in out if refs.get(w.key) != (state, data))
    log(f"reference: {len(refs)} proofs in {time.perf_counter() - t:.3f} s; "
        f"{len(out)} proofs compared")
    return {"wrong_proofs": {"value": wrong, "limit": 0},
            "failed_proofs": {"value": failed, "limit": 0}}


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
        program=None, config: dict | None = None, t0: float = T0) -> dict:
    """One run of the cell `name`; returns the result line's object. Tests
    pass `program`, a stand-in for the port (a broken one, or the control),
    and `config`, a statement in place of the cell's file."""
    import torch

    from proofbench import devtrace
    from proofbench.program import Port
    from proofbench.yardstick import statement

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    st = statement.make(cell["config"], config or statement.load_config(cell["config"]), seed)
    rec = Run(cell=cell, statement=st, mix=mix, layers=kernel_layers())
    traffic = Traffic(st, mix)
    prog = program(st, mix, device) if program else Port(st, mix, device)
    warm = int(mix["warmup_calls"])
    for c in range(warm):
        prog.call(traffic.witnesses(c))
    _sync(device)
    gc.collect()
    rec.setup_s = time.perf_counter() - t0
    log(f"set-up {rec.setup_s:.3f} s; window of {seconds} s")

    out, failed, next_call = window(prog, traffic, warm, seconds, trace, rec, device)
    q = statistics.quantiles([e - s for s, e, _ in rec.calls], n=4) if len(rec.calls) > 1 else []
    log(f"window: {len(rec.calls)} calls, {rec.proofs} proofs in {rec.window_s:.3f} s; "
        f"call quartiles {[round(1e3 * x, 3) for x in q]} ms")
    if on_card:
        rec.peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            per_call = rec.window_s / len(rec.calls)
            calls = max(1, min(PROFILE_MAX_CALLS, round(PROFILE_SECONDS / per_call)))
            patterns = [k for names in rec.layers.values() for k in names]
            rec.stretch = devtrace.profile_stretch(
                prog, traffic.witnesses, next_call, calls, patterns, log)
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(out, failed, st, device)

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = reader(m["name"])(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": sum(len(traffic.witnesses(0)) for _ in rec.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.stretch is not None:
        dev["busy_s"], dev["window_s"] = rec.stretch.busy_s, rec.stretch.window_s
        result["breakdown"] = {"device_ops": rec.stretch.top_ops(), "idle_gaps": rec.stretch.gaps}
    result["checks"] = checks
    return result


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(REPO / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        log(f"no workload {args.workload!r} (have {names})")
        return 2
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # one process, few threads
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {chips} CUDA device(s), found {n}: no result")
        return 2
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = jax_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}; no result")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
