"""The control of the comparison that decides `correct`: the plain reference
put in the program's place with one guarantee of the statement broken, the
degree bound of the trace polynomial (the top coefficient of the degree
n − 1 polynomial through the rows is left in, where the statement fixes
degree at most n − 2). Every run of it has to read not correct.

    python3 -m proofbench.control --workload <name> --seeds <n> ... --seconds <s>

runs a short window of each seed at the cell's own statement and load on
the card and prints one JSON line a seed with the numbers compared. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from proofbench import run as bench_run
from proofbench.reference import prover as reference


class Control:
    """A stand-in for the port (``program.Port``'s interface)."""

    def __init__(self, st, mix: dict, device):
        self.st, self.device = st, device

    def call(self, witnesses: list, timings: list | None = None) -> list:
        return [reference.prove(self.st, w, device=self.device, degree_fix=False)
                for w in witnesses]

    def launch_counts(self) -> dict:
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control, on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("proofbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    for seed in args.seeds:
        t = time.perf_counter()
        res = bench_run.run(bench, args.workload, seed, args.seconds, False,
                            program=Control, t0=t)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "checks": res["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
