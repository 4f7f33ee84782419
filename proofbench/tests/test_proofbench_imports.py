"""No module that the harness or the reference loads is JAX, Flax or the
JAX package, by whole top-level name (the port's name begins with the JAX
package's); the reference loads nothing of the port either."""

import subprocess
import sys

from proofbench import run as bench_run

REPO = str(bench_run.REPO)

HARNESS = """
import json, sys, time
from proofbench import run as R
small = dict(air="square-chain", trace_len=63, blowup=8, coset_offset=5, n_queries=1,
             field_p=3221225473, field_generator=5, boundary_first=1)
bench = R.load_json(R.REPO / "BENCHMARK.json")
for cell in ("stark101.solo", "stark101.batch32"):
    for trace in (False, True):
        assert R.run(bench, cell, 7, 0.1, trace, device="cpu", config=small,
                     t0=time.perf_counter())["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from proofbench.reference import prover
from proofbench.yardstick import roofline, statement
st = statement.make("stark101", statement.load_config("stark101"), 11)
prover.prove(st, st.witness(1))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = top_level_names(HARNESS)
    assert "zkstark_tpu_torch" in names  # the program was driven
    assert not names & bench_run.FORBIDDEN


def test_reference_loads_neither_jax_nor_the_port():
    names = top_level_names(REFERENCE)
    assert not names & (bench_run.FORBIDDEN | {"zkstark_tpu_torch"})


def test_names_are_compared_whole(monkeypatch):
    before = set(bench_run.jax_modules())
    monkeypatch.setitem(sys.modules, "zkstark_tpu_torch_fake.sub", sys)
    assert set(bench_run.jax_modules()) == before
    monkeypatch.setitem(sys.modules, "zkstark_tpu.sub", sys)
    assert "zkstark_tpu" in bench_run.jax_modules()
