"""A whole run of the harness on the CPU at a small statement, the chip's
look skipped, with the timed path sound, broken underneath, or replaced by
the control: `correct` has to come out true only for the sound program."""

import json
import time

import pytest

from proofbench import run as bench_run
from proofbench.control import Control
from proofbench.program import Port

SMALL = dict(air="square-chain", trace_len=63, blowup=8, coset_offset=5, n_queries=1,
             field_p=3221225473, field_generator=5, boundary_first=1)
SEED = 2**31 + 4242


class Stale(Port):
    """A step that returns its state unchanged: each call hands back the
    previous call's proofs."""

    last = None

    def call(self, secrets, timings=None):
        got = super().call(secrets, timings)
        out, self.last = (self.last or got), got
        return out


class HalfBatch(Port):
    """Half of the batch left out."""

    def call(self, secrets, timings=None):
        got = super().call(secrets, timings)
        return got[: max(1, len(got) // 2)] if len(got) > 1 else []


class Altered(Port):
    """An answer altered where it is produced: one byte of one proof."""

    def call(self, secrets, timings=None):
        got = super().call(secrets, timings)
        state, data = got[0]
        got[0] = (state, data[:100] + bytes([data[100] ^ 1]) + data[101:])
        return got


def one_run(cell, program=None, trace=False):
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    res = bench_run.run(bench, cell, SEED, 0.2, trace, device="cpu", program=program,
                        config=SMALL, t0=time.perf_counter())
    json.dumps(res)
    return res


@pytest.mark.parametrize("cell", ["stark101.solo", "stark101.batch32"])
def test_sound_program_is_correct(cell):
    res = one_run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["stark101.solo", "stark101.batch32"])
@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered, Control],
                         ids=["stale", "half_batch", "altered", "control"])
def test_fault_is_not_correct(cell, fault):
    res = one_run(cell, program=fault)
    assert not res["correct"], res["checks"]


def test_traced_run_reads_spans():
    res = one_run("stark101.solo", trace=True)
    assert res["correct"]
    assert {"prove_ms_mean.solo", "trace_ms.solo", "device_program_ms.solo",
            "replay_decommit_ms.solo"} <= set(res["metrics"])


@pytest.mark.parametrize("entry,batch", [("prove", 1), ("prove_batch", 3)])
def test_each_entry_returns_the_reference_proofs(entry, batch):
    from proofbench.reference import prover
    from proofbench.yardstick import statement

    st = statement.make("small", SMALL, SEED)
    secrets = [st.witness(k) for k in range(batch)]
    got = Port(st, {"entry": entry, "batch": batch}, "cpu").call(secrets)
    assert got == [prover.prove(st, s) for s in secrets]
