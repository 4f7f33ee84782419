"""The Winterfell work statement in the benchmark (``airs/winterfell_work.py``,
``configs/winterfell_work.json``, the cell ``winterfell_work.solo``): its
AIR file agrees with the port's AIR, a small CPU window of it is correct,
the control reads every proof wrong, and no harness file names it."""

import re
import time

import numpy as np
import pytest
import torch

from proofbench import run as bench_run
from proofbench.control import Control
from proofbench.program import Port
from proofbench.reference.prover import Field
from proofbench.yardstick import statement

P = 3221225473
SEED = 2**31 + 4243
CELL = "winterfell_work.solo"


def small(trace_len=63, n_queries=32) -> dict:
    """The cell's statement file with fewer rows."""
    return dict(statement.load_config("winterfell_work"), trace_len=trace_len,
                n_queries=n_queries)


def one_run(config, program=None, trace=False):
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    return bench_run.run(bench, CELL, SEED, 0.2, trace, device="cpu", program=program,
                         config=config, t0=time.perf_counter())


def port_config(st, w):
    from zkstark_tpu_torch.protocol import StarkConfig
    from zkstark_tpu_torch.protocol.air import AIRS

    return StarkConfig(trace_len=st.trace_len, blowup=st.blowup, coset_offset=st.coset_offset,
                       n_queries=st.n_queries, air=AIRS[st.air], **w.publics)


def test_statement_file_states_the_port_sizes():
    from zkstark_tpu_torch.protocol.proof import expected_proof_len

    cfg = statement.load_config("winterfell_work")
    st = statement.make("winterfell_work", cfg, SEED)
    port = port_config(st, st.witness(0))
    assert cfg["sizes"] == {"trace_domain": port.trace_domain, "eval_domain": port.eval_domain,
                            "fri_rounds": port.fri_rounds,
                            "proof_bytes": expected_proof_len(port)}
    assert st.fri_rounds == port.fri_rounds == 21


def test_air_file_agrees_with_the_port_air():
    """At 63 rows: the witnesses' rows, the FRI rounds, the shifts and each
    constraint (kind, step or exempt steps, value, and the numerator at
    random points) of the file equal the port's."""
    from zkstark_tpu_torch.protocol import air as port_air

    st = statement.make("small", small(), SEED)
    air = statement.load_air(st.air)
    assert len(st.cycle) == 2 and len({w.key for w in st.cycle}) == 2
    for w in st.cycle:
        cfg = port_config(st, w)
        assert int(w) == w.publics["boundary_first"]
        np.testing.assert_array_equal(air.trace(63, int(w), P), cfg.air.trace(63, int(w), P))
        assert air.fri_rounds(st.trace_domain) == cfg.fri_rounds == 7
        cons, shifts = air.constraints(st, w.publics)
        assert tuple(shifts) == cfg.air.shifts
        assert len(cons) == len(cfg.constraints)
        rng = np.random.default_rng(int(w))
        for (kind, data), con in zip(cons, cfg.constraints):
            if kind == "boundary":
                assert isinstance(con, port_air.Boundary) and data == (con.step, con.value)
                continue
            num, exempt = data
            assert isinstance(con, port_air.Transition) and tuple(exempt) == con.exempt
            for f0, f1 in rng.integers(0, P, (16, 2)).tolist():
                fk = {0: torch.tensor(f0), 1: torch.tensor(f1)}
                want = con.numerator(port_air.host_ops(P), lambda k: (f0, f1)[k], 0)
                assert int(num(Field(P), fk)) == want


def test_window_is_correct():
    res = one_run(small())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res


def test_port_builds_one_config_a_start():
    st = statement.make("small", small(), SEED)
    port = Port(st, {"entry": "prove", "batch": 1}, "cpu")
    assert len(port.cfgs) == 2
    assert {c.boundary_first for c in port.cfgs.values()} == {int(w) for w in st.cycle}


def test_control_is_not_correct():
    res = one_run(small(), program=Control)
    assert not res["correct"], res["checks"]
    assert res["checks"]["wrong_proofs"]["value"] == res["attempted"]


@pytest.mark.parametrize("name", ["decommit_us_per_opening.work", "trace_ms.work",
                                  "device_program_ms.work", "replay_decommit_ms.work",
                                  "merkle_roofline.work", "lde_roofline.work",
                                  "device_idle_share.work"])
def test_new_metrics_read_nothing_or_a_number(name, monkeypatch):
    """Without spans, counters or a stretch each reader gives None; the
    decommit reader divides the warm decommit time by the openings."""
    from zkstark_tpu_torch import tracing

    run = bench_run.Run(cell={}, statement=None, mix={"entry": "prove", "batch": 1})
    monkeypatch.setattr(tracing, "totals", lambda: {"spans": {}, "counters": {}})
    assert bench_run.reader(name)(run) is None
    if name == "decommit_us_per_opening.work":
        span = {"count": 3, "total_ns": 9_000_000 + 2 * 768_000, "self_ns": 0,
                "first_total_ns": 9_000_000, "first_self_ns": 0}
        totals = {"spans": {"prove": span, "decommit": span},
                  "counters": {"decommit.openings": 3 * 768}}
        monkeypatch.setattr(tracing, "totals", lambda: totals)
        assert bench_run.reader(name)(run) == pytest.approx(1.0, rel=1e-12)


def test_harness_names_no_work_air():
    root = bench_run.HERE
    named = [str(f.relative_to(root)) for f in sorted(root.rglob("*.py"))
             if f.relative_to(root).parts[0] not in ("airs", "tests")
             and re.search(r"winterfell|WorkAir|x\^3", f.read_text(), re.IGNORECASE)]
    assert named == [], named
