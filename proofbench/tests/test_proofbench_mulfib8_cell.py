"""Winterfell's `mulfib8` in the benchmark (``configs/winterfell_mulfib8.json``,
the cell ``winterfell_mulfib8.solo``): the statement file states the port's
sizes, its AIR file agrees with the port's AIR column by column, a small CPU
window of it is correct, the control reads every proof wrong, and the
cell's new readers give None with nothing to read and the hand-computed
number on synthetic spans, counters and device spans."""

import time

import numpy as np
import pytest
import torch

from proofbench import devtrace
from proofbench import run as bench_run
from proofbench.control import Control
from proofbench.reference.prover import Field
from proofbench.yardstick import roofline, statement

P = 3221225473
SEED = 2**31 + 4243
CELL = "winterfell_mulfib8.solo"
NEW = ["trace_ms.mulfib8", "device_program_ms.mulfib8", "replay_decommit_ms.mulfib8",
       "decommit_us_per_opening.mulfib8", "merkle_roofline.mulfib8", "lde_roofline.mulfib8",
       "device_idle_share.mulfib8", "witness_ns_per_cell.mulfib8", "row_leaf_roofline.mulfib8"]


def small(trace_len=63, n_queries=32) -> dict:
    """The cell's statement file with fewer rows."""
    return dict(statement.load_config("winterfell_mulfib8"), trace_len=trace_len,
                n_queries=n_queries)


def one_run(config, program=None):
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    return bench_run.run(bench, CELL, SEED, 0.2, False, device="cpu", program=program,
                         config=config, t0=time.perf_counter())


def port_config(st, w):
    from zkstark_tpu_torch.protocol import StarkConfig
    from zkstark_tpu_torch.protocol.air import AIRS

    return StarkConfig(trace_len=st.trace_len, blowup=st.blowup, coset_offset=st.coset_offset,
                       n_queries=st.n_queries, air=AIRS[st.air], **w.publics)


def test_statement_file_states_the_port_sizes():
    from zkstark_tpu_torch.protocol.proof import expected_proof_len

    cfg = statement.load_config("winterfell_mulfib8")
    st = statement.make("winterfell_mulfib8", cfg, SEED)
    port = port_config(st, st.witness(0))
    assert cfg["sizes"] == {"trace_domain": port.trace_domain, "eval_domain": port.eval_domain,
                            "fri_rounds": port.fri_rounds,
                            "proof_bytes": expected_proof_len(port)}
    assert st.width == port.air.width == 8 and st.fri_rounds == port.fri_rounds == 17


def test_air_file_agrees_with_the_port_air():
    """At 63 rows: the rows (the port's columns), the FRI rounds, the
    shifts and each constraint (kind, step, column or exempt steps, value,
    and the numerator at random rows) of the file equal the port's."""
    from zkstark_tpu_torch.protocol import air as port_air

    st = statement.make("small", small(), SEED)
    air = statement.load_air(st.air)
    for w in st.cycle:
        cfg = port_config(st, w)
        np.testing.assert_array_equal(air.trace(63, int(w), P).T, cfg.air.trace(63, int(w), P))
        assert air.fri_rounds(st.trace_domain) == cfg.fri_rounds == 6
        cons, shifts = air.constraints(st, w.publics)
        assert tuple(shifts) == cfg.air.shifts and len(cons) == len(cfg.constraints) == 11
        rng = np.random.default_rng(int(w))
        for (kind, data), con in zip(cons, cfg.constraints):
            if kind == "boundary":
                assert isinstance(con, port_air.Boundary)
                assert data == (con.step, con.value, con.column)
                continue
            num, exempt = data
            assert isinstance(con, port_air.Transition) and tuple(exempt) == con.exempt
            for _ in range(8):
                rows = rng.integers(0, P, (2, 8)).tolist()
                fk = {k: torch.tensor(rows[k])[:, None] for k in (0, 1)}
                want = con.numerator(port_air.host_ops(P), lambda k: rows[k], 0)
                assert int(num(Field(P), fk)[0]) == want


def test_window_is_correct():
    res = one_run(small())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res


def test_control_is_not_correct():
    res = one_run(small(), program=Control)
    assert not res["correct"], res["checks"]
    assert res["checks"]["wrong_proofs"]["value"] == res["attempted"]


def test_every_new_metric_is_in_the_benchmark():
    bench = bench_run.load_json(bench_run.REPO / "BENCHMARK.json")
    mine = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert [m["name"] for m in mine] == NEW
    assert all(m["workloads"] == [CELL] for m in mine)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    from zkstark_tpu_torch import tracing

    run = bench_run.Run(cell={}, statement=None, mix={"entry": "prove", "batch": 1})
    monkeypatch.setattr(tracing, "totals", lambda: {"spans": {}, "counters": {}})
    assert bench_run.reader(name)(run) is None


def test_witness_ns_per_cell_from_synthetic_totals(monkeypatch):
    """Three proves, the first 9 ms of witness and each warm one 2 ms for
    131,071 × 8 words: 2e6 / 1,048,568 ns a word."""
    from zkstark_tpu_torch import tracing

    span = {"count": 3, "total_ns": 9_000_000 + 2 * 2_000_000, "self_ns": 0,
            "first_total_ns": 9_000_000, "first_self_ns": 0}
    totals = {"spans": {"prove": span, "witness": span},
              "counters": {"witness.cells": 3 * 131071 * 8}}
    monkeypatch.setattr(tracing, "totals", lambda: totals)
    run = bench_run.Run(cell={}, statement=None, mix={"entry": "prove", "batch": 1})
    got = bench_run.reader("witness_ns_per_cell.mulfib8")(run)
    assert got == pytest.approx(2e6 / (131071 * 8), rel=1e-12)


def test_row_leaf_roofline_from_synthetic_device_spans():
    """Two proofs whose row-leaf kernels took 200 µs each: the bound of 2^20
    leaves of 8 words over 200 µs; other kernels are not counted."""
    st = statement.make(CELL, statement.load_config("winterfell_mulfib8"), SEED)
    spans = [("sha256_leaf_rows(unsigned int const*, ...)", 0.0, 200.0),
             ("sha256_leaf_rows(unsigned int const*, ...)", 1000.0, 1200.0),
             ("void sha256_node<false>(...)", 300.0, 900.0)]
    stretch = devtrace.Stretch(calls=2, proofs=2, window_s=1.0, busy_s=0.5, device=spans,
                               kernel_spans=3, launches=3, gaps=[])
    run = bench_run.Run(cell={}, statement=st, mix={"entry": "prove", "batch": 1},
                        stretch=stretch)
    d = 1 << 20
    bound = roofline.bound_s(d * (4 * 8 + 32), d * roofline.leaf_ops(8))
    got = bench_run.reader("row_leaf_roofline.mulfib8")(run)
    assert got == pytest.approx(100.0 * bound / 200e-6, rel=1e-12)
    assert bound == d * roofline.leaf_ops(8) / roofline.INT32_INSTR_PER_S  # bound by ops
