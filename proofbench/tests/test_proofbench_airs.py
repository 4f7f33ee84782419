"""A statement's AIR is a file of the benchmark (``airs/<air>.py``): the
harness takes the witnesses, the public values, the constraints and the FRI
rounds from it and names no AIR itself. The additive Fibonacci AIR states
its own public output for each witness, which drives one port config a
distinct output."""

import re
import time
from pathlib import Path

import pytest

from proofbench import run as bench_run
from proofbench.control import Control
from proofbench.program import Port
from proofbench.reference import prover
from proofbench.yardstick import statement

P = 3221225473
SEED = 2**31 + 4243
FIB = dict(air="fibonacci", trace_len=63, blowup=8, coset_offset=5, n_queries=1,
           field_p=P, field_generator=5, boundary_first=1)

# A new AIR, as a later statement would bring it: written here, not copied
# from ``airs/``, with a cycle of three witnesses, each its own output.
NEW_AIR = '''
import numpy as np

from proofbench.yardstick.statement import draw_secret


def trace(trace_len, secret, p):
    a = [1, secret % p]
    while len(a) < trace_len:
        a.append((a[-2] + a[-1]) % p)
    return np.array(a[:trace_len], dtype=np.uint32)


def witnesses(seed, cfg):
    p, n = int(cfg["field_p"]), int(cfg["trace_len"])
    s = draw_secret(seed, p)
    return [(w, {"boundary_first": 1, "boundary_last": int(trace(n, w, p)[-1])})
            for w in (s, s + 1, p - s)]


def constraints(st, publics):
    n, p = st.trace_domain, st.p

    def num(fld, f):
        return (f[2] - f[1] - f[0]) % p

    return [("boundary", (0, publics["boundary_first"])),
            ("boundary", (st.trace_len - 1, publics["boundary_last"])),
            ("transition", (num, (n - 3, n - 2, n - 1)))], (0, 1, 2)


def fri_rounds(trace_domain):
    return trace_domain.bit_length() - 1
'''


def bench():
    return bench_run.load_json(bench_run.REPO / "BENCHMARK.json")


def one_run(cell, config, program=None, seconds=0.2):
    return bench_run.run(bench(), cell, SEED, seconds, False, device="cpu", program=program,
                         config=config, t0=time.perf_counter())


def test_fibonacci_equals_port():
    """Each witness of the additive Fibonacci AIR, with its own output:
    the reference's bytes are the port's, through its own config and through
    the harness's `Port`, which builds one config an output; the port's
    verifier accepts them."""
    from zkstark_tpu_torch.field.fp import field_for
    from zkstark_tpu_torch.protocol import Proof, StarkConfig, prove, verify
    from zkstark_tpu_torch.protocol.air import AIRS

    st = statement.make("small", FIB, SEED)
    assert len(st.cycle) == 2 and st.witness(1) == P - st.secret
    assert st.witness(0).publics != st.witness(1).publics
    harness = Port(st, {"entry": "prove", "batch": 1}, "cpu")
    assert len(harness.cfgs) == 2
    for k in (0, 1):
        w = st.witness(k)
        port = StarkConfig(trace_len=63, blowup=8, coset_offset=5, n_queries=1,
                           boundary_first=w.publics["boundary_first"],
                           boundary_last=w.publics["boundary_last"],
                           air=AIRS["fibonacci"], field=field_for(P))
        state, data = prover.prove(st, w)
        got = prove(port, int(w), device="cpu")
        assert (state, data) == (got.state, got.data)
        assert harness.call([w]) == [(state, data)]
        verify(Proof(state=state, data=data), port)


def test_fibonacci_window_is_correct():
    res = one_run("stark101.solo", FIB)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res


def test_fibonacci_control_is_not_correct():
    res = one_run("stark101.solo", FIB, program=Control)
    assert not res["correct"], res["checks"]


def test_air_file_from_elsewhere(tmp_path, monkeypatch):
    """An AIR file the harness has never seen, in a directory of its own,
    runs a whole window: no file of the harness names it."""
    (tmp_path / "fibonacci.py").write_text(NEW_AIR)
    monkeypatch.setattr(statement, "AIRS", tmp_path)
    st = statement.make("new", FIB, SEED)
    assert len(st.cycle) == 3 and len({w.key for w in st.cycle}) == 3
    # the warm-up calls prove the first two witnesses, the window the third
    res = one_run("stark101.solo", FIB)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res


def test_unknown_air_names_the_path():
    want = str(statement.AIRS / "no_such_air.py")
    with pytest.raises(ValueError, match=re.escape(want)):
        statement.make("x", dict(FIB, air="no-such-air"), SEED)


def test_batch_over_two_outputs_is_refused_before_the_window():
    """A batch is one statement: a batch32 mix over witnesses of two outputs
    raises out of the run. The window counts a failed call and goes on, so
    the error comes from the warm-up calls before it."""
    with pytest.raises(ValueError, match="a batch is one statement"):
        one_run("stark101.batch32", FIB)


def test_harness_names_no_air():
    root = bench_run.HERE
    named = [str(f.relative_to(root)) for f in sorted(root.rglob("*.py"))
             if f.relative_to(root).parts[0] not in ("airs", "tests")
             and re.search(r"fibonacci-sq|square-chain|SQUARE_CHAIN_C", f.read_text())]
    assert named == []
    assert {Path(f).stem for f in statement.AIRS.glob("*.py")} >= {
        "fibonacci_sq", "square_chain", "fibonacci"}
