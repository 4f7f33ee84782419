"""`zkstark_tpu_torch.tools.bench`, the twin of the repository's ``bench.py``,
on the CPU at small sizes.

* Every metric name of ``bench.py`` (each keyword of each ``rec.update``,
  its f-string names expanded with the defaults of a run) is in the twin's
  last record under the same name, or under the name `RENAMED` gives it.
* The timed work is ``bench.py``'s: the twin's NTT chain and Merkle chain
  equal, word for word, the JAX ``jax.lax.scan`` programs of ``bench.py``
  rebuilt here from ``zkstark_tpu`` on the same seeded inputs.
* A whole run streams a warming line, then a provisional headline, and ends
  with the headline and every metric, on proofs of 7,836 bytes; a budget of
  0 lists every kernel and batch section under ``skipped``; the default
  device needs a card; a short proof makes the twin raise.
"""

import ast
import contextlib
import io
import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkstark_tpu import ntt as jntt
from zkstark_tpu.field import fp as jfp
from zkstark_tpu.hash import merkle as jmerkle
import zkstark_tpu_torch.protocol as tprotocol
import zkstark_tpu_torch.protocol.batch as tbatch
from zkstark_tpu_torch import ntt as tntt
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.tools import bench

ROOT = Path(__file__).resolve().parents[1]
# bench.py name → the twin's: the card has no VPU, so the ratio is over its
# integer ops bound
RENAMED = {"ntt_vpu_ratio_2e24": "ntt_ops_ratio_2e24"}
# bench.py's own record drops it once the warm-up prove is done
DROPPED = {"status"}
CPU = torch.device("cpu")
SMALL = dict(pipelined_proofs=1, merkle_bits=4, ntt_bits=10, big_ntt_bits=14, sweep_bits=(4, 5, 6),
             batch_proofs=1, pipelined_batch=1, pipelined_batches=1)
# the solo proofs of a run with repeats=1 and pipelined_proofs=1: warm-up,
# timed, spanned, 2 + 1 pipelined; the batches' at the SMALL sizes: 1 + 2 and 1 + 1
SMALL_PROOFS = 11


def _bench_py_names() -> set:
    """Each keyword of each ``rec.update(...)`` of ``bench.py``, and each
    f-string key of an update's ``**{...}`` expanded with the values a run
    gives its fields: argparse defaults (``args.batch``) and the tuples the
    loops run over (``log_n``)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    values = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                and isinstance(node.args[0], ast.Constant)):
            for kw in node.keywords:
                if kw.arg == "default" and isinstance(kw.value, ast.Constant):
                    values[f"args.{node.args[0].value.lstrip('-')}"] = [kw.value.value]
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and isinstance(node.iter, (ast.Tuple, ast.List))):
            values[node.target.id] = list(ast.literal_eval(node.iter))

    def expand(key) -> list:
        if isinstance(key, ast.Constant):
            return [key.value]
        parts = [[p.value] if isinstance(p, ast.Constant) else values[ast.unparse(p.value)]
                 for p in key.values]
        return ["".join(map(str, combo)) for combo in itertools.product(*parts)]

    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and getattr(node.func.value, "id", None) == "rec"):
            for kw in node.keywords:
                if kw.arg is not None:
                    names.add(kw.arg)
                else:
                    for key in kw.value.keys:
                        names.update(expand(key))
    return names


def _lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()]


@pytest.fixture(scope="module")
def small_run():
    """One run of every section (`--all` too) at the SMALL sizes on the CPU:
    its stdout and stderr records, its result and every proof it made."""
    proofs = []

    def tap(fn, many: bool):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            proofs.extend(out if many else [out])
            return out
        return wrapped

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprotocol, "prove", tap(tprotocol.prove, False))
        mp.setattr(tprotocol, "prove_pipelined", tap(tprotocol.prove_pipelined, True))
        mp.setattr(tbatch, "prove_batch", tap(tbatch.prove_batch, True))
        mp.setattr(tbatch, "prove_batch_pipelined", tap(tbatch.prove_batch_pipelined, True))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = bench.run(repeats=1, all_sizes=True, device="cpu", **SMALL)
    return SimpleNamespace(records=_lines(out.getvalue()), diag=_lines(err.getvalue()),
                           result=result, proofs=proofs)


def test_bench_py_names_are_read():
    names = _bench_py_names()
    assert set(RENAMED) <= names, "a RENAMED entry no longer names a bench.py metric"
    assert {"proofs_per_sec_b32", "ntt_points_per_sec_2e16", "ntt_points_per_sec_2e20",
            "ntt_points_per_sec_2e22", "stark101_prove_pipelined_latency", "phases"} <= names


def test_every_bench_py_metric_has_a_twin(small_run):
    want = {RENAMED.get(n, n) for n in _bench_py_names() - DROPPED}
    last = small_run.records[-1]
    assert not want - set(last), f"bench.py metrics without a twin: {sorted(want - set(last))}"
    assert not set(RENAMED) & set(last)
    assert not DROPPED & set(last)


def test_small_run_streams_and_ends_with_the_headline(small_run):
    records, last = small_run.records, small_run.records[-1]
    assert records[0]["status"] == "warming" and records[0]["provisional"] is True
    assert records[0]["value"] is None
    first = next(r for r in records if r["value"] is not None)
    assert first["provisional"] is True
    assert last == json.loads(json.dumps(small_run.result))
    assert last["metric"] == "stark101_prove_latency" and last["unit"] == "seconds"
    assert "provisional" not in last and "skipped" not in last
    assert last["device"] == "cpu" and last["power_limit"] is None
    assert last["ntt_sol_ratio_2e24"] is None and last["ntt_ops_ratio_2e24"] is None
    assert last["reduced"] == {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()}
    assert last["vs_baseline"] == pytest.approx(bench.BASELINE_REPLAY_SECONDS / last["value"])
    assert set(last["phases"]) == {"trace", "device_program", "fetch", "replay_decommit"}
    assert all(v > 0 for v in last["phases"].values())
    skip = {"metric", "unit", "device", "power_limit", "phases", "reduced",
            "ntt_sol_ratio_2e24", "ntt_ops_ratio_2e24"}
    assert all(v > 0 for k, v in last.items() if k not in skip), last
    times = next(d for d in small_run.diag if d.get("phase") == "prove_seconds_all")["value"]
    assert min(times) == last["value"] and len(times) == 1
    assert next(d for d in small_run.diag if d.get("phase") == "devices")["value"] == "cpu"


def test_small_run_proofs_are_golden_length(small_run):
    proofs = small_run.proofs
    assert len(proofs) == SMALL_PROOFS
    assert {len(p.data) for p in proofs} == {bench.GOLDEN_LEN}
    assert all(p.data == proofs[0].data for p in proofs)


@pytest.mark.parametrize("log_n", [12, 14], ids=["rows", "fourstep"])
def test_ntt_chain_equals_bench_py_scan(log_n):
    n, reps = 1 << log_n, 3
    plan = jntt.forward_plan(n)

    @jax.jit
    def fn(v):
        def step(c, _):
            return jntt.ntt(c, plan), None

        c, _ = jax.lax.scan(step, v, None, length=reps)
        return c

    rng = np.random.default_rng(0)
    x = jnp.asarray(jfp.host_to_mont(rng.integers(0, jfp.P, n, dtype=np.uint64).astype(np.uint32)))
    tx = bench.ntt_input(n, CPU)
    np.testing.assert_array_equal(tfp.to_host(tx), np.asarray(x))
    got = bench.ntt_chain(tx, tntt.forward_plan(n), reps)
    np.testing.assert_array_equal(tfp.to_host(got), np.asarray(fn(x)))


def test_merkle_chain_equals_bench_py_scan():
    n, reps = 1 << 10, 3

    @jax.jit
    def fn(v):
        def step(c, _):
            root = jmerkle.build_levels(c)[-1][0]
            return c + root[0], root

        _, roots = jax.lax.scan(step, v, None, length=reps)
        return roots

    rng = np.random.default_rng(0)
    x = np.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    want = np.asarray(fn(jnp.asarray(x)))
    tx = bench.merkle_input(n, CPU)
    np.testing.assert_array_equal(tfp.to_host(tx), x)
    np.testing.assert_array_equal(tfp.to_host(bench.merkle_chain(tx, reps)), want)
    # each feed wraps mod 2^32 for a share root[0] / 2^32 of the words: some
    # words wrap and some do not
    wraps = [float(np.mean(x.astype(np.uint64) + int(r) >= 1 << 32)) for r in want[:-1, 0]]
    assert all(0 < w < 1 for w in wraps), wraps


def test_budget_zero_skips_every_kernel_and_batch_section(capsys):
    last = bench.run(repeats=1, all_sizes=True, budget=0.0, device="cpu", pipelined_proofs=1)
    records = _lines(capsys.readouterr().out)
    assert records[-1] == last
    assert last["skipped"] == ["merkle_2e20", "ntt_2e24", "proofs_per_sec_b32",
                               "proofs_per_sec_b64", "ntt_2e27", "ntt_2e16", "ntt_2e20",
                               "ntt_2e22"]
    assert last["metric"] == "stark101_prove_latency" and last["value"] > 0
    assert "provisional" not in last
    assert {"warmup_prove_seconds", "verify_seconds", "phases",
            "stark101_prove_pipelined_latency", "total_bench_seconds"} <= set(last)
    assert not [k for k in last if k.startswith(("merkle_", "ntt_", "proofs_per_sec"))]


def test_default_device_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--quick"])
    assert capsys.readouterr().out == ""


SHORT = SimpleNamespace(data=b"\0" * (bench.GOLDEN_LEN - 1))


@pytest.mark.parametrize("entry", ["prove", "prove_batch", "prove_batch_pipelined"])
def test_a_short_proof_raises(monkeypatch, capsys, entry):
    if entry == "prove":
        monkeypatch.setattr(tprotocol, "prove", lambda *a, **k: SHORT)
        call = lambda: bench.run(quick=True, device="cpu")  # noqa: E731
    elif entry == "prove_batch":
        monkeypatch.setattr(tbatch, "prove_batch", lambda cfg, secrets, **k: [SHORT] * len(secrets))
        call = lambda: bench.bench_proofs_per_sec(2, CPU, 1)  # noqa: E731
    else:
        monkeypatch.setattr(tbatch, "prove_batch_pipelined",
                            lambda cfg, batches, **k: [SHORT] * sum(map(len, batches)))
        call = lambda: bench.bench_proofs_per_sec_pipelined(2, CPU, 1)  # noqa: E731
    with pytest.raises(AssertionError, match=f"want {bench.GOLDEN_LEN} bytes"):
        call()
