"""`zkstark_tpu_torch.tools.scaling_bench`, the twin of
``tools/scaling_bench.py``, on the CPU: at --bits 12 over local meshes of 1, 2
and 4 shards it prints one JSON line a mesh with the JAX tool's keys (its
``compile_seconds`` named ``first_call_seconds``), and every mesh gives the
same roots, free term and final layer (the tool raises otherwise), equal to
the single-device `proof_core`'s. Without a card the default device raises.
`--fri-rounds` is accepted and ignored, as by the JAX tool.
"""

import json

import numpy as np
import pytest
import torch

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.parallel.pipeline import proof_core
from zkstark_tpu_torch.tools import scaling_bench

JAX_KEYS = {"devices", "bits", "seconds", "compile_seconds", "points_per_sec",
            "scaling_efficiency"}


def test_scaling_bench_on_cpu(capsys, monkeypatch):
    outs = []
    real = proof_core

    def recording(cfg, mesh=None):  # keep each mesh's result
        fn = real(cfg, mesh)
        return lambda *args: outs.append(fn(*args)) or outs[-1]

    monkeypatch.setattr("zkstark_tpu_torch.parallel.pipeline.proof_core", recording)
    assert scaling_bench.main(["--bits", "12", "--devices", "1", "2", "4", "--repeats", "1",
                               "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in lines] == [1, 2, 4]
    for r in lines:
        assert set(r) == JAX_KEYS - {"compile_seconds"} | {"first_call_seconds", "mesh", "device"}
        assert r["bits"] == 12 and r["mesh"] == "local" and r["device"] == "cpu"
        assert r["seconds"] > 0 and r["first_call_seconds"] > 0
        assert r["points_per_sec"] == pytest.approx(4096 / r["seconds"])
    assert lines[0]["scaling_efficiency"] == 1.0
    cfg, trace, alphas, betas = scaling_bench._inputs(12, 8, "cpu")
    solo = proof_core(cfg, None)(trace, alphas, betas)
    assert len(outs) == 6  # the first call and one repeat a mesh
    for out in outs:
        for k in solo:
            np.testing.assert_array_equal(fp.to_host(out[k]), fp.to_host(solo[k]))


def test_scaling_bench_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling_bench.main(["--bits", "12", "--devices", "1"])


def test_fri_rounds_is_accepted_and_ignored(capsys, monkeypatch):
    """The JAX tool takes --fri-rounds and never reads it; so does the twin:
    the full FRI schedule runs."""
    outs = []
    real = proof_core

    def recording(cfg, mesh=None):
        fn = real(cfg, mesh)
        return lambda *args: outs.append(fn(*args)) or outs[-1]

    monkeypatch.setattr("zkstark_tpu_torch.parallel.pipeline.proof_core", recording)
    assert scaling_bench.main(["--bits", "10", "--devices", "1", "--repeats", "1",
                               "--fri-rounds", "2", "--device", "cpu"]) == 0
    assert [json.loads(ln)["devices"] for ln in capsys.readouterr().out.splitlines()] == [1]
    cfg = scaling_bench._inputs(10, 8, "cpu")[0]
    assert cfg.fri_rounds > 2
    assert all(o["roots"].shape == (2 + cfg.fri_rounds, 8) for o in outs) and len(outs) == 2
