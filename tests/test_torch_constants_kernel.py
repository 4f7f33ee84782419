"""The composition's inverse denominators of the port (`ops.constants`, whose
plain twin reads the same encoded system that the CUDA kernel
``csrc/constants.cu`` takes as kernel parameters) equal
``zkstark_tpu.protocol.prover.composition_constants`` word for word
(tolerance 0: no floats):

  * for the three AIRs, blowup 4, 8 and 16, both primes, through
    `prover.constants_system` (the config's encoding) at a 64-point trace
    domain and, for one AIR, a 1024-point one;
  * the encoding's table of 1/(x^n − 1) has `blowup` words, and the
    CPU route of `prover.composition_constants` (host numpy) agrees;
  * `encode` refuses a system whose words do not fit the kernel's parameters.
"""

import numpy as np
import pytest

from zkstark_tpu.field import fp as jfp
from zkstark_tpu.protocol import air as jair
from zkstark_tpu.protocol import prover as jpr
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import constants
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol.config import StarkConfig

AIRS = ["fibonacci-sq", "fibonacci", "square-chain"]


def _configs(name, p, blowup, trace_len=63):
    trace = tair.AIRS[name].trace(trace_len, 31415, p)
    kw = dict(trace_len=trace_len, blowup=blowup, boundary_first=int(trace[0]),
              boundary_last=int(trace[-1]), coset_offset=5 if p == tfp.P else 31)
    return (JaxConfig(field=jfp.field_for(p), air=jair.AIRS[name], **kw),
            StarkConfig(field=tfp.field_for(p), air=tair.AIRS[name], **kw))


@pytest.mark.parametrize("name", AIRS)
@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("blowup", [4, 8, 16])
def test_inverse_denominators_match_jax(name, p, blowup):
    jcfg, cfg = _configs(name, p, blowup)
    want = np.stack(jpr.composition_constants(jcfg)["inv_dens"])
    system = tpr.constants_system(cfg)
    assert system.n_constraints == cfg.n_constraints and system.domain == cfg.eval_domain
    assert len(system.words) - system.ztab == blowup
    got = tfp.to_host(constants.inverse_denominators(system, cfg.field, "cpu"))
    assert got.shape == want.shape == (cfg.n_constraints, cfg.eval_domain)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfp.to_host(tpr.composition_constants(cfg, "cpu")), want)


def test_inverse_denominators_at_1024_points_a_trace():
    jcfg, cfg = _configs("square-chain", tfp.P, 8, trace_len=1023)
    want = np.stack(jpr.composition_constants(jcfg)["inv_dens"])
    got = constants.inverse_denominators(tpr.constants_system(cfg), cfg.field, "cpu")
    np.testing.assert_array_equal(tfp.to_host(got), want)


def test_encode_refuses_what_the_kernel_cannot_take():
    fld = tfp.FIELD101
    with pytest.raises(ValueError):  # the table alone is larger than the parameter space
        constants.encode([("boundary", 7)], 64, 1024, fld.subgroup_generator(1 << 16), 5, fld)
    system = constants.encode([("boundary", 7), ("transition", (3, 9))], 64, 8,
                              fld.subgroup_generator(512), 5, fld)
    assert system.constraints() == [(0, fld.mont_scalar(7)),
                                    (1, (fld.mont_scalar(3), fld.mont_scalar(9)))]
