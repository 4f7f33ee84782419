"""The port's fused composition equals the JAX package's, exactly (tolerance
0: the field has no rounding).

  * `composition_eval_res` (through `ops.composition`, whose plain version
    runs on CPU tensors and interprets the device program the CUDA kernel
    ``csrc/composition.cu`` reads) against
    ``zkstark_tpu.protocol.prover.composition_eval`` and `from_mont`, for the
    three AIRs, blowup 4, 8 and 16, both primes, B ∈ {1, 3}, with the alphas as
    a tensor and as Python ints, on seeded inputs with 0, 1 and p − 1 among
    them; `composition_eval_plain` (the AIR's own closures, no program) gives
    the same words;
  * a numpy interpreter of ``air.numerator_program`` at random points against
    ``air.composition_at_point``: the program the kernel reads is pinned here;
  * a program that reads x (OP_X) and constants, which none of the three AIRs
    does, against `composition_eval_plain`;
  * `encode` refuses a program whose stack does not fit the kernel's;
  * a whole 2^16-point square-chain proof under ZKSTARK_MXU=on equals the
    default-route proof and the JAX proof.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest

import zkstark_tpu.protocol as jproto
from zkstark_tpu.field import fp as jfp
from zkstark_tpu.protocol import air as jair
from zkstark_tpu.protocol import prover as jpr
from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
from zkstark_tpu_torch import prove
from zkstark_tpu_torch.field import fp as tfp
from zkstark_tpu_torch.ops import composition
from zkstark_tpu_torch.protocol import air as tair
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol.config import StarkConfig

TRACE_LEN = 63  # a 64-point trace domain
AIRS = ["fibonacci-sq", "fibonacci", "square-chain"]


def _configs(name, p, blowup):
    trace = tair.AIRS[name].trace(TRACE_LEN, 31415, p)
    kw = dict(trace_len=TRACE_LEN, blowup=blowup, boundary_first=int(trace[0]),
              boundary_last=int(trace[-1]), coset_offset=5 if p == tfp.P else 31)
    return (JaxConfig(field=jfp.field_for(p), air=jair.AIRS[name], **kw),
            StarkConfig(field=tfp.field_for(p), air=tair.AIRS[name], **kw))


def _inputs(cfg, bsz, seed):
    fld = cfg.field
    rng = np.random.default_rng(seed)
    f = rng.integers(0, fld.p, (bsz, cfg.eval_domain), dtype=np.uint64)
    f[0, :3] = (0, 1, fld.p - 1)
    f[-1, -cfg.blowup * 2 :] = fld.p - 1  # the reads that wrap around the domain
    alphas = rng.integers(0, fld.p, (bsz, cfg.n_constraints), dtype=np.uint64)
    alphas[0, 0] = fld.p - 1
    return fld.host_to_mont(f), fld.host_to_mont(alphas)


def _t(a):
    return tfp.from_host(np.asarray(a, dtype=np.uint32), "cpu")


def _eq(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(tfp.to_host(got), want)


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("blowup", [4, 8, 16])
@pytest.mark.parametrize("name", AIRS)
def test_composition_matches_jax(name, blowup, p, bsz):
    jcfg, cfg = _configs(name, p, blowup)
    f, alphas = _inputs(cfg, bsz, seed=blowup + bsz)
    want = jpr.composition_eval(jcfg, jnp.asarray(f), jnp.asarray(alphas))
    want_res = jfp.from_mont_f(jcfg.field, want)
    before = composition.composition_launches
    cp, res = tpr.composition_eval_res(cfg, _t(f), _t(alphas))
    assert composition.composition_launches == before  # CPU tensors launch nothing
    _eq(cp, want)
    _eq(res, want_res)
    _eq(tpr.composition_eval(cfg, _t(f), _t(alphas)), want)
    _eq(tpr.composition_eval_plain(cfg, _t(f), _t(alphas)), want)
    # one proof without the batch axis, the alphas as Python ints (the
    # host-synced prover's call)
    cp0, res0 = tpr.composition_eval_res(cfg, _t(f[0]), [int(a) for a in alphas[0]])
    _eq(cp0, np.asarray(want)[0])
    _eq(res0, np.asarray(want_res)[0])


def _run_program(prog, f_vals, x, p):
    """``air.numerator_program``'s postfix code on exact Python ints."""
    stack = []
    for op, arg in prog:
        if op == tair.OP_F:
            stack.append(f_vals[arg])
        elif op == tair.OP_X:
            stack.append(x)
        elif op == tair.OP_CONST:
            stack.append(arg)
        else:
            b, a = stack.pop(), stack.pop()
            stack.append({tair.OP_ADD: a + b, tair.OP_SUB: a - b, tair.OP_MUL: a * b}[op] % p)
    assert len(stack) == 1
    return stack[0]


@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
@pytest.mark.parametrize("name", AIRS)
def test_numerator_program_matches_point_check(name, p):
    """Σ α_c·num_c/den_c with the numerators run from the postfix program
    equals the verifier's `composition_at_point`."""
    _, cfg = _configs(name, p, 8)
    rng = np.random.default_rng(len(name))
    g, n, shifts = cfg.trace_generator, cfg.trace_domain, cfg.air.shifts
    for _ in range(5):
        x = cfg.coset_offset * pow(cfg.domain_generator, int(rng.integers(cfg.eval_domain)), p) % p
        f_by_shift = {k: int(rng.integers(p)) for k in shifts}
        alphas = [int(rng.integers(p)) for _ in cfg.constraints]
        acc = 0
        for alpha, con in zip(alphas, cfg.constraints):
            if isinstance(con, tair.Boundary):
                num = (f_by_shift[0] - con.value) % p
                den = (x - pow(g, con.step, p)) % p
            else:
                prog = tair.numerator_program(con.numerator, shifts, p)
                num = _run_program(prog, [f_by_shift[k] for k in shifts], x, p)
                den = (pow(x, n, p) - 1) % p
                for e in con.exempt:
                    den = den * pow((x - pow(g, e, p)) % p, p - 2, p) % p
            acc = (acc + alpha * num % p * pow(den, p - 2, p)) % p
        assert acc == tair.composition_at_point(cfg, x, f_by_shift, alphas)


def test_device_program_of_stark101():
    """The words the kernel reads for the reference statement: three
    constraints, f(g^k·x) as offsets of k·blowup points, values in
    Montgomery form."""
    cfg = StarkConfig()
    prog = tpr.composition_program(cfg)
    fld = cfg.field
    f, sub, mul = composition.OP_F, composition.OP_SUB, composition.OP_MUL
    assert prog.words == (
        3,
        0, fld.mont_scalar(cfg.boundary_first),
        0, fld.mont_scalar(cfg.boundary_last),
        1, 9, f, 16, f, 8, f, 8, mul, 0, sub, 0, f, 0, f, 0, mul, 0, sub, 0,
    )
    assert prog.shifts_by_4 and prog.field_ops == (8, 3, 4)
    assert (prog.domain, prog.generator, prog.offset) == (8192, cfg.domain_generator, 5)


def _x_numerator(ops, f, x):
    """f(gx) − x·f(x)·(x + 7) + 3: reads x twice and two constants."""
    t = ops.mul(ops.mul(x, f(0)), ops.add(x, ops.const(7)))
    return ops.add(ops.sub(f(1), t), ops.const(3))


@dataclass(frozen=True)
class _XAir(tair.Air):
    shifts = (0, 1)
    name = "reads-x"

    def constraints(self, cfg):
        return (tair.Transition(_x_numerator, (cfg.trace_domain - 1,)),
                tair.Boundary(0, cfg.boundary_first))


@pytest.mark.parametrize("p", [tfp.P, tfp.P_ALT], ids=["p101", "alt"])
def test_program_that_reads_x(p):
    cfg = StarkConfig(field=tfp.field_for(p), air=_XAir(), trace_len=TRACE_LEN, blowup=2,
                      boundary_first=1, boundary_last=1, coset_offset=5 if p == tfp.P else 31)
    prog = tpr.composition_program(cfg)
    assert not prog.shifts_by_4  # blowup 2: the kernel takes one point a thread
    f, alphas = _inputs(cfg, 2, seed=9)
    cp, res = tpr.composition_eval_res(cfg, _t(f), _t(alphas))
    want = tpr.composition_eval_plain(cfg, _t(f), _t(alphas))
    _eq(cp, tfp.to_host(want))
    _eq(res, tfp.to_host(tfp.from_mont_f(cfg.field, want)))
    # and one point against exact integers
    j, fld = 37, cfg.field
    r_inv = pow(1 << 32, p - 2, p)
    std = lambda a: int(a) * r_inv % p
    x = cfg.coset_offset * pow(cfg.domain_generator, j, p) % p
    f_vals = {0: std(f[1, j]), 1: std(f[1, (j + cfg.blowup) % cfg.eval_domain])}
    want_pt = tair.composition_at_point(cfg, x, f_vals, [std(a) for a in alphas[1]])
    assert int(tfp.to_host(res)[1, j]) == want_pt


def test_encode_refuses_a_deep_stack():
    deep = [(composition.OP_F, 0)] * (composition.MAX_DEPTH + 1) + \
           [(composition.OP_ADD, 0)] * composition.MAX_DEPTH
    args = ((0,), 8, 512, 3, 5)
    with pytest.raises(ValueError, match="stack"):
        composition.encode([("transition", deep)], *args)
    with pytest.raises(ValueError, match="one value"):
        composition.encode([("transition", [(composition.OP_F, 0)] * 2)], *args)
    with pytest.raises(ValueError, match="opcode"):
        composition.encode([("transition", [(9, 0)])], *args)
    ok = composition.encode([("transition", deep[1:-1])], *args)
    assert ok.n_constraints == 1


def test_composition_wrapper_checks_input():
    cfg = StarkConfig(trace_len=TRACE_LEN)
    f, alphas = _inputs(cfg, 1, seed=1)
    inv, prog = tpr.composition_constants(cfg, "cpu"), tpr.composition_program(cfg)
    with pytest.raises(TypeError):
        composition.composition(tfp.as_i32(_t(f)), inv, _t(alphas), prog)
    with pytest.raises(ValueError):
        composition.composition(_t(f), inv[:2], _t(alphas), prog)
    with pytest.raises(ValueError):
        composition.composition(_t(f), inv, [1, 2], prog)
    with pytest.raises(ValueError):
        composition.composition(_t(f), inv, _t(alphas[:, :2]), prog)


def test_big_domain_constants_in_chunks(monkeypatch):
    """Above `_HOST_CONST_MAX` the inverse denominators are computed in
    plain torch (the constants kernel's twin) a chunk of the domain at a
    time: the same words as the exact host version, and the same domain."""
    from zkstark_tpu_torch.ops import constants

    _, cfg = _configs("square-chain", tfp.P, 8)
    host = np.stack(tpr._composition_constants_host(cfg)["inv_dens"])
    monkeypatch.setattr(constants, "_PLAIN_CHUNK", 64)
    _eq(constants.inverse_denominators(tpr.constants_system(cfg), cfg.field, "cpu"), host)
    monkeypatch.setattr(tpr, "_HOST_CONST_MAX", 8)
    _eq(tpr.coset_domain(cfg, "cpu"), tpr._composition_constants_host(cfg)["xs"])


def test_limb_route_in_a_whole_proof(monkeypatch):
    """A 2^16-point square-chain proof with every four-step NTT on the
    limb-matrix route (ZKSTARK_MXU=on): the bytes of the default route and of
    the JAX proof under the same switch."""
    trace_len, secret = (1 << 13) - 1, 31415
    trace = tair.SQUARE_CHAIN.trace(trace_len, secret)
    kw = dict(trace_len=trace_len, boundary_last=int(trace[-1]))
    cfg = StarkConfig(air=tair.SQUARE_CHAIN, **kw)
    monkeypatch.delenv("ZKSTARK_MXU", raising=False)
    default = prove(cfg, secret, device="cpu")
    monkeypatch.setenv("ZKSTARK_MXU", "on")
    got = prove(cfg, secret, device="cpu")
    assert got == default
    want = jproto.prove(JaxConfig(air=jair.SQUARE_CHAIN, **kw), secret)
    assert (got.state, got.data) == (want.state, want.data)
