"""The compiled witness (``csrc/witness.cpp`` through
``protocol/witness.py``), on the CPU:

  * every AIR's trace equals its Python twin (``air._PLAIN_TRACES``), the JAX
    package's trace where it has the AIR, and, as Montgomery words,
    `host_to_mont` of the twin; over both primes, lengths 1 to 2^16 − 1 and
    secrets 0, 1, p − 1, p + 5 and seeded random ones (p − 1 and p + 5 are
    the hazards: a sum of two squares of residues overflows 64 bits, and so
    does a naive REDC sum for p > 2^31.5);
  * the same at other primes `field_for` accepts, the smallest and the
    largest below 2^32 among them;
  * a batch of 32 equals 32 solo calls, row for row;
  * a wrong public output raises the same errors as before in
    `trace_to_device` and `batch._witnesses`;
  * the counter ``witness.rows`` adds trace_len × B once a call.

An AIR of w > 1 columns (mulfib8) gives (w, trace_len) columns, and its
`last` is its output register's value at the last row.
"""

import random
import re

import numpy as np
import pytest

from zkstark_tpu.protocol import air as jair
from zkstark_tpu_torch import tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.protocol import StarkConfig, air, prove
from zkstark_tpu_torch.protocol import batch as tbatch
from zkstark_tpu_torch.protocol import prover as tpr
from zkstark_tpu_torch.protocol import witness

FIELDS = {"p101": fp.FIELD101, "alt": fp.FIELD_ALT}
LENGTHS = [1, 2, 3, 63, 1023, (1 << 16) - 1]
_RNG = random.Random(2**31 + 21)
RANDOM = [_RNG.randrange(1 << 40) for _ in range(2)]


def secrets(p: int) -> list:
    return [0, 1, p - 1, p + 5, *RANDOM]


# the column whose last row the witness reports (the public output), where not 0
OUTPUT_COLUMN = {"winterfell-mulfib8": 6}


def columns(a, n: int) -> tuple:
    """The shape of one trace of `a` with n rows."""
    return (n,) if a.width == 1 else (a.width, n)


def check_air(a, n: int, s: int, field) -> None:
    """The compiled trace of (a, n, s) against every reference it has."""
    p = field.p
    want = air._PLAIN_TRACES[a.name](n, s, p)
    got = a.trace(n, s, p)
    assert got.dtype == np.uint32 and got.shape == columns(a, n)
    np.testing.assert_array_equal(got, want)
    words, last = witness.traces(a, [s], n, field)
    np.testing.assert_array_equal(words[0], field.host_to_mont(want))
    assert int(last[0]) == int(want.reshape(-1, n)[OUTPUT_COLUMN.get(a.name, 0), -1])
    if a.name in jair.AIRS:
        np.testing.assert_array_equal(got, jair.AIRS[a.name].trace(n, s, p))


@pytest.mark.parametrize("k", range(6), ids=["0", "1", "p-1", "p+5", "rand0", "rand1"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("fname", FIELDS)
@pytest.mark.parametrize("name", air.AIRS)
def test_compiled_equals_plain(name, fname, n, k):
    field = FIELDS[fname]
    check_air(air.AIRS[name], n, secrets(field.p)[k], field)


@pytest.mark.parametrize("p", [3, 5, 17, 65537, 2**31 - 1, 4294967291])
@pytest.mark.parametrize("name", air.AIRS)
def test_other_primes(name, p):
    field = fp.field_for(p)
    for s in secrets(p):
        check_air(air.AIRS[name], 300, s, field)


@pytest.mark.parametrize("name", air.AIRS)
def test_batch_equals_solo(name):
    a, field = air.AIRS[name], fp.FIELD101
    secs = [_RNG.randrange(field.p) for _ in range(30)] + [field.p - 1, 0]
    for mont in (True, False):
        words, last = witness.traces(a, secs, 1023, field, mont=mont)
        assert words.shape == (32, *columns(a, 1023)) and last.shape == (32,)
        for i, s in enumerate(secs):
            w1, l1 = witness.traces(a, [s], 1023, field, mont=mont)
            np.testing.assert_array_equal(words[i], w1[0])
            assert last[i] == l1[0]


def test_the_refusals():
    with pytest.raises(NotImplementedError, match="no witness recurrence"):
        air.Air().trace(8, 1)
    with pytest.raises(ValueError, match="at least one row"):
        air.FIBONACCI_SQ.trace(0, 1)
    with pytest.raises(ValueError, match="out="):
        witness.traces(air.FIBONACCI_SQ, [1, 2], 8, fp.FIELD101, out=np.empty((2, 7), np.uint32))


def _statement(n: int = 7, secret: int = 31415, **kw) -> StarkConfig:
    last = int(air.FIBONACCI_SQ.trace(n, secret)[-1])
    return StarkConfig(trace_len=n, blowup=4, boundary_last=last, **kw)


def test_wrong_public_output_raises():
    good = _statement()
    wrong = StarkConfig(trace_len=7, blowup=4, boundary_last=(good.boundary_last + 1) % fp.P)
    endpoint = good.boundary_last
    msg = re.escape(f"witness does not satisfy the public boundary: trace endpoint {endpoint} "
                    f"!= {wrong.boundary_last}")
    with pytest.raises(ValueError, match=msg):
        tpr.trace_to_device(wrong, 31415, "cpu")
    cpu = tpr.resolve_device("cpu")
    with pytest.raises(ValueError, match=r"witness 5 \(secret 27182\) fails the public boundary"):
        tbatch._witnesses(good, [31415, 27182], cpu, offset=4)
    # the good statement passes both, with the same words
    solo = tpr.trace_to_device(good, 31415, "cpu")
    both = tbatch._witnesses(good, [31415, 31415], cpu)
    np.testing.assert_array_equal(fp.to_host(solo), both.numpy().view(np.uint32)[1])


def test_rows_counter():
    cfg = _statement()
    tracing.reset()
    witness.traces(air.WINTERFELL_WORK, [3, 4, 5], 100, fp.FIELD101)
    assert tracing.totals()["counters"]["witness.rows"] == 300
    tracing.reset()
    prove(cfg, 31415, device="cpu")
    assert tracing.totals()["counters"]["witness.rows"] == 7
    tracing.reset()
    tbatch.prove_batch(cfg, [31415] * 3, device="cpu")
    assert tracing.totals()["counters"]["witness.rows"] == 21
