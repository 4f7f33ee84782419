"""The statements a cell proves, made from `--seed`: the benchmark's own copy
of each AIR, so that no change to the program can move what is proved.

A statement file (``configs/<name>.json``) fixes the AIR, the trace length,
the blowup, the coset offset, the query count and the field. Its `air` names
a file of the benchmark, ``airs/<air>.py`` (`-` read as `_`), which defines

* ``WIDTH``, optional: the trace's columns, w (1 where it is absent);
* ``trace(trace_len, secret, p)``: the witness rows (uint32 residues), of
  shape ``(trace_len,)`` where w = 1 and ``(trace_len, w)`` otherwise;
* ``witnesses(seed, cfg)``: the short cycle of (secret, publics) pairs a run
  proves in turn, publics being ``{"boundary_first", "boundary_last"}``;
* ``constraints(st, publics)``: the reference's ([(kind, data)], shifts),
  in alpha order: ("boundary", (step, value)) on column 0, or ("boundary",
  (step, value, column)); or ("transition", (numerator, exempt steps)), the
  numerator taking the field and {shift k: f(g^k·x)}, where f[k] is a
  ``(d,)`` tensor for w = 1 and a ``(w, d)`` one otherwise (f[k][j]: column
  j at shift k);
* ``fri_rounds(trace_domain)``: the folds down to degree 0.

Adding a statement is adding files: the harness names no AIR.
"""

from __future__ import annotations

import importlib.util
import json
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
AIRS = ROOT / "airs"


def load_air(name: str):
    """The module of ``AIRS/<name>.py``, `-` read as `_`."""
    path = AIRS / f"{name.replace('-', '_')}.py"
    if not path.is_file():
        raise ValueError(f"no AIR {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"proofbench_air_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace(air: str, trace_len: int, secret: int, p: int) -> np.ndarray:
    """The witness rows of `air` (uint32 residues)."""
    return load_air(air).trace(trace_len, secret, p)


class Witness(int):
    """A secret with the public values its proof states: the pair (secret,
    publics) as one int, so that it goes wherever a secret goes."""

    def __new__(cls, secret: int, publics: dict):
        w = super().__new__(cls, secret)
        w.publics = dict(publics)
        return w

    @property
    def key(self) -> tuple:
        """(secret, publics) as a key: two witnesses of one secret and other
        public values are two proofs."""
        return int(self), publics_key(self.publics)


def publics_key(publics: dict) -> tuple:
    return tuple(sorted(publics.items()))


@dataclass(frozen=True)
class Statement:
    """One statement: the file's fields, the public values and the secret of
    the first witness, and the cycle of witnesses the seed gives."""

    name: str
    air: str
    trace_len: int
    blowup: int
    coset_offset: int
    n_queries: int
    p: int
    generator: int
    boundary_first: int
    boundary_last: int
    secret: int
    cycle: tuple = ()

    @property
    def trace_domain(self) -> int:
        return self.trace_len + 1

    @property
    def eval_domain(self) -> int:
        return self.trace_domain * self.blowup

    @property
    def width(self) -> int:
        """The trace's columns: the AIR's ``WIDTH``, 1 where it has none."""
        return int(getattr(load_air(self.air), "WIDTH", 1))

    @property
    def fri_rounds(self) -> int:
        return load_air(self.air).fri_rounds(self.trace_domain)

    def witness(self, k: int) -> Witness:
        """The witness of a run's proof k: the k-th of the cycle, cyclically."""
        return self.cycle[k % len(self.cycle)]

    def publics(self, witness: int) -> dict:
        """The public values a proof of `witness` states: a `Witness`'s own,
        the statement's for a bare secret."""
        return getattr(witness, "publics", None) or {
            "boundary_first": self.boundary_first, "boundary_last": self.boundary_last}


def load_config(name: str) -> dict:
    """A statement file by its name in BENCHMARK.json."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def draw_secret(seed: int, p: int) -> int:
    """s, uniform in [1, p − 1], from any whole seed."""
    return random.Random(int(seed)).randrange(1, p)


def make(name: str, cfg: dict, seed: int) -> Statement:
    """The statement of `cfg` (a statement file's dict) for `seed`."""
    cycle = tuple(Witness(s, pub) for s, pub in load_air(cfg["air"]).witnesses(seed, cfg))
    first = cycle[0]
    return Statement(
        name=name, air=cfg["air"], trace_len=int(cfg["trace_len"]),
        blowup=int(cfg["blowup"]), coset_offset=int(cfg["coset_offset"]),
        n_queries=int(cfg["n_queries"]), p=int(cfg["field_p"]),
        generator=int(cfg["field_generator"]),
        boundary_first=first.publics["boundary_first"],
        boundary_last=first.publics["boundary_last"], secret=int(first), cycle=cycle,
    )
