"""The port's one tracer: named spans and counters, always on.

    from zkstark_tpu_torch import tracing

    with tracing.span("merkle"):
        ...
    tracing.count("cache.miss.composition_constants")
    tracing.totals()   # {"spans": {name: {...}}, "counters": {name: n}}
    tracing.reset()

A span adds its wall time (`time.perf_counter_ns`) to its name's slot: the
count, the total and the self time (the total less the time of the spans
opened inside it), and the part of both that fell in the first root span
that held the name, so that a reader of warm means can leave out the
process's cold first call (the kernel library, cold constants, lazy module
loads). A root span is one opened while no span is open; each root takes the
next call id. The tracer never waits for the device: a span around launches
times their enqueue. It allocates no object per span (one `_Span` a name,
reused) and keeps one stack, so spans are opened and closed by one thread.

Inside `annotate()` each span also opens a ``torch.profiler.record_function``
of its name, the root's carrying its call id (``prove#12``), so that under
torch.profiler the spans nest over the kernels on the profiler's clock and
the spans of one call share an identifier. Off by default: an annotation
that encloses launches is also echoed on the profiler's device timeline.

The spans of the prove path, per call unless said (a stark-101 proof):

  prove, prove_batch, prove_pipelined, prove_batch_pipelined   the roots
  witness    the AIR's trace in Montgomery form (one compiled loop,
             ``protocol/witness.py``) and the boundary check
  upload     the witness's copy to the device
  enqueue    the fused core (``protocol/fused.py``), launches only
  lde        the interpolation and the coset LDE inside the core
  merkle     one tree build (12 a proof)
  chain      one Fiat-Shamir chain step in the core (12 a proof)
  fold       one FRI fold, its tree a `merkle` child (10 a proof)
  wait       the wait for the packed result on the host
  replay     the host replay of the transcript, a proof
  decommit   the serialization of the openings, a proof
  library.load, library.build   the kernel library's load and nvcc (once)
  cache.build                   the body of a per-statement cache, on a miss

and the counters ``cache.miss.<cache>`` and ``cache.evict``, and
``graph.eager``, ``graph.capture``, ``graph.replay`` (one of the three a call
of the fused core) and ``graph.evict`` (``protocol/graph.py``), and
``decommit.openings`` and ``decommit.bytes`` (the openings a `decommit`
serialized, a FRI pair one, a trace row one for each shift, and the bytes it
committed; one count of each a call), ``witness.rows`` and ``witness.cells``
(the rows and the words a call of the compiled witness loop wrote:
trace_len × the witnesses, and that times the trace's columns; `Air.trace`
calls count too), and ``merkle.row_leaves`` (the leaves of a trace of
several columns that ``sha256_leaf_rows`` hashed, a call). A replayed core opens no `lde`, `merkle`, `chain` or `fold` span:
they time the enqueue of eager and capturing calls. `prove` also
has `fetch` (the wait and the unpacking), and with `timings` a `sync` span
for each wait for the device it makes; `prove(fused=False)` has the spans
`phase1_lde_commit`, `phase2_composition`, `phase3_fri` and
`phase4_openings`.
"""

from __future__ import annotations

import contextlib
import functools
import time

_now = time.perf_counter_ns

# One stack of open spans, 64 deep (an IndexError past it): each level's
# start, the time of the spans closed inside it, and its profiler range where
# annotated. The state lives in lists, so no span rebinds a global.
_starts = [0] * 64
_children = [0] * 64
_ranges = [None] * 64
_top = [0, 0]  # the open spans' depth; the id of the latest root span
_counters: dict = {}

# A slot: count, total, self, first_total, first_self, the first call's id
# (-1 before it), the latest duration; a span indexes it with literals.
_FIELDS = ("count", "total_ns", "self_ns", "first_total_ns", "first_self_ns")


def _empty_slot() -> list:
    return [0, 0, 0, 0, 0, -1, 0]


class _Span:
    """The context manager of one span name; `span(name)` returns the same
    one at every call."""

    __slots__ = ("name", "slot")

    def __init__(self, name: str):
        self.name = name
        self.slot = _empty_slot()

    def __enter__(self):
        d = _top[0]
        if not d:
            _top[1] += 1
        _children[d] = 0
        _top[0] = d + 1
        _starts[d] = _now()
        return self

    def __exit__(self, typ, val, tb):
        t = _now()
        d = _top[0] - 1
        _top[0] = d
        dt = t - _starts[d]
        own = dt - _children[d]
        if d:
            _children[d - 1] += dt
        s = self.slot
        s[0] += 1
        s[1] += dt
        s[2] += own
        s[6] = dt
        if s[5] != _top[1]:
            if s[5] >= 0:
                return False
            s[5] = _top[1]
        s[3] += dt
        s[4] += own
        return False


_plain = (_Span.__enter__, _Span.__exit__)


def _enter_annotated(self):
    from torch.profiler import record_function

    d = _top[0]
    r = _ranges[d] = record_function(self.name if d else f"{self.name}#{_top[1] + 1}")
    r.__enter__()
    return _plain[0](self)


def _exit_annotated(self, typ, val, tb):
    _plain[1](self, typ, val, tb)
    r, _ranges[_top[0]] = _ranges[_top[0]], None
    if r is not None:
        r.__exit__(None, None, None)
    return False


class _Names(dict):
    def __missing__(self, name: str) -> _Span:
        got = self[name] = _Span(name)
        return got


_spans = _Names()
# span(name): the span `name` as a context manager (``with
# tracing.span("merkle"):``), the same object at every call; a C-level
# lookup, since the prove path opens dozens of spans a proof.
span = _spans.__getitem__


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def on_miss(cache: str):
    """Decorator for the body of a per-statement cache, which runs only on a
    miss: each run counts ``cache.miss.<cache>`` and lies in a `cache.build`
    span."""
    counter = f"cache.miss.{cache}"

    def wrap(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            count(counter)
            with span("cache.build"):
                return fn(*args, **kwargs)

        return build

    return wrap


def last_ns(name: str) -> int:
    """The duration of the latest closed span `name` in ns (0 if none)."""
    got = _spans.get(name)
    return got.slot[6] if got is not None else 0


def totals() -> dict:
    """Every span name that closed since the last `reset`, with its count
    and its total, self, first_total and first_self nanoseconds (first: what
    fell in the first root span that held the name), and every counter."""
    spans = {name: dict(zip(_FIELDS, sp.slot)) for name, sp in _spans.items() if sp.slot[0]}
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Clear every span's slot (its first occurrence too) and every counter;
    spans open now still close into the cleared slots."""
    for sp in _spans.values():
        sp.slot[:] = _empty_slot()
    _counters.clear()


@contextlib.contextmanager
def annotate():
    """Inside this block, each span opens a profiler range of its name too
    (the span's enter and exit swapped for annotating ones)."""
    before = _Span.__enter__, _Span.__exit__
    _Span.__enter__, _Span.__exit__ = _enter_annotated, _exit_annotated
    try:
        yield
    finally:
        _Span.__enter__, _Span.__exit__ = before
