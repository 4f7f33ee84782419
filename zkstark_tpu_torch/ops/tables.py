"""The device tables the kernels read (twiddles, geometric factors, programs,
constants), each uploaded once and cached, and what a CUDA graph's capture
read of them.

A captured graph reads a table by its address, so the table must outlive the
graph, and it must be on the device before the capture: an upload cannot be
captured. Inside `recording()` every cache here hands its value to the
recording's list as well (the graph keeps the list, and so the tables), and
a lookup that misses raises `ColdTable` before it builds anything, so that
the capture can be abandoned and the call run eagerly, which fills the
cache. Outside a recording a cache is a plain ``functools.lru_cache``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

# `reads`: the list of this thread's recording in progress (a capture records
# one thread's launches), or None.
_state = threading.local()


class ColdTable(LookupError):
    """A cache missed while a capture was recording: its table is not on
    the device yet."""


def read(value):
    """Hand `value`, a cached table just looked up, to the recording in
    progress, if any; returns it."""
    reads = getattr(_state, "reads", None)
    if reads is not None:
        reads.append(value)
    return value


def require_warm(cache: str) -> None:
    """Raise `ColdTable` if a capture is recording: the cache `cache` is
    about to build (a miss)."""
    if getattr(_state, "reads", None) is not None:
        raise ColdTable(f"the cache {cache} missed during a capture")


def device_table(maxsize: int | None):
    """``functools.lru_cache(maxsize)`` of a function that builds a device
    table, which inside `recording()` refuses to build (`ColdTable`) and
    records every value it returns; `cache_info` and `cache_clear` are the
    lru_cache's."""

    def wrap(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            require_warm(fn.__name__)
            return fn(*args, **kwargs)

        memo = functools.lru_cache(maxsize)(build)

        @functools.wraps(fn)
        def lookup(*args, **kwargs):
            return read(memo(*args, **kwargs))

        lookup.cache_info, lookup.cache_clear = memo.cache_info, memo.cache_clear
        return lookup

    return wrap


@contextlib.contextmanager
def recording():
    """Within the block, every cached table this thread looks up is
    appended to the yielded list and a miss raises `ColdTable`."""
    if getattr(_state, "reads", None) is not None:
        raise RuntimeError("a recording of device tables is already open")
    reads = _state.reads = []
    try:
        yield reads
    finally:
        _state.reads = None
