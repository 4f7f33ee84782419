"""The fused core replayed as one CUDA graph.

A warm stark-101 core is 48 launches of about 12 µs of device work each,
and enqueuing them from Python costs about 90 µs each: the host, not the
card, sets a small proof's time. So `CoreGraphs` captures the core once a
key and replays it: one ``cudaGraphLaunch`` in place of the 48 wrapper
calls, with the same hand-written kernels in the same order.

The key is the statement config, the batch B, the device and the NTT route
the environment selects (``ZKSTARK_PEASE``, ``ZKSTARK_MXU``, read at every
call as before). A call of the core is, by what it can observe:

  * eager with a mesh (its collectives are not captured), on the CPU, or
    from `GRAPH_POINTS` points × B up (below);
  * eager the first time its key is seen: that call fills the per-statement
    caches, whose uploads cannot be captured;
  * captured the second time, then replayed for its result;
  * replayed every later time: the uploaded trace is copied into the
    graph's input, the graph replays on the current stream, and the result
    is a copy of the graph's output, so that a result a caller still holds
    is never overwritten by a later call.

Every kernel of the core launches on the current stream, and so do the
input copy, the replay and the result's copy: calls of one key are ordered
by that stream, as the eager core's were, and come from one thread at a
time, as the tracer's spans do. The capture reads the cached
device tables (``ops/tables.py``) by address; the graph holds each table it
read, and a table that is not on the device yet abandons the capture
(`tables.ColdTable`) for an eager call. Each counted event is one
``graph.<event>`` counter of the tracer: ``capture``, ``replay``,
``eager`` (one of the three a call) and ``evict`` (a graph dropped). A
replay adds the launches its capture made to ``ops.launch_counts()``: the
counters count the kernels that run, and the capture itself runs none.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

from zkstark_tpu_torch import ops, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.ops import limb_dft, ntt_kernel, tables

# B × evaluation-domain points from which the core stays eager. A graph keeps
# its own pool of device memory, the core's whole working set (≈ 210 bytes a
# point: 55 MB for 32 stark-101 proofs), for as long as it lives; below 2^20
# points a pool is at most ≈ 0.2 GB. Above, the device work of a call is tens
# of milliseconds or more, and the few milliseconds of enqueue a graph saves
# are under a few per cent of it.
GRAPH_POINTS = 1 << 20
# Graphs kept, least recently used first out; keys seen once, remembered.
MAX_GRAPHS = 4
MAX_SEEN = 64


def graph_key(cfg, traces: torch.Tensor, mesh) -> tuple | None:
    """The key under which a graph may carry this call of the core, or None
    where the call stays eager: with a mesh, off a CUDA device, or from
    `GRAPH_POINTS` points × B up."""
    if mesh is not None or traces.device.type != "cuda":
        return None
    bsz = traces.shape[0]
    if bsz * cfg.eval_domain >= GRAPH_POINTS:
        return None
    return cfg, bsz, traces.device, ntt_kernel.pease_enabled(), limb_dft.mxu_enabled()


@dataclass
class CudaGraph:
    """One captured core: its graph, its static input and output (int32
    views), the launches of one replay by kernel, and the device tables its
    capture read, kept alive with it."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict
    tables: list

    def replay(self, traces: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(fp.as_i32(traces))
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return fp.as_u32(self.static_out.clone())


def capture(core, cfg, traces: torch.Tensor) -> CudaGraph:
    """`core(cfg, x, None)` captured into a CUDA graph, x a static copy of
    `traces`; raises `tables.ColdTable` where a device table it reads is not
    cached. The launch counters come out as they went in."""
    static_in = fp.as_i32(traces).clone()
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    try:
        # a capture needs a stream other than the default one; it enqueues
        # nothing that runs, so that stream needs no order with the current one
        with tables.recording() as read, torch.cuda.stream(torch.cuda.Stream(traces.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = core(cfg, fp.as_u32(static_in), None)
            finally:
                graph.capture_end()
    finally:
        during = {k: n - before[k] for k, n in ops.launch_counts().items() if n != before[k]}
        ops.add_launch_counts({k: -n for k, n in during.items()})
    return CudaGraph(graph, static_in, fp.as_i32(out), during, read)


class CoreGraphs:
    """The policy around one core function `core(cfg, traces, mesh)`: which
    calls run eagerly, which capture and which replay (the module's
    docstring), the graphs least recently used first out past `max_graphs`.
    `capture(core, cfg, traces)` makes a graph, an object with
    `replay(traces)`."""

    def __init__(self, core, capture=capture, max_graphs: int = MAX_GRAPHS):
        self._core, self._capture, self._max_graphs = core, capture, max_graphs
        self._graphs = OrderedDict()
        self._seen = OrderedDict()

    def __call__(self, cfg, traces: torch.Tensor, mesh=None) -> torch.Tensor:
        key = graph_key(cfg, traces, mesh)  # None: eager
        got = self._graphs.get(key)
        if got is not None:
            self._graphs.move_to_end(key)
            tracing.count("graph.replay")
            return got.replay(traces)
        if key in self._seen:
            try:
                got = self._capture(self._core, cfg, traces)
            except tables.ColdTable:
                pass  # a table left its cache since the first call: this call refills it
            else:
                tracing.count("graph.capture")
                self._graphs[key] = got
                while len(self._graphs) > self._max_graphs:
                    self._evict(next(iter(self._graphs)))
                return got.replay(traces)
        elif key is not None:
            self._seen[key] = None
            while len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
        tracing.count("graph.eager")
        return self._core(cfg, traces, mesh)

    def keys(self) -> list:
        """The keys that have a graph, least recently used first."""
        return list(self._graphs)

    def drop(self, cfg) -> None:
        """Drop every graph of the config `cfg`, on every device: its cached
        constants have left their cache, and the graph would keep them."""
        for key in [k for k in self._graphs if k[0] == cfg]:
            self._evict(key)

    def _evict(self, key: tuple) -> None:
        del self._graphs[key]
        tracing.count("graph.evict")
