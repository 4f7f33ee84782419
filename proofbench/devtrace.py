"""The device trace of a stretch of calls, from torch.profiler.

One call runs under the profiler first and is left out (the tracer's own
start); the stretch that follows is marked by a `record_function` span and
ends with the device synchronised. Its device activity is read only when the
profiler's count of the program's kernels (every name in ``kernels/*.json``)
equals the program's own launch counters over the same calls: a profiler
that dropped spans would read the device as idler than it was. Where the
counts differ, the stretch is halved and run again, down to one call.
"""

from __future__ import annotations

import bisect
import re
import warnings
from dataclasses import dataclass

import torch

MARK = "proofbench.stretch"


def short_name(name: str) -> str:
    """A device span's name without its namespace, return type and
    parameters."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(", 1)[0].strip() or name


@dataclass
class Stretch:
    calls: int
    proofs: int
    window_s: float  # the stretch's length on the profiler's clock
    busy_s: float  # the union of device activity in it
    device: list  # (name, start_us, end_us) of every device span
    kernel_spans: int  # device spans of the program's kernels
    launches: int  # the program's launch counters over the same calls
    gaps: list  # [label, seconds] of the idle time by what the host did

    def layer_s(self, patterns: list) -> float:
        """Device seconds of the spans whose name holds one of `patterns`."""
        return sum(e - s for n, s, e in self.device if any(p in n for p in patterns)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _union(spans: list) -> tuple:
    """(busy µs, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _gaps(merged: list, lo: float, hi: float, host: list) -> list:
    """Idle intervals of [lo, hi], each named by the innermost host event
    running at its middle (the stretch's own span: Python of no torch op)."""
    starts = [h[0] for h in host]
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    out = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        best, top = None, bisect.bisect_right(starts, mid)
        for i in range(top - 1, max(-1, top - 400), -1):
            s, e, name = host[i]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        label = "python, no torch op" if best is None or best[2] == MARK else best[2]
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return [[n, t] for n, t in sorted(out.items(), key=lambda kv: -kv[1])[:10]]


def _profile_once(prog, secrets_of, first_call: int, calls: int, patterns: list) -> Stretch:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog.call(secrets_of(first_call))
        torch.cuda.synchronize()
        before = sum(prog.launch_counts().values())
        proofs = 0
        with record_function(MARK):
            for c in range(first_call + 1, first_call + 1 + calls):
                proofs += len(prog.call(secrets_of(c)))
            torch.cuda.synchronize()
        launches = sum(prog.launch_counts().values()) - before
    events = prof.events()
    # The mark is also kept as an annotation on the device's timeline.
    mark = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
    if len(mark) != 1:
        raise RuntimeError(f"the profiler kept {len(mark)} stretch marks")
    lo, hi = mark[0].time_range.start, mark[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name != MARK and (s + t) / 2 >= lo:  # the calls before the mark were synchronised
                device.append((e.name, s, t))
        elif s <= hi and t >= lo:
            host.append((s, t, e.name))
    host.sort()
    busy, merged = _union([(max(s, lo), min(t, hi)) for _, s, t in device if s < hi and t > lo])
    kernel_spans = sum(1 for n, _, _ in device if any(p in n for p in patterns))
    return Stretch(calls=calls, proofs=proofs, window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                   device=device, kernel_spans=kernel_spans, launches=launches,
                   gaps=_gaps(merged, lo, hi, host))


def profile_stretch(prog, secrets_of, first_call: int, calls: int, patterns: list, log) -> Stretch | None:
    """The first stretch, of `calls` calls halved until the profiler's kernel
    count equals the launch counters, or None."""
    while calls >= 1:
        got = _profile_once(prog, secrets_of, first_call, calls, patterns)
        log(f"profiled stretch: {calls} calls, {got.proofs} proofs, kernel spans "
            f"{got.kernel_spans}, launch counters {got.launches}")
        if got.kernel_spans == got.launches and got.busy_s > 0:
            return got
        first_call += calls + 1
        calls //= 2
    return None
