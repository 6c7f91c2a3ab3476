"""The traced window's device timeline.

torch.profiler (CUDA activity only) records the kernels, copies and fills
launched one by one; it records a CUDA graph's replay incompletely, so
each replay's span comes from the CUDA events around it (spans.Tracer).
Both go onto the profiler's clock: right after the window's reference
event, a short spin kernel is the first kernel of the trace, so an event
time t ms after the reference lies at the spin's start + t ms. Busy time
is the union of every interval; an idle gap is named by the innermost
host span open at its middle.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

SPIN_CYCLES = 20_000  # the alignment kernel: about 10 us


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    device_ops: list[list]  # [name, seconds], most time first
    idle_gaps: list[list]  # [what the host was doing, seconds], longest first


class DeviceTrace:
    """`start()` before the window, `stop()` after it. Without the profiler
    (a cell whose every device operation is a graph replay, which CUPTI's
    tracing slows) only the reference event is kept, and the timeline is
    the replays' alone. With `seconds`, the profiler records the window's
    first calls only: `after_call` stops it between calls once that much of
    the window has passed (CUPTI records every kernel of every replayed
    graph, and a pose graph's GN steps are some 3,000 kernels a replay)."""

    def __init__(self, device: torch.device, profiler: bool = True, seconds: float | None = None):
        self.device = device
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if profiler else None
        self.seconds = seconds
        self.ref = None
        self.host_ref = 0.0
        self.host_end: float | None = None  # when the profiled part of the window ended
        self._kernels: list | None = None

    def after_call(self, now: float) -> None:
        if self.seconds is not None and self._kernels is None and now - self.host_ref >= self.seconds:
            self.host_end = now
            self.stop()

    def start(self, clock) -> None:
        if self.prof is not None:
            self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.host_ref = clock()
        if self.prof is not None:
            torch.cuda._sleep(SPIN_CYCLES)

    def stop(self) -> list[tuple[float, float, str]]:
        """The recorded device intervals as (start ns, end ns, name), the
        alignment spin first; none without the profiler."""
        if self._kernels is not None:
            return self._kernels
        torch.cuda.synchronize(self.device)
        if self.prof is None:
            self._kernels = []
            return self._kernels
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        out = [(float(e.start_ns()), float(e.start_ns() + e.duration_ns()), e.name())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda and e.duration_ns() > 0]
        out.sort()
        self._kernels = out
        return out


def union_length(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Total length of a union of intervals, and the union as disjoint intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def timeline(kernels: list[tuple[float, float, str]], replays_ms: list[tuple[float, float, str, int]],
             window: tuple[float, float], spans: list, host_ref: float, top: int = 10) -> Timeline:
    """kernels: the trace's (start ns, end ns, name), its first the
    alignment spin, or none; replays_ms: (start ms, end ms, program, span)
    after the reference event; window: the host clock's (start, end) in
    seconds; spans: the tracer's host spans (host clock)."""
    # The reference event on the trace's clock: the spin's start, or 0 on the events' own.
    origin = kernels[0][0] if kernels else 0.0
    to_ns = lambda host_s: origin + (host_s - host_ref) * 1e9
    w0, w1 = to_ns(window[0]), to_ns(window[1])
    clip = lambda a, b: (max(a, w0), min(b, w1))
    reps = [(origin + a * 1e6, origin + b * 1e6, name) for a, b, name, _ in replays_ms]
    ivs = [clip(a, b) for a, b, _ in kernels[1:]] + [clip(a, b) for a, b, _ in reps]
    busy_ns, merged = union_length([iv for iv in ivs if iv[1] > iv[0]])

    # Device operations: a replay by its program, a kernel outside every replay by its name.
    ops: dict[str, float] = collections.defaultdict(float)
    rep_sorted = sorted((a, b) for a, b, _ in reps)
    starts = np.array([a for a, _ in rep_sorted]) if rep_sorted else np.zeros(0)
    for a, b, name in reps:
        ops[f"graph:{name}"] += (b - a) / 1e9
    for a, b, name in kernels[1:]:
        i = int(np.searchsorted(starts, a, side="right")) - 1
        if i >= 0 and a < rep_sorted[i][1]:
            continue
        ops[name[:120]] += (b - a) / 1e9
    device_ops = sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top]

    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:top]:
        mid = host_ref + ((a + b) / 2 - origin) / 1e9
        open_spans = [s for s in spans if s.t0 <= mid <= s.t1]
        what = min(open_spans, key=lambda s: s.t1 - s.t0).name if open_spans else "between calls"
        idle.append([what, (b - a) / 1e9])
    return Timeline(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, device_ops=device_ops, idle_gaps=idle)
