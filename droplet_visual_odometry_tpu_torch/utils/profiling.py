"""Per-stage timing and torch.profiler capture — port of
droplet_visual_odometry_tpu/utils/profiling.py.

A stage timer registry synchronised with the devices (so that a wall time
under asynchronous launches means what it says), the frames/s helper of the
north-star metric, and `trace(log_dir)`, which records the block with
torch.profiler (the host, and the card's kernels where there is a card) and
writes a Chrome trace into log_dir.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

TRACE_FILE = "torch_trace.json"


class StageTimes:
    """Accumulates wall-clock per named stage. Not thread-safe by design:
    one registry per pipeline run."""

    def __init__(self) -> None:
        self.total_s: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True) -> Iterator[None]:
        """Time a block. With sync=True (default) outstanding device work is
        drained first and after, so the block's time is attributable to it."""
        if sync:
            _synchronize_all_devices()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _synchronize_all_devices()
            self.total_s[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {"total_s": self.total_s[name], "calls": self.calls[name]}
            for name in sorted(self.total_s)
        }

    def pretty(self) -> str:
        rows = [
            f"  {name:<28s} {v['total_s']*1e3:10.2f} ms  /{v['calls']} calls"
            for name, v in self.report().items()
        ]
        return "stage timings:\n" + "\n".join(rows) if rows else "stage timings: (none)"


def _synchronize_all_devices() -> None:
    # CPU ops run synchronously; each card's queue is drained.
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


TIMES = StageTimes()
stage = TIMES.stage


def frames_per_second(n_frames: int, seconds: float) -> float:
    """The north-star throughput metric: frames/s."""
    return n_frames / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the block with torch.profiler and write its Chrome trace
    (chrome://tracing, Perfetto) to log_dir/TRACE_FILE."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        _synchronize_all_devices()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def timed(fn, *args, sync: bool = True, **kwargs):
    """Run fn(*args, **kwargs), return (result, seconds) with device sync."""
    if sync:
        _synchronize_all_devices()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        _synchronize_all_devices()
    return out, time.perf_counter() - t0
