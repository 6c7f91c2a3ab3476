"""The port's recorder: spans, counts and device intervals of the shipped
path, and torch.profiler capture of a block.

    with profiling.span("loop.verify", device=dev, slots=n) as s:
        ...
        s.set(accepted=k)            # a count, host int or device tensor
        profiling.current().set(...) # the same, from code the span encloses
    records = profiling.snapshot(t0, t1)

A span records its name, `time.perf_counter()` at open and close, the
index (`seq`) of its parent span, the `seq` of its root (one top-level
call, such as one `run_experiment` or one `OnlineVO.push`: the spans of one
sequence share it) and its attributes. Counts are attributes of the span
where the work happened, so they carry its time. A device tensor among
them is summed when read. Names are dotted by layer (`pipeline.*`, `vo.*`,
`checkpoint.*`, `refine.*`, `loop.*`, `pg.*`, `online.*`, `graphs.*`).

Device intervals: a span given a CUDA `device` records a timing event on
the device's current stream at open and at close, never while a stream is
capturing. Events come from a pool and go back to it when their record is
resolved or leaves the ring. They are mapped onto perf_counter through one
anchor per process, taken at the first device span (an event recorded
right after a synchronise, paired with a clock reading), so a device time
reads on the same clock as the host spans.

Inside a captured program, `device_stage(name, ...)` marks a stage with a
pair of timing events recorded in the capture (`external=True`): every
replay of the graph times its own stages. `utils/graphs` hands a replay's
stages to `replayed`; `resolve()` turns them into records (children of
the replay's span) once the host has waited for that replay anyway, by an
event query that never blocks. A replay whose stage events the next
replay of the same graph overwrites first is counted on its span as
`stages_unresolved`.

Reading: `snapshot(t0, t1)` synchronises once, resolves every device time
and count, and returns copies of the closed records whose root opened in
[t0, t1]. Nothing on the recording path synchronises or reads the device.

The ring holds RING records and overwrites the oldest (an untraced 30 s
window of the offline benchmark cell writes about 5,500; a traced one,
slower, 1,300). DVO_TRACE=0 in the environment, read at
import, makes `span` and `device_stage` shared no-ops: nothing is recorded
and no event is made.

Besides: `trace(log_dir)`, which records a block with torch.profiler and
writes its Chrome trace with the recorder's spans of the block laid on
the profiler's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import threading
import time
from typing import Any, Callable, Iterator

import torch

TRACE_FILE = "torch_trace.json"
ENABLED = os.environ.get("DVO_TRACE", "1") != "0"
RING = 8192  # records kept
_ANCHOR_NAME = "dvo.recorder_anchor"  # the profiler range that puts the recorder on the trace's clock


@dataclasses.dataclass
class Record:
    """One span. t1 is NaN while it is open; dev_t0/dev_t1 are its device
    interval on perf_counter once resolved (None without one)."""

    seq: int
    name: str
    t0: float
    t1: float
    parent: int  # seq of the enclosing span, -1 at the top
    root: int  # seq of the top-level span (itself at the top)
    root_t0: float
    attrs: dict
    dev_t0: float | None = None
    dev_t1: float | None = None
    events: tuple | None = None  # (start, end) CUDA events until resolved

    def set(self, **attrs) -> None:
        """Add counts or attributes to the span (host values or device tensors)."""
        self.attrs.update(attrs)


class _Noop:
    """The shared span, record and stage of a disabled recorder."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return fn

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Span:
    """A span to open: a context manager, or a decorator that opens one per call."""

    __slots__ = ("rec", "name", "device", "attrs", "record")

    def __init__(self, rec: "Recorder", name: str, device, attrs: dict):
        self.rec, self.name, self.device, self.attrs = rec, name, device, attrs

    def __enter__(self) -> Record:
        self.record = self.rec.open(self.name, self.attrs, self.device)
        return self.record

    def __exit__(self, *exc) -> bool:
        self.rec.close(self.record)
        return False

    def __call__(self, fn: Callable) -> Callable:
        rec, name, device, attrs = self.rec, self.name, self.device, self.attrs

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Span(rec, name, device, dict(attrs)):
                return fn(*args, **kwargs)
        return wrapped


@dataclasses.dataclass
class _Stage:
    """A stage marked inside a capture: its events are re-recorded by every replay."""

    name: str
    attrs: dict
    start: Any
    end: Any


def _cuda(device) -> torch.device | None:
    """The CUDA device a span times, or None (no device, not a CUDA one, or
    no CUDA runtime)."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device()) if device.index is None else device


class Recorder:
    """Spans in a bounded ring (see the module docstring). One per process
    serves the program (`RECORDER`); tests make their own."""

    def __init__(self, capacity: int = RING, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._ring: list[Record | None] = [None] * capacity
        self._seq = itertools.count()
        self._local = threading.local()
        self._pool: list = []
        self._anchor: tuple | None = None  # (event, perf_counter reading)
        self._pending: dict[int, tuple[Record, list[_Stage]]] = {}  # id(stages) -> the replay waiting for them
        self._capture: list[list[_Stage]] = []  # the stage lists of the captures under way

    # -- recording ------------------------------------------------------------
    def span(self, name: str, device=None, **attrs):
        return _Span(self, name, device, attrs) if self.enabled else NOOP

    def _stack(self) -> list[Record]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Record | _Noop:
        """The innermost span open on this thread (NOOP when there is none)."""
        st = self._stack() if self.enabled else None
        return st[-1] if st else NOOP

    def _events(self, device: torch.device):
        """Two timing events from the pool, the first recorded now on the
        device's current stream; None while it is capturing."""
        if torch.cuda.is_current_stream_capturing():
            return None
        if self._anchor is None:
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self._anchor = (ev, time.perf_counter())
        pair = self._pool.pop() if self._pool else (torch.cuda.Event(enable_timing=True),
                                                     torch.cuda.Event(enable_timing=True))
        pair[0].record(torch.cuda.current_stream(device))
        return pair

    def _store(self, rec: Record) -> None:
        slot = rec.seq % self.capacity
        old = self._ring[slot]
        if old is not None and old.events is not None:
            self._pool.append(old.events)
        self._ring[slot] = rec

    def open(self, name: str, attrs: dict, device=None) -> Record:
        st = self._stack()
        seq = next(self._seq)
        parent = st[-1] if st else None
        dev = _cuda(device)
        events = self._events(dev) if dev is not None else None
        t0 = time.perf_counter()
        rec = Record(seq, name, t0, math.nan, parent.seq if parent else -1, parent.root if parent else seq,
                     parent.root_t0 if parent else t0, attrs, events=events)
        self._store(rec)
        st.append(rec)
        return rec

    def close(self, rec: Record) -> None:
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(rec.events[0].device))
        rec.t1 = time.perf_counter()
        st = self._stack()
        if st and st[-1] is rec:
            st.pop()

    # -- stages inside captured programs ----------------------------------------
    @contextlib.contextmanager
    def collect_stages(self) -> Iterator[list[_Stage]]:
        """Gather the stages that `device_stage` marks during a capture."""
        stages: list[_Stage] = []
        self._capture.append(stages)
        try:
            yield stages
        finally:
            self._capture.remove(stages)

    @contextlib.contextmanager
    def device_stage(self, name: str, **attrs) -> Iterator[None]:
        """Mark a stage of a program being captured (a no-op otherwise)."""
        if not (self.enabled and self._capture and torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            yield
            return
        start = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        yield
        end.record()
        self._capture[-1].append(_Stage(name, attrs, start, end))

    def replayed(self, replay: Record | _Noop, stages: list[_Stage]) -> None:
        """A replay of a graph with these stages was launched inside span
        `replay`: settle the previous replay of the same graph first."""
        if not self.enabled or not stages:
            return
        key = id(stages)
        if key in self._pending and not self._resolve_one(key):
            prev, _ = self._pending.pop(key)
            prev.attrs["stages_unresolved"] = prev.attrs.get("stages_unresolved", 0) + 1
        self._pending[key] = (replay, stages)

    def _resolve_one(self, key: int) -> bool:
        replay, stages = self._pending[key]
        if not all(s.start.query() and s.end.query() for s in stages):
            return False
        del self._pending[key]
        for s in stages:
            # A stage has no host time of its own: it opens and closes as its replay closes.
            rec = Record(next(self._seq), s.name, replay.t1, replay.t1, replay.seq, replay.root, replay.root_t0,
                         dict(s.attrs))
            rec.dev_t0, rec.dev_t1 = self._on_clock(s.start), self._on_clock(s.end)
            self._store(rec)
        return True

    def resolve(self) -> None:
        """Turn the stages of every replay that has finished into records;
        a replay still running stays pending. Never waits."""
        for key in list(self._pending):
            self._resolve_one(key)

    # -- reading --------------------------------------------------------------
    def _on_clock(self, ev) -> float:
        anchor, t = self._anchor
        return t + anchor.elapsed_time(ev) / 1e3

    def snapshot(self, t0: float | None = None, t1: float | None = None) -> list[Record]:
        """Copies of the closed records whose root opened in [t0, t1], in
        the order they opened, with device times and counts resolved
        (synchronises once)."""
        if self._anchor is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.resolve()
        lo = -math.inf if t0 is None else t0
        hi = math.inf if t1 is None else t1
        out = []
        for rec in sorted((r for r in self._ring if r is not None), key=lambda r: r.seq):
            if math.isnan(rec.t1) or not lo <= rec.root_t0 <= hi:
                continue
            if rec.events is not None:
                rec.dev_t0, rec.dev_t1 = self._on_clock(rec.events[0]), self._on_clock(rec.events[1])
                self._pool.append(rec.events)
                rec.events = None
            for k, v in rec.attrs.items():
                if isinstance(v, torch.Tensor):
                    v = v.sum().item()
                    rec.attrs[k] = int(v) if float(v).is_integer() else float(v)
            out.append(dataclasses.replace(rec, attrs=dict(rec.attrs)))
        return out


RECORDER = Recorder(enabled=ENABLED)


def span(name: str, device=None, **attrs):
    """A span of the program's recorder: `with span(...) as rec:` or
    `@span(...)`. `device`: a CUDA device gives the span a device interval."""
    return RECORDER.span(name, device, **attrs)


def current() -> Record | _Noop:
    """The innermost open span of the program's recorder on this thread:
    `current().set(...)` adds counts to the span a caller opened."""
    return RECORDER.current()


def device_stage(name: str, **attrs):
    """A stage of a program under capture, timed by every replay."""
    return RECORDER.device_stage(name, **attrs)


def snapshot(t0: float | None = None, t1: float | None = None) -> list[Record]:
    return RECORDER.snapshot(t0, t1)


def _synchronize_all_devices() -> None:
    # CPU ops run synchronously; each card's queue is drained.
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _chrome_events(records: list[Record], to_us: Callable[[float], float]) -> list[dict]:
    """The records as Chrome trace complete events: host spans on one row,
    device intervals on another."""
    out = []
    for r in records:
        args = {"seq": r.seq, "parent": r.parent, "root": r.root, **r.attrs}
        if r.t1 > r.t0 or r.dev_t0 is None:
            out.append({"ph": "X", "cat": "recorder", "name": r.name, "pid": "recorder", "tid": "host spans",
                        "ts": to_us(r.t0), "dur": (r.t1 - r.t0) * 1e6, "args": args})
        if r.dev_t0 is not None:
            out.append({"ph": "X", "cat": "recorder", "name": r.name, "pid": "recorder", "tid": "device spans",
                        "ts": to_us(r.dev_t0), "dur": (r.dev_t1 - r.dev_t0) * 1e6, "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the block with torch.profiler and write its Chrome trace
    (chrome://tracing, Perfetto) to log_dir/TRACE_FILE: the profiler's host
    ops and the card's kernels, and the recorder's spans of the block
    (host spans, and the device intervals of device spans and of the VO
    replay's stages) on the same clock. An empty profiler range as the
    block starts, its end paired with a perf_counter reading, is the
    anchor."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(_ANCHOR_NAME):
            pass
        host_ref = time.perf_counter()  # the range's end: its start carries the profiler's first-call cost
        yield
        _synchronize_all_devices()
    prof.export_chrome_trace(path)
    records = snapshot(host_ref)
    if not records:
        return
    with open(path) as f:
        doc = json.load(f)
    anchor = [e for e in doc["traceEvents"] if e.get("name") == _ANCHOR_NAME and e.get("ph") == "X"]
    if not anchor:
        return
    ts0 = float(anchor[0]["ts"]) + float(anchor[0]["dur"])
    doc["traceEvents"] += _chrome_events(records, lambda t: ts0 + (t - host_ref) * 1e6)
    with open(path, "w") as f:
        json.dump(doc, f)
