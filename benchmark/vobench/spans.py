"""Spans taken from the benchmark's own files, in the traced run only.

The program is not edited: the `wrap_*` methods wrap names that the program
looks up when it runs (a module's function, `graphs.run`, and
`torch.cuda.CUDAGraph.replay`) and `uninstall` puts them back. A host span
is synchronised with the device at both ends, so it covers the device work
of its call; a graph replay is timed on the device by CUDA events around
`replay()`, named by the `graphs.run` program it belongs to (or "graph"
for a graph the program replays itself). A wrapped name that the program
no longer has is skipped: its metric then finds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any

import torch


@dataclasses.dataclass
class Span:
    name: str
    t0: float  # host clock, seconds
    t1: float
    parent: int  # index of the enclosing span, -1 at the top
    info: dict


@dataclasses.dataclass
class Replay:
    name: str  # the program's name
    span: int  # index of the host span open when it was launched, -1 if none
    start: Any  # CUDA events
    end: Any


class Tracer:
    def __init__(self, device: torch.device, clock=time.perf_counter):
        self.device = device
        self.clock = clock
        self.spans: list[Span] = []
        self.replays: list[Replay] = []
        self._stack: list[int] = []
        self._programs: list[str] = []
        self._undo: list[tuple[Any, str, Any]] = []
        self.after_call: list = []  # called with the clock's reading as each top-level span (a call) closes

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, **info):
        self._sync()
        idx = len(self.spans)
        self.spans.append(Span(name, self.clock(), 0.0, self._stack[-1] if self._stack else -1, info))
        self._stack.append(idx)
        try:
            yield self.spans[idx]
        finally:
            self._sync()
            self._stack.pop()
            self.spans[idx].t1 = self.clock()
            if not self._stack:
                for fn in self.after_call:
                    fn(self.spans[idx].t1)

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr, None)
        if orig is None:
            return
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def wrap_span(self, owner, attr: str, name: str | None = None, frames_arg: int | None = None) -> None:
        """Time every call of owner.attr as a host span; frames_arg: the
        position of an argument whose length is recorded as `frames`."""
        def make(orig):
            @functools.wraps(orig)
            def wrapped(*args, **kwargs):
                info = {}
                if frames_arg is not None and len(args) > frames_arg:
                    info["frames"] = int(args[frames_arg].shape[0])
                with self.span(name or attr, **info):
                    return orig(*args, **kwargs)
            return wrapped
        self._patch(owner, attr, make)

    def wrap_programs(self, graphs_module) -> None:
        """Name each CUDA graph replay by the graphs.run program around it."""
        def make(orig):
            @functools.wraps(orig)
            def wrapped(name, *args, **kwargs):
                self._programs.append(name)
                try:
                    return orig(name, *args, **kwargs)
                finally:
                    self._programs.pop()
            return wrapped
        self._patch(graphs_module, "run", make)

    def wrap_replays(self) -> None:
        def make(orig):
            @functools.wraps(orig)
            def wrapped(graph, *args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(graph, *args, **kwargs)
                end.record()
                self.replays.append(Replay(self._programs[-1] if self._programs else "graph",
                                           self._stack[-1] if self._stack else -1, start, end))
                return out
            return wrapped
        self._patch(torch.cuda.CUDAGraph, "replay", make)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def replay_intervals_ms(self, ref) -> list[tuple[float, float, str, int]]:
        """(start, end) of every replay in ms after the CUDA event `ref`,
        with its program's name and host span (after a synchronize)."""
        self._sync()
        return [(ref.elapsed_time(r.start), ref.elapsed_time(r.end), r.name, r.span) for r in self.replays]

    def children(self, idx: int) -> list[Span]:
        return [s for s in self.spans if s.parent == idx]

    def named(self, name: str) -> list[tuple[int, Span]]:
        return [(i, s) for i, s in enumerate(self.spans) if s.name == name]
