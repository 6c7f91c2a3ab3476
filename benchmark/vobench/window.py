"""The measured window and its end-to-end arithmetic.

Closed loop (one client): the next call starts when the previous one has
returned, and calls start while the window's `seconds` last; the window
ends when the last call begun inside it returns. Open loop: call k is due
at start + k / rate for every k with k / rate < seconds, and is sent when
it is due or, if the previous call is still running, as soon as that call
returns; its latency runs from when it was due to when it returned, so a
stall counts against every call queued behind it.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class Call:
    """One call of the window: clock readings in seconds (`due` is the
    schedule's, None in a closed loop), its output or the error it raised."""

    index: int
    start: float
    end: float
    due: float | None = None
    output: Any = None
    error: str | None = None


@dataclasses.dataclass
class Window:
    calls: list[Call]
    t0: float  # the window's start
    t1: float  # the end of its last call

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _call(fn: Callable[[int], Any], k: int, clock, due: float | None) -> Call:
    start = clock()
    try:
        out, err = fn(k), None
    except Exception:  # a failed call is counted, and the window goes on
        out, err = None, traceback.format_exc()
    return Call(index=k, start=start, end=clock(), due=due, output=out, error=err)


def closed_loop(fn: Callable[[int], Any], seconds: float, clock=time.perf_counter) -> Window:
    t0 = clock()
    calls = []
    while clock() - t0 < seconds:
        calls.append(_call(fn, len(calls), clock, None))
    return Window(calls=calls, t0=t0, t1=calls[-1].end if calls else clock())


def open_loop(fn: Callable[[int], Any], seconds: float, rate_hz: float, clock=time.perf_counter,
              sleep=time.sleep) -> Window:
    t0 = clock()
    calls = []
    n_due = int(np.ceil(seconds * rate_hz - 1e-9))
    for k in range(n_due):
        due = t0 + k / rate_hz
        wait = due - clock()
        if wait > 0:
            sleep(wait)
        calls.append(_call(fn, k, clock, due))
    return Window(calls=calls, t0=t0, t1=calls[-1].end if calls else clock())


def items_per_s(win: Window, items_per_call: int) -> float:
    """Items of every call completed without error, over the window's wall."""
    done = sum(1 for c in win.calls if c.error is None)
    return done * items_per_call / win.seconds


def latencies_ms(win: Window) -> np.ndarray:
    """Each call's time from due to return in ms; a failed call none."""
    return np.array([(c.end - c.due) * 1e3 for c in win.calls if c.error is None], np.float64)


def lateness_ms(win: Window) -> np.ndarray:
    """How late each call was sent after it was due, in ms."""
    return np.array([max(0.0, c.start - c.due) * 1e3 for c in win.calls], np.float64)


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
