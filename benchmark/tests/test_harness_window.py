"""The window's arithmetic on a clock the test drives."""

import numpy as np
import pytest

from vobench import window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_closed_loop_frames_over_the_window():
    clock = FakeClock()
    durations = iter([0.4, 0.5, 0.3, 0.6, 0.2])

    def call(k):
        clock.t += next(durations)
        return k

    win = window.closed_loop(call, 1.0, clock)
    # Calls start at 0, 0.4 and 0.9 (< 1.0); the third ends at 1.2.
    assert [c.index for c in win.calls] == [0, 1, 2]
    assert win.seconds == pytest.approx(1.2)
    assert window.items_per_s(win, 48) == pytest.approx(3 * 48 / 1.2)


def test_closed_loop_failed_call_counts_no_frames():
    clock = FakeClock()

    def call(k):
        clock.t += 0.5
        if k == 1:
            raise RuntimeError("boom")
        return k

    win = window.closed_loop(call, 1.0, clock)
    assert [c.error is None for c in win.calls] == [True, False]
    assert window.items_per_s(win, 10) == pytest.approx(10 / 1.0)


def test_open_loop_latency_from_due_time_and_lateness():
    clock = FakeClock()
    service = iter([0.05, 0.25, 0.05, 0.05])  # the second call stalls the third

    def push(k):
        clock.t += next(service)
        return k

    win = window.open_loop(push, 0.4, 10.0, clock, clock.sleep)  # due at 0, 0.1, 0.2, 0.3
    assert len(win.calls) == 4
    starts = [c.start - win.t0 for c in win.calls]
    assert starts == pytest.approx([0.0, 0.1, 0.35, 0.4])
    lat = window.latencies_ms(win)
    assert lat == pytest.approx([50.0, 250.0, 200.0, 150.0])
    assert window.lateness_ms(win) == pytest.approx([0.0, 0.0, 150.0, 100.0])
    assert window.percentile(lat, 95) == pytest.approx(np.percentile([50, 250, 200, 150], 95))


def test_open_loop_count_is_the_schedule():
    clock = FakeClock()
    win = window.open_loop(lambda k: clock.sleep(0.001), 30.0, 20.0, clock, clock.sleep)
    assert len(win.calls) == 600
