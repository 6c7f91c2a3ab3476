"""The program's own spans: the records that the port's recorder
(droplet_visual_odometry_tpu_torch.utils.profiling) kept of a run's
window, read once per run and shared by the readers.

`snapshot(window.t0, window.t1)` returns the closed spans whose root (one
`run_experiment`, one push) began inside the window, with device times and
counts resolved, so no set-up record counts. A program without the
recorder gives None, and every reader then finds nothing to read.
"""

from __future__ import annotations

import collections

import numpy as np

SEQUENCE = "pipeline.run_experiment"  # the root span of one sequence


def records(run) -> list | None:
    if "program_spans" not in run.cache:
        from droplet_visual_odometry_tpu_torch.utils import profiling

        snapshot = getattr(profiling, "snapshot", None)
        run.cache["program_spans"] = None if snapshot is None else snapshot(run.window.t0, run.window.t1)
    return run.cache["program_spans"]


def sequences(run) -> list[list]:
    """The window's records grouped by sequence (one list per
    run_experiment root), in the order they ran."""
    recs = records(run)
    if not recs:
        return []
    groups = collections.defaultdict(list)
    for r in recs:
        groups[r.root].append(r)
    return [g for g in groups.values() if any(r.name == SEQUENCE and r.seq == r.root for r in g)]


def median_per_sequence(run, value) -> float | None:
    """The median over the window's sequences of value(records of one
    sequence), skipping sequences where it is None."""
    vals = [v for v in (value(g) for g in sequences(run)) if v is not None]
    return float(np.median(vals)) if vals else None


def host_ms(group: list, names) -> float | None:
    """Summed host walls of the named spans, in ms (None if there are none)."""
    spans = [r for r in group if r.name in names]
    return sum(r.t1 - r.t0 for r in spans) * 1e3 if spans else None


def device_ms(group: list, names) -> float | None:
    """Summed device intervals of the named spans, in ms (None if none has one)."""
    spans = [r for r in group if r.name in names and r.dev_t0 is not None]
    return sum(r.dev_t1 - r.dev_t0 for r in spans) * 1e3 if spans else None


def stage_ms_per_frame(run, name: str) -> float | None:
    """An in-graph stage's device time over the frames of its replays, in
    ms a frame, over the whole window."""
    stages = [r for r in records(run) or () if r.name == name and r.dev_t0 is not None]
    frames = sum(r.attrs.get("frames", 0) for r in stages)
    return sum(r.dev_t1 - r.dev_t0 for r in stages) * 1e3 / frames if frames else None
